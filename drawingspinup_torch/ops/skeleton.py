"""2-D morphological skeleton utilities on the host (numpy, scipy): the
thinning path's Zhang–Suen skeleton, endpoints, disc stamping, L2 distance
transform, dilation and short-line removal, and color back-projection's
elliptical erosion and bilinear lookup.

A copy of ``drawingspinup_tpu/ops/skeleton.py``;
``tests/test_torch_mesh_post.py`` and ``tests/test_torch_recon.py`` pin it
to the original."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy import ndimage


def distance_transform_l2(mask: np.ndarray) -> np.ndarray:
    """Exact euclidean distance of foreground pixels to the background."""
    return ndimage.distance_transform_edt(np.asarray(mask) > 0).astype(np.float32)


def skeletonize(mask: np.ndarray, max_iter: int = 10000) -> np.ndarray:
    """Zhang–Suen thinning → 1-px skeleton (uint8 0/255)."""
    img = (np.asarray(mask) > 0).astype(np.uint8)
    img = np.pad(img, 1)

    def neighbours(p):
        # clockwise from north: P2..P9
        return [p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:],
                p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2], p[:-2, :-2]]

    for _ in range(max_iter):
        changed = False
        for phase in (0, 1):
            n = neighbours(img)
            p = img[1:-1, 1:-1]
            b = sum(n)
            seq = n + [n[0]]
            a = sum(((seq[i] == 0) & (seq[i + 1] == 1)).astype(np.uint8)
                    for i in range(8))
            if phase == 0:
                c1 = n[0] * n[2] * n[4]
                c2 = n[2] * n[4] * n[6]
            else:
                c1 = n[0] * n[2] * n[6]
                c2 = n[0] * n[4] * n[6]
            cond = (p == 1) & (b >= 2) & (b <= 6) & (a == 1) \
                & (c1 == 0) & (c2 == 0)
            if cond.any():
                img[1:-1, 1:-1] = np.where(cond, 0, p)
                changed = True
        if not changed:
            break
    return (img[1:-1, 1:-1] * 255).astype(np.uint8)


def end_points(skeleton: np.ndarray) -> List[Tuple[int, int]]:
    """Skeleton endpoints as (col, row): foreground pixels with exactly one
    foreground neighbor (reference get_end_points, thinning_utils.py:11-26)."""
    sk = (np.asarray(skeleton) > 0).astype(np.int32)
    k = np.ones((3, 3), np.int32)
    cnt = ndimage.convolve(sk, k, mode="constant")
    ep = (sk > 0) & (cnt == 2)  # self + 1 neighbor
    rows, cols = np.nonzero(ep)
    return [(int(c), int(r)) for r, c in zip(rows, cols)]


def stamp_discs(mask: np.ndarray, centers: List[Tuple[int, int]],
                radius: int, value: int = 0) -> np.ndarray:
    """Paint filled discs (cv2.circle equivalent) at (col, row) centers."""
    out = np.asarray(mask).copy()
    h, w = out.shape
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = (yy ** 2 + xx ** 2) <= radius ** 2
    for (c, r) in centers:
        y0, y1 = max(r - radius, 0), min(r + radius + 1, h)
        x0, x1 = max(c - radius, 0), min(c + radius + 1, w)
        d = disc[y0 - (r - radius): disc.shape[0] - ((r + radius + 1) - y1),
                 x0 - (c - radius): disc.shape[1] - ((c + radius + 1) - x1)]
        region = out[y0:y1, x0:x1]
        region[d] = value
    return out


def remove_intersections(thin_mask: np.ndarray, skeleton: np.ndarray,
                         radius: int, value: int = 0) -> np.ndarray:
    """Endpoints of thin_mask that are NOT endpoints of the full skeleton are
    cut points at intersections — erase discs around them (reference
    remove_intersection, thinning_utils.py:28-34)."""
    ep_thin = end_points(thin_mask)
    ep_full = set(end_points(skeleton))
    centers = [p for p in ep_thin if p not in ep_full]
    return stamp_discs(thin_mask, centers, radius, value)


def dilate(mask: np.ndarray, radius: int = 1) -> np.ndarray:
    return (ndimage.binary_dilation(np.asarray(mask) > 0,
                                    iterations=radius) * 255).astype(np.uint8)


def erode(mask: np.ndarray, size: int = 19) -> np.ndarray:
    """Elliptical erosion (cv2 MORPH_ELLIPSE equivalent)."""
    r = size // 2
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    se = (yy ** 2 + xx ** 2) <= r ** 2
    return (ndimage.binary_erosion(np.asarray(mask) > 0, structure=se)
            * 255).astype(np.uint8)


def bilinear_sample(image: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Bilinear lookup at float pixel coords (N,2) → (N,) or (N,C)."""
    h, w = image.shape[:2]
    x = np.clip(xy[:, 0], 0, w - 2)
    y = np.clip(xy[:, 1], 0, h - 2)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = (x - x0)
    fy = (y - y0)
    if image.ndim == 3:
        fx, fy = fx[:, None], fy[:, None]
    v00 = image[y0, x0]
    v01 = image[y0, x0 + 1]
    v10 = image[y0 + 1, x0]
    v11 = image[y0 + 1, x0 + 1]
    return ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v01
            + (1 - fx) * fy * v10 + fx * fy * v11)


def remove_short_lines(mask: np.ndarray, min_length: int) -> np.ndarray:
    """Drop connected components smaller than min_length pixels (reference
    remove_short_lines, thinning_utils.py:37-44)."""
    m = np.asarray(mask) > 0
    lab, n = ndimage.label(m)
    out = np.zeros_like(m)
    for i in range(1, n + 1):
        comp = lab == i
        if comp.sum() >= min_length:
            out |= comp
    return (out * 255).astype(np.uint8)

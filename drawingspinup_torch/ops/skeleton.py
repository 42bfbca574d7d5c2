"""The two mask helpers of ``drawingspinup_tpu/ops/skeleton.py`` that color
back-projection uses (elliptical erosion, bilinear lookup), copied;
``tests/test_torch_recon.py`` pins them. The thinning utilities are not
ported yet (``ROADMAP.md``)."""
from __future__ import annotations

import numpy as np
from scipy import ndimage


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

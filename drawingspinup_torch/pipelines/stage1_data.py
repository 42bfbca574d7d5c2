"""Stage-1 training data: contour-pair synthesis + BiCar dataset.

A copy of ``drawingspinup_tpu/pipelines/stage1_data.py`` (numpy, scipy and
PIL only), so that the port trains without the JAX package;
``tests/test_torch_lama.py`` pins it batch for batch, bit-equal, from one
seed.

Parity with the reference training path
(``saicinpainting/training/data/{datasets,aug}.py``):
  * per 3DBiCar uid: a rendered RGBA + 6 contour variants; uids[0:1200]
    train / rest val (datasets.py:11-41).
  * pair synthesis (aug.py:29-57): random color offset on the body, white
    background, contour recolored randomly, soft contour alpha (global
    and/or per-pixel), composited over the body; gt = binary contour mask.
  * transforms (aug.py:60-106): resize 572 → random 512 crop → random flip.

The reference renders contours as Freestyle SVGs via Blender + cairosvg
(both absent here); our renderer (render/bicar.py) emits contour PNGs, and
synthesis recolors those — same training signal, no SVG toolchain.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
from scipy import ndimage

from drawingspinup_torch.core.io import read_image

TRAIN_SPLIT = 1200
N_CONTOUR_VARIANTS = 6


def contour_band(mask: np.ndarray, thickness: int) -> np.ndarray:
    """External-contour band of a binary mask (hard, uniform width):
    pixels of the mask within ``thickness`` of the outside."""
    m = mask > 0.5
    er = ndimage.binary_erosion(m, iterations=max(int(thickness), 1))
    return (m & ~er).astype(np.float32)


def _smooth_noise(shape, rng: np.random.Generator, cells: int = 12
                  ) -> np.ndarray:
    """Low-frequency noise in [0,1]: coarse random grid, bicubic upsample."""
    from PIL import Image
    g = rng.random((cells, cells)).astype(np.float32)
    img = Image.fromarray((g * 255).astype(np.uint8))
    up = img.resize((shape[1], shape[0]), Image.BICUBIC)
    return np.asarray(up, np.float32) / 255.0


def freestyle_contour(mask: np.ndarray, thickness: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Freestyle-like external contour (reference
    bicar_render_codes/blenderProc_ortho.py:166-185: thickness_position
    INSIDE, ROUND caps, SKETCHY chaining): a soft-alpha stroke inside the
    silhouette whose width wobbles along the boundary and which may carry
    sketchy gaps.

      * width wobble — the per-pixel width target is thickness scaled by a
        low-frequency noise field (±35%), standing in for SKETCHY chaining's
        stroke-width variation;
      * soft alpha — the inner stroke edge feathers over ~1.5 px (SVG
        rasterization antialiasing); the outer edge is the silhouette;
      * partial strokes — with probability 0.5 the stroke is multiplied by
        a thresholded noise field, opening gaps over ~10-25% of its length
        (SKETCHY chaining drops segments).

    Returns a float32 alpha map in [0, 1]; callers threshold > 0 for the gt
    mask exactly as aug.py's CM_np > 0 does with the rasterized SVG."""
    m = mask > 0.5
    # distance (px) from the outside region — stroke depth coordinate
    dt = ndimage.distance_transform_edt(m).astype(np.float32)
    wobble = 1.0 + 0.7 * (_smooth_noise(mask.shape, rng) - 0.5)
    width = np.maximum(thickness * wobble, 1.0)
    alpha = np.clip((width - dt) / 1.5 + 1.0, 0.0, 1.0) * m
    if rng.random() > 0.5:
        gaps = _smooth_noise(mask.shape, rng, cells=16)
        thresh = rng.uniform(0.1, 0.25)
        alpha = alpha * (gaps > thresh)
    return alpha.astype(np.float32)


def synth_training_pair(rgba: np.ndarray, contour: np.ndarray,
                        rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(RGBA render, contour mask) → (4-ch input, gt contour mask), both
    float32, reproducing aug.py get_data."""
    rgb = rgba[..., :3]
    alpha = rgba[..., 3:4]
    body = np.clip(rgb + rng.integers(0, 50, 3) / 255.0, 0, 1)
    body = body * alpha + 1.0 * (1 - alpha)

    cm = np.minimum(alpha[..., 0], contour)[..., None]
    contour_color = rng.random(3)
    cm_soft = cm
    if rng.random() > 0.5:
        cm_soft = (rng.random() * 0.5 + 0.5) * cm_soft
    if rng.random() > 0.5:
        cm_soft = (rng.random(cm.shape[:2])[..., None] * 0.5 + 0.5) * cm_soft
    img = body * (1 - cm_soft) + contour_color * cm_soft
    gt = (cm[..., 0] > 0).astype(np.float32)
    inp = np.concatenate([img, alpha], axis=-1).astype(np.float32)
    return inp, gt


def random_crop_flip(arrs: List[np.ndarray], rng: np.random.Generator,
                     load_size: int = 572, crop_size: int = 512
                     ) -> List[np.ndarray]:
    """Shared resize→crop→flip over a list of HWC arrays (aug.py get_params
    + get_transform semantics)."""
    from PIL import Image
    outs = []
    y = rng.integers(0, load_size - crop_size + 1)
    x = rng.integers(0, load_size - crop_size + 1)
    flip = rng.random() > 0.5
    for a in arrs:
        if a.ndim == 2:
            a = a[..., None]
        if a.shape[0] != load_size:
            img = Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8)
                                  .squeeze())
            a = np.asarray(img.resize((load_size, load_size), Image.BICUBIC),
                           np.float32) / 255.0
            if a.ndim == 2:
                a = a[..., None]
        a = a[y:y + crop_size, x:x + crop_size]
        if flip:
            a = a[:, ::-1]
        outs.append(a.copy())
    return outs


class BiCarDataset:
    """<root>/<uid>/rgba.png + contour_{k}.png (from render/bicar.py)."""

    def __init__(self, root: str, uid_json: str, mode: str = "train",
                 seed: int = 0, crop_size: int = 512, load_size: int = 572):
        with open(uid_json) as f:
            uids = json.load(f)
        self.uids = uids[:TRAIN_SPLIT] if mode == "train" \
            else uids[TRAIN_SPLIT:]
        self.root = root
        self.rng = np.random.default_rng(seed)
        self.crop_size = crop_size
        self.load_size = load_size

    def __len__(self) -> int:
        return len(self.uids) * N_CONTOUR_VARIANTS

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        i = int(self.rng.integers(0, len(self)))
        uid = self.uids[i // N_CONTOUR_VARIANTS]
        k = i % N_CONTOUR_VARIANTS
        rgba = read_image(os.path.join(self.root, uid, "rgba.png"))
        contour = read_image(os.path.join(
            self.root, uid, f"contour_{k}.png"))[..., 0]
        inp, gt = synth_training_pair(rgba, contour, self.rng)
        inp_c, gt_c = random_crop_flip([inp, gt], self.rng,
                                       load_size=self.load_size,
                                       crop_size=self.crop_size)
        gt_c = (gt_c > 0.5).astype(np.float32)  # re-binarize after resize
        return inp_c, gt_c

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            inps, gts = zip(*(self.sample() for _ in range(batch_size)))
            yield {"input": np.stack(inps), "gt": np.stack(gts)}

"""Telea fast-marching inpainting (Telea 2004), the reference's
``cv2.inpaint(..., cv2.INPAINT_TELEA)``: ``native/inpaint.cc``, the source
that ``drawingspinup_tpu/ops/inpaint.py`` runs too. The inpaint front
marches inward in order of its distance T from the region's boundary
(|∇T| = 1 solved upwind); each pixel is filled from its known neighbours
within ``radius``, weighted by direction, distance and level-set
proximity. There is no numpy fallback: a library that does not build
raises."""
from __future__ import annotations

import numpy as np

from drawingspinup_torch import native


def telea_inpaint(img: np.ndarray, mask: np.ndarray, radius: int = 3
                  ) -> np.ndarray:
    """img (H, W, C) float32, mask (H, W) nonzero = inpaint → a filled
    copy."""
    return native.telea_inpaint(img, mask, radius)

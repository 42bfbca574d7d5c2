"""Isosurface extraction: marching tetrahedra through the native extractor,
and the dense export's binary-field smoothing (counterpart of
``drawingspinup_tpu/render/marching.py``, whose numpy extractor is its
oracle; the production paths run the native one). A u8 field is marched
with the level rescaled ×255: edge interpolation is affine-invariant, so
the vertices are those of marching field/255 at ``level``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

from drawingspinup_torch import native


def smooth_binary(binary: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Binary occupancy → smooth field in [0, 1], extracted at 0.5 (a
    gaussian approximation of mcubes.smooth)."""
    return ndimage.gaussian_filter(binary.astype(np.float32), sigma=sigma)


def marching_tetrahedra(field: np.ndarray, level: float = 0.5
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """field: (N, N, N) uint8 (read as field/255) or float → (verts (V,3)
    in index coords, faces (F,3) int64), the surface where it crosses
    ``level``."""
    if field.dtype == np.uint8:
        return native.march_tets(field, float(level) * 255.0)
    return native.march_tets(np.asarray(field, np.float32), float(level))


def extract_isosurface(binary: np.ndarray, sigma: float = 1.0,
                       level: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Binary occupancy grid → smoothed marching-tets mesh, vertices in
    [0, N−1] index space."""
    return marching_tetrahedra(smooth_binary(binary, sigma), level)

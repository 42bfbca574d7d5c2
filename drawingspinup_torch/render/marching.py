"""Isosurface extraction: marching tetrahedra on the export's u8 field
(counterpart of ``drawingspinup_tpu/render/marching.py``, trimmed to the
path the production export runs: the native extractor on a u8 field, level
rescaled ×255; edge interpolation is affine-invariant, so the vertices are
those of marching field/255 at ``level``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from drawingspinup_torch import native


def marching_tetrahedra(field: np.ndarray, level: float = 0.5
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """field: (N, N, N) uint8 → (verts (V,3) in index coords, faces (F,3)
    int64), surface where field/255 crosses ``level``."""
    return native.march_tets(field, float(level) * 255.0)

"""Static sampling tables of the rotation-invariant conv (numpy, no JAX).

Copies of ``drawingspinup_tpu/models/generator_j.py``'s
``ric_sample_positions``, ``ric_shift_weights`` and ``ric_shifted_weights``.
That module imports flax and jax at the top, and the machine with the GPU
has no JAX, so the tables cannot be imported from it.
``tests/test_torch_ric.py`` pins each copy to the JAX original with
``np.array_equal``.

The numpy loops take seconds at 512², so each table is cached per
``(h, w)``. Cached arrays are read-only: every caller shares them.
"""
from __future__ import annotations

import functools

import numpy as np

SHIFTS = [(sy, sx) for sy in (-1, 0, 1) for sx in (-1, 0, 1)]


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=16)
def ric_sample_positions(h: int, w: int) -> np.ndarray:
    """Static (H, W, 9, 2) sampling positions: the 8 non-center 3×3 taps are
    moved onto the unit circle rotated by the pixel's polar angle θ around
    the image center; the center tap stays."""
    rows = np.arange(h, dtype=np.float64)
    cols = np.arange(w, dtype=np.float64)
    cy, cx = h / 2.0 - 0.5, w / 2.0 - 0.5
    dy = rows[:, None] - cy
    dx = cols[None, :] - cx
    theta = np.arctan2(dx, dy) % (2 * np.pi)
    theta = np.round(theta * 1e4) / 1e4
    pos = np.zeros((h, w, 9, 2), np.float64)
    # tap order: row-major 3×3; tap 4 = center; angles advance by π/4 in the
    # order [0,1,2,3,5,6,7,8]
    order = [0, 1, 2, 3, None, 4, 5, 6, 7]
    base = np.stack(np.meshgrid(rows, cols, indexing="ij"), axis=-1)
    for tap in range(9):
        if order[tap] is None:
            pos[:, :, tap, 0] = base[..., 0]
            pos[:, :, tap, 1] = base[..., 1]
        else:
            a = theta + order[tap] * (np.pi / 4.0)
            pos[:, :, tap, 0] = base[..., 0] + np.cos(a)
            pos[:, :, tap, 1] = base[..., 1] + np.sin(a)
    return _frozen(pos.astype(np.float32))


@functools.lru_cache(maxsize=16)
def ric_shift_weights(h: int, w: int) -> np.ndarray:
    """(9 taps, 9 shifts, H, W) float32: per-pixel bilinear weights of each
    rotated tap over the 9 static integer shifts {−1,0,1}² (every rotated
    tap lands within ±1 px of its pixel)."""
    pos = ric_sample_positions(h, w)                      # (H, W, 9, 2)
    base = np.stack(np.meshgrid(np.arange(h, dtype=np.float64),
                                np.arange(w, dtype=np.float64),
                                indexing="ij"), axis=-1)
    d = pos.astype(np.float64) - base[:, :, None, :]      # (H, W, 9, 2)
    out = np.zeros((9, 9, h, w), np.float32)
    sidx = {s: i for i, s in enumerate(SHIFTS)}
    y0 = np.floor(d[..., 0]).astype(np.int64)             # ∈ {−1, 0}
    x0 = np.floor(d[..., 1]).astype(np.int64)
    fy = d[..., 0] - y0
    fx = d[..., 1] - x0
    for tap in range(9):
        for cy in (0, 1):
            for cx in (0, 1):
                wgt = ((fy[:, :, tap] if cy else 1 - fy[:, :, tap])
                       * (fx[:, :, tap] if cx else 1 - fx[:, :, tap]))
                sy = y0[:, :, tap] + cy                   # ∈ {−1, 0, 1}
                sx = x0[:, :, tap] + cx
                for s, i in sidx.items():
                    m = (sy == s[0]) & (sx == s[1])
                    out[tap, i][m] += wgt[m]
    return _frozen(out)


@functools.lru_cache(maxsize=16)
def ric_shifted_weights(h: int, w: int) -> np.ndarray:
    """(9 shifts, 9 taps, H, W) float32: ``ric_shift_weights`` in the
    shifted pixel frame, ``swf[i, t, a, b] = sw[t, i, a−sy_i, b−sx_i]``
    (zero beyond the border)."""
    sw = ric_shift_weights(h, w)                          # (9t, 9i, H, W)
    swf = np.zeros((9, 9, h, w), np.float32)
    for i, (sy, sx) in enumerate(SHIFTS):
        src = sw[:, i]                                    # (9t, H, W)
        pad = np.pad(src, ((0, 0), (1, 1), (1, 1)))
        swf[i] = pad[:, 1 - sy:1 - sy + h, 1 - sx:1 - sx + w]
    return _frozen(swf)

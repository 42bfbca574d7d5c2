"""Image and GIF IO for the stage-3 serving path (numpy + PIL).

Copies of ``drawingspinup_tpu/core/io.py``'s image functions, so that the
port runs on a machine without the JAX package's dependencies;
``tests/test_torch_stage3.py`` pins each copy to its original. Images move
as uint8 or float32 [0,1] HWC arrays.
"""
from __future__ import annotations

import os
import warnings
from typing import Sequence

import numpy as np
from PIL import Image


def read_image_u8(path: str) -> np.ndarray:
    """Read PNG/JPG → uint8 (H, W, C), no [0,1] conversion. A 16-bit input
    is rounded to uint8 with a warning: the u8 path is exact only for 8-bit
    sources (every PNG this pipeline writes is 8-bit)."""
    arr = np.asarray(Image.open(path))
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.dtype != np.uint8:
        warnings.warn(
            f"read_image_u8: {path} is {arr.dtype}, rounding to uint8 — "
            "the u8 fast path is exact only for 8-bit sources",
            stacklevel=2)
        arr = (np.asarray(arr, np.float32)
               / (65535.0 if arr.dtype == np.uint16 else 1.0)
               * 255.0 + 0.5).astype(np.uint8)
    return arr


def read_image(path: str, dtype=np.float32) -> np.ndarray:
    """Read PNG/JPG → float [0,1] (H, W, C); keeps alpha if present."""
    arr = np.asarray(Image.open(path))
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.dtype == np.uint8:
        return arr.astype(dtype) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(dtype) / 65535.0
    return arr.astype(dtype)


def _to_u8(a: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(a, np.float32) * 255.0 + 0.5, 0,
                   255).astype(np.uint8)


def write_image(path: str, arr: np.ndarray) -> None:
    """Write a float [0,1] or uint8 (H, W, C) / (H, W) array as an 8-bit
    PNG (deflate level 1: lossless, and cheap to encode)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    a = np.asarray(arr)
    if a.dtype in (np.float32, np.float64, np.float16):
        a = _to_u8(a)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    Image.fromarray(a).save(path, compress_level=1)


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int = 30,
              loop: int = 0) -> None:
    """Looping GIF, 30 ms/frame by default, disposal 2."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pil = [Image.fromarray(f if f.dtype == np.uint8 else _to_u8(f))
           for f in map(np.asarray, frames)]
    pil[0].save(path, save_all=True, append_images=pil[1:],
                duration=duration_ms, loop=loop, disposal=2)

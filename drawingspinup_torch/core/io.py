"""Image, GIF and OBJ IO (numpy + PIL).

Copies of ``drawingspinup_tpu/core/io.py``'s image and mesh functions, so
that the port runs on a machine without the JAX package's dependencies;
``tests/test_torch_stage3.py`` and ``tests/test_torch_recon.py`` pin each
copy to its original. Images move as uint8 or float32 [0,1] HWC arrays.
"""
from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence, Tuple

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


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: Optional[np.ndarray] = None,
              uvs: Optional[np.ndarray] = None,
              texture_png: Optional[np.ndarray] = None) -> None:
    """OBJ export: vertices (V,3) f32, faces (F,3) 0-based, optional
    per-vertex colors (V,3) in [0,1] as ``v x y z r g b``, optional
    per-vertex uvs (V,2) with a texture image written beside the OBJ and a
    minimal .mtl."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64) + 1
    lines: List[str] = []
    if uvs is not None and texture_png is not None:
        mtl_path = os.path.splitext(path)[0] + ".mtl"
        tex_path = os.path.splitext(path)[0] + ".png"
        write_image(tex_path, texture_png)
        with open(mtl_path, "w") as m:
            m.write("newmtl material_0\nKd 1 1 1\nmap_Kd "
                    + os.path.basename(tex_path) + "\n")
        lines.append(f"mtllib {os.path.basename(mtl_path)}")
        lines.append("usemtl material_0")
    if vertex_colors is not None:
        c = np.clip(np.asarray(vertex_colors, np.float32), 0, 1)
        for p, col in zip(v, c):
            lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                         f"{col[0]:.6f} {col[1]:.6f} {col[2]:.6f}")
    else:
        for p in v:
            lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    if uvs is not None:
        for t in np.asarray(uvs, np.float32):
            lines.append(f"vt {t[0]:.6f} {t[1]:.6f}")
        for tri in f:
            lines.append(f"f {tri[0]}/{tri[0]} {tri[1]}/{tri[1]} "
                         f"{tri[2]}/{tri[2]}")
    else:
        for tri in f:
            lines.append(f"f {tri[0]} {tri[1]} {tri[2]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """OBJ → (vertices (V,3), faces (F,3) 0-based, vertex_colors or None);
    polygons fan-triangulated, normals and uv indices ignored."""
    verts: List[List[float]] = []
    colors: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
                if len(t) >= 7:
                    colors.append([float(x) for x in t[4:7]])
            elif t[0] == "f":
                idx = [int(x.split("/")[0]) - 1 for x in t[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64) if faces else np.zeros((0, 3), np.int64)
    c = np.asarray(colors, np.float32) if len(colors) == len(verts) and colors else None
    return v, f, c

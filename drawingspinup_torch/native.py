"""ctypes bindings to the repo's native C++ code (``native/*.cc`` at the
root of the checkout): quadric decimation, z-buffer rasterization, ±z
raycasts, marching tetrahedra on a u8 field and Telea inpainting.

A copy of ``drawingspinup_tpu/native/__init__.py`` trimmed to what the
port runs. At first use it compiles ``native/decimate.cc``,
``native/inpaint.cc``, ``native/march.cc`` and ``native/raster.cc`` with
``g++`` into ``build/torch_native/`` at the root of the checkout (the flags
of ``native/Makefile``), under a name that carries a digest of the sources
and flags, so that a library built from other sources is never loaded. A
library that fails to build or load raises: there is no numpy fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
SOURCES = tuple(_REPO / "native" / f for f in ("decimate.cc", "inpaint.cc",
                                               "march.cc", "raster.cc"))
BUILD_DIR = _REPO / "build" / "torch_native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)


def lib_path() -> Path:
    """The library's path for the current sources and flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libdsu_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library (always; callers go through ``_load``)."""
    path = lib_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    out = subprocess.run(["g++", *CXXFLAGS, *map(str, SOURCES), "-o",
                          str(tmp)], capture_output=True, text=True,
                         timeout=600)
    if out.returncode:
        raise RuntimeError(f"building {path} failed:\n{out.stderr}")
    tmp.replace(path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                build()
            lib = ctypes.CDLL(str(path))
            ci = ctypes.c_int
            lib.dsu_decimate_fast.argtypes = [_f32p, ci, _i32p, ci, ci, _f32p,
                                              _i32p, _i32p, _i32p]
            lib.dsu_decimate_fast.restype = ci
            lib.dsu_rasterize.argtypes = [_f32p, ci, _i32p, ci, ci, ci, ci,
                                          _f32p, _i32p, _f32p]
            lib.dsu_rasterize.restype = None
            lib.dsu_raycast_z.argtypes = [_f32p, ci, _i32p, ci, _f32p, ci, ci,
                                          _f32p, _i32p]
            lib.dsu_raycast_z.restype = None
            lib.dsu_march_tets_run_u8.argtypes = [_u8p, ci, ctypes.c_float,
                                                  _i64p, _i64p]
            lib.dsu_march_tets_run_u8.restype = ctypes.c_int64
            lib.dsu_march_tets_fetch.argtypes = [ctypes.c_int64, _f32p, _i32p]
            lib.dsu_march_tets_fetch.restype = None
            lib.dsu_telea_inpaint.argtypes = [_f32p, _u8p, ci, ci, ci, ci]
            lib.dsu_telea_inpaint.restype = None
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """Quadric edge-collapse decimation to ≤ target_faces with the
    short-edge pre-pass (``dsu_decimate_fast``) → (verts, faces int64)."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    nv, nf = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.dsu_decimate_fast(_ptr(v, _f32p), len(v), _ptr(f, _i32p),
                               len(f), int(target_faces), _ptr(out_v, _f32p),
                               _ptr(out_f, _i32p), ctypes.byref(nv),
                               ctypes.byref(nf))
    if rc != 0:
        raise RuntimeError(f"dsu_decimate_fast returned {rc}")
    return out_v[: nv.value].copy(), out_f[: nf.value].astype(np.int64)


def rasterize(verts: np.ndarray, faces: np.ndarray, width: int, height: int,
              z_mode: int = 0):
    """Z-buffer rasterization of verts (V,3) in pixel coords → (depth (H,W),
    face_id (H,W) int32 with −1 = background, bary (H,W,3))."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    depth = np.empty((height, width), np.float32)
    face_id = np.empty((height, width), np.int32)
    bary = np.empty((height, width, 3), np.float32)
    lib.dsu_rasterize(_ptr(v, _f32p), len(v), _ptr(f, _i32p), len(f), width,
                      height, z_mode, _ptr(depth, _f32p),
                      _ptr(face_id, _i32p), _ptr(bary, _f32p))
    return depth, face_id, bary


def raycast_z(verts: np.ndarray, faces: np.ndarray, queries: np.ndarray,
              direction: int):
    """±z raycast of queries (Q,3) → (hit_z (Q,), hit_face (Q,) int32 with
    −1 = miss)."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    q = np.ascontiguousarray(queries, np.float32)
    hz = np.empty((len(q),), np.float32)
    hf = np.empty((len(q),), np.int32)
    lib.dsu_raycast_z(_ptr(v, _f32p), len(v), _ptr(f, _i32p), len(f),
                      _ptr(q, _f32p), len(q), int(direction), _ptr(hz, _f32p),
                      _ptr(hf, _i32p))
    return hz, hf


def march_tets(field: np.ndarray, level: float):
    """Marching tetrahedra over an (N,N,N) uint8 field at ``level`` (in u8
    units) → (verts (V,3) f32 index coords, faces (F,3) int64)."""
    lib = _load()
    n = field.shape[0]
    if field.shape != (n, n, n) or field.dtype != np.uint8:
        raise ValueError(f"march_tets: need a cubic uint8 field, got "
                         f"{field.dtype} {field.shape}")
    f = np.ascontiguousarray(field)
    nv, nf = ctypes.c_int64(0), ctypes.c_int64(0)
    h = lib.dsu_march_tets_run_u8(_ptr(f, _u8p), n, ctypes.c_float(level),
                                  ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    lib.dsu_march_tets_fetch(h, _ptr(verts, _f32p), _ptr(faces, _i32p))
    return verts, faces.astype(np.int64)


def telea_inpaint(img: np.ndarray, mask: np.ndarray, radius: int = 3
                  ) -> np.ndarray:
    """Telea fast-marching inpainting (``dsu_telea_inpaint``): img (H, W, C)
    or (H, W) float32, mask (H, W) nonzero = inpaint → a filled copy."""
    lib = _load()
    a = np.ascontiguousarray(img, np.float32)
    if a.ndim == 2:
        a = a[..., None]
    out = a.copy()
    m = np.ascontiguousarray((np.asarray(mask) != 0).astype(np.uint8))
    h, w = m.shape
    if out.shape[:2] != (h, w):
        raise ValueError(f"telea_inpaint: image {out.shape[:2]} and mask "
                         f"{(h, w)} differ")
    lib.dsu_telea_inpaint(_ptr(out, _f32p), _ptr(m, _u8p), h, w,
                          out.shape[2], int(radius))
    return out if np.ndim(img) == 3 else out[..., 0]

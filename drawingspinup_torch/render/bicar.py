"""3DBiCar training-data batch renderer — the Blender/Cycles farm replacement.

A copy of ``drawingspinup_tpu/render/bicar.py`` on the port's
``native.rasterize`` (``native/raster.cc``, built by ``native.py``) and
``core/io.py``; ``tests/test_torch_lama.py`` pins its PNGs byte-equal to
JAX's from one seed.

Parity with ``1_lama_contour_remover/bicar_render_codes/``: the reference
loops 1500 uids spawning headless Blender per object
(``distributed.py:35-58``), normalizing the scene, placing an orthographic
camera (scale 1.35, optional random pose ±45° z / ±15° x,
``blenderProc_ortho.py:135-148``) and rendering RGBA plus 6 Freestyle
external-contour SVGs of random thickness (:159-185).

Here: native z-buffer rasterization (native/raster.cc) of the normalized
mesh under the same camera model, RGBA from vertex colors, and 6
Freestyle-like external-contour PNGs (soft alpha, width wobble, sketchy
gaps — stage1_data.freestyle_contour) on the reference's k·5+1+rand(5)
thickness ladder — a process pool is unnecessary (each object renders in
milliseconds).

Lighting: the reference renders Cycles under a UNIFORM white environment
(strength 1.0, no directional lights — blenderProc_ortho.py:92-95), under
which a diffuse surface returns ≈ albedo; this unlit vertex-color raster
matches that up to ambient-occlusion darkening in concavities (deviation
documented in PARITY.md §2.1 — a directional N·L pass would WIDEN the gap,
so none is applied).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from drawingspinup_torch import native
from drawingspinup_torch.core.io import read_obj, write_image
from drawingspinup_torch.pipelines.stage1_data import (
    N_CONTOUR_VARIANTS, freestyle_contour,
)

ORTHO_SCALE = 1.35
RES = 512


def normalize_mesh(verts: np.ndarray) -> np.ndarray:
    """Center at origin, largest extent → 1 (blenderProc scene normalize)."""
    lo, hi = verts.min(0), verts.max(0)
    center = (lo + hi) / 2
    scale = max(float((hi - lo).max()), 1e-9)
    return (verts - center) / scale


def random_pose(rng: np.random.Generator, randomize: bool) -> np.ndarray:
    """Rotation: ±45° around z (up), ±15° around x (reference :135-148)."""
    if not randomize:
        return np.eye(3, dtype=np.float32)
    az = np.deg2rad(rng.uniform(-45, 45))
    el = np.deg2rad(rng.uniform(-15, 15))
    cz, sz = np.cos(az), np.sin(az)
    cx, sx = np.cos(el), np.sin(el)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    return rz @ rx


def render_object(obj_path: str, out_dir: str,
                  rng: Optional[np.random.Generator] = None,
                  randomize_pose: bool = True, res: int = RES) -> None:
    rng = rng or np.random.default_rng(0)
    verts, faces, colors = read_obj(obj_path)
    if colors is None:
        colors = np.full_like(verts, 0.65)
    v = normalize_mesh(verts) @ random_pose(rng, randomize_pose).T

    # front ortho camera: x→px, z→row (z-up world like the recon pipeline)
    px = (v[:, 0] / ORTHO_SCALE + 0.5) * (res - 1)
    py = (-v[:, 2] / ORTHO_SCALE + 0.5) * (res - 1)
    rv = np.stack([px, py, v[:, 1]], axis=1).astype(np.float32)
    depth, fid, bary = native.rasterize(rv, faces, res, res, 0)
    hit = fid >= 0
    rgb = np.zeros((res, res, 3), np.float32)
    fc = colors[faces[fid[hit]]]
    rgb[hit] = np.einsum("kjc,kj->kc", fc, bary[hit])
    rgba = np.concatenate([rgb, hit[..., None].astype(np.float32)], axis=-1)
    os.makedirs(out_dir, exist_ok=True)
    write_image(os.path.join(out_dir, "rgba.png"), rgba)

    mask = hit.astype(np.float32)
    for k in range(N_CONTOUR_VARIANTS):
        # reference thickness ladder: variant k gets k·5+1+rand(5) px
        # (blenderProc_ortho.py:182-183), so the 6 variants span 1-30 px
        t = int(k * 5 + 1 + rng.integers(0, 5))
        write_image(os.path.join(out_dir, f"contour_{k}.png"),
                    freestyle_contour(mask, t, rng))


def batch_render(obj_root: str, out_root: str, uid_json: str,
                 randomize_pose: bool = True, seed: int = 0,
                 limit: Optional[int] = None) -> List[str]:
    """Render every uid (reference distributed.py loop) — continues past
    per-object failures like the reference's subprocess farm."""
    with open(uid_json) as f:
        uids = json.load(f)
    if limit:
        uids = uids[:limit]
    rng = np.random.default_rng(seed)
    done = []
    for uid in uids:
        obj = None
        for cand in (os.path.join(obj_root, uid, "model.obj"),
                     os.path.join(obj_root, uid + ".obj")):
            if os.path.exists(cand):
                obj = cand
                break
        if obj is None:
            continue
        try:
            render_object(obj, os.path.join(out_root, uid), rng,
                          randomize_pose)
            done.append(uid)
        except Exception as e:  # keep the farm moving
            print(f"[bicar] {uid} failed: {e}")
    return done

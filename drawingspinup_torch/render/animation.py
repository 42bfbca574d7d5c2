"""Skinned-mesh animation renders of stage 3: the colour, NOCS position and
edge passes of every frame of one action FBX.

The port of ``drawingspinup_tpu/render/animation.py``. The numpy helpers
(``cluster_weights``, ``auto_weights``, ``bone_endpoints``, ``auto_frame``)
are copies, pinned bit for bit by ``tests/test_torch_render.py``. On the
run's device: the linear-blend skinning of all frames (one einsum), the
attribute interpolation from the rasterizer's face ids and barycentrics,
the Sobel edges and the u8 quantisation of the three passes. On the host:
the FBX and OBJ, the camera framing, the z-buffer rasterization
(``native/raster.cc`` through ``drawingspinup_torch.native``) and the PNG
writes. The colour and position passes share one rasterization of the
frame (the JAX module rasterizes the same geometry twice).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from drawingspinup_torch import native
from drawingspinup_torch.core.io import read_obj, write_image
from drawingspinup_torch.ops.image import edge_from_pos
from drawingspinup_torch.render import fbx as F

ORTHO_SCALE = 1.35
BASE_RES = 512


# ---------------------------------------------------------------------------
# skin weights
# ---------------------------------------------------------------------------

def cluster_weights(scene: F.FbxScene, n_verts: int
                    ) -> Tuple[np.ndarray, List[int]]:
    """Dense (V, B) weights from the FBX skin clusters."""
    bones = [c.bone_model for c in scene.clusters]
    w = np.zeros((n_verts, len(bones)), np.float32)
    for bi, c in enumerate(scene.clusters):
        ok = c.indexes < n_verts
        w[c.indexes[ok], bi] = c.weights[ok]
    return w, bones


def auto_weights(rest_verts: np.ndarray, bone_heads: np.ndarray,
                 bone_tails: np.ndarray, k: int = 4,
                 power: float = 2.0) -> np.ndarray:
    """Automatic nearest-bone weights (Blender's
    ``weight_from_bones(type='AUTOMATIC')`` in the reference):
    inverse-distance^power to the k nearest bone segments, normalized."""
    v = rest_verts[:, None, :]                          # (V, 1, 3)
    a = bone_heads[None]                                # (1, B, 3)
    b = bone_tails[None]
    ab = b - a
    denom = np.maximum((ab * ab).sum(-1), 1e-12)
    t = np.clip(((v - a) * ab).sum(-1) / denom, 0.0, 1.0)
    closest = a + t[..., None] * ab
    d = np.linalg.norm(v - closest, axis=-1)            # (V, B)
    if d.shape[1] > k:
        kth = np.partition(d, k - 1, axis=1)[:, k - 1: k]
        w = np.where(d <= kth, 1.0 / (d + 1e-6) ** power, 0.0)
    else:
        w = 1.0 / (d + 1e-6) ** power
    return (w / np.maximum(w.sum(1, keepdims=True), 1e-12)).astype(np.float32)


def skin_all_frames(rest_verts: torch.Tensor, weights: torch.Tensor,
                    skin_mats: torch.Tensor) -> torch.Tensor:
    """Linear-blend skinning of all frames at once, in f32 on the tensors'
    device: rest_verts (V, 3), weights (V, B), skin_mats (T, B, 4, 4) →
    (T, V, 3), out[t, v] = Σ_b w[v, b] · (M[t, b] @ [rest_v, 1])."""
    vh = torch.cat([rest_verts, torch.ones_like(rest_verts[:, :1])], dim=-1)
    tv = torch.einsum("tbij,vj->tbvi", skin_mats, vh)             # (T,B,V,4)
    out = torch.einsum("vb,tbvi->tvi", weights, tv)
    return out[..., :3]


def bone_endpoints(scene: F.FbxScene, bones: Sequence[int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Rest-pose bone segment endpoints: head = bind world origin
    (TransformLink), tail = mean of children heads (or head + small z)."""
    heads = {}
    for c in scene.clusters:
        heads[c.bone_model] = c.transform_link[:3, 3]
    children: Dict[int, List[int]] = {}
    for uid, m in scene.models.items():
        if m.parent is not None:
            children.setdefault(m.parent, []).append(uid)
    hs, ts = [], []
    for b in bones:
        h = heads[b]
        ch = [heads[c] for c in children.get(b, []) if c in heads]
        t = np.mean(ch, axis=0) if ch else h + np.array([0, 0, 1e-3])
        hs.append(h)
        ts.append(t)
    return np.asarray(hs, np.float32), np.asarray(ts, np.float32)


# ---------------------------------------------------------------------------
# camera auto-framing (the reference's blender_animation.py)
# ---------------------------------------------------------------------------

def auto_frame(all_verts: np.ndarray) -> Tuple[np.ndarray, float, int]:
    """all_verts (T,V,3) world (x right, y depth, z up) → (delta_location,
    ortho_scale, render_size): recentred, and the render grown past
    ``BASE_RES`` (a multiple of 4) when the motion exceeds the ortho
    scale."""
    mins = all_verts.reshape(-1, 3).min(0)
    maxs = all_verts.reshape(-1, 3).max(0)
    delta = np.array([-(maxs[0] + mins[0]) / 2,
                      maxs[1] - mins[1],
                      -(maxs[2] + mins[2]) / 2])
    ratio = max(maxs[0] - mins[0], maxs[2] - mins[2])
    scale, size = ORTHO_SCALE, BASE_RES
    if ratio > ORTHO_SCALE:
        size = int(BASE_RES / ORTHO_SCALE * ratio)
        if size % 4:
            size += 4 - size % 4
        scale = ORTHO_SCALE * (size / BASE_RES)
    return delta, scale, size


# ---------------------------------------------------------------------------
# pass rendering
# ---------------------------------------------------------------------------

def rasterize_frame(verts: np.ndarray, faces: np.ndarray, size: int,
                    scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize one posed frame front-view (camera looks along +y): pixel
    x ← world x, pixel row ← −world z. Returns (face id (H, W) int32, −1 =
    background; barycentrics (H, W, 3))."""
    px = (verts[:, 0] / scale + 0.5) * (size - 1)
    py = (-verts[:, 2] / scale + 0.5) * (size - 1)
    depth_axis = verts[:, 1]
    rv = np.stack([px, py, depth_axis], axis=1).astype(np.float32)
    _, fid, bary = native.rasterize(rv, faces, size, size, z_mode=0)
    return fid, bary


def shade(fid: torch.Tensor, bary: torch.Tensor, faces: torch.Tensor,
          attrs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Barycentric interpolation of per-vertex ``attrs`` (V, C) over the
    rasterized faces: (image (H, W, C), alpha (H, W)), zero where no face
    was hit."""
    hit = fid >= 0
    corners = attrs[faces[fid.clamp(min=0).long()]]        # (H, W, 3, C)
    img = torch.einsum("hwjc,hwj->hwc", corners, bary)
    return img * hit[..., None], hit.float()


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats → uint8 as ``core.io.write_image`` rounds them."""
    return (x.float() * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)


def render_animation(fbx_path: str, mesh_path: str, output_dir: str,
                     yaw_deg: float = 0.0, device="cpu") -> Dict[str, object]:
    """Colour, position and edge passes of every frame of one action FBX,
    written as ``<output_dir>/{color,pos,edge}/NNNN.png``. Returns the frame
    count, the render size and the host-clock seconds of each part
    (``skin``, ``raster``, ``shade``, ``edge``, ``write``)."""
    dev = torch.device(device)

    def clock() -> float:
        """Host seconds once the device's queued work is done."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    secs = dict.fromkeys(("skin", "raster", "shade", "edge", "write"), 0.0)
    scene = F.load_scene(fbx_path)
    obj_verts, obj_faces, obj_colors = read_obj(mesh_path)
    if obj_colors is None:
        obj_colors = np.full_like(obj_verts, 0.7)

    verts = scene.vertices
    if len(scene.faces):
        faces = scene.faces
    elif len(verts) == 0:
        # no FBX geometry at all → both verts and connectivity from the OBJ
        faces = obj_faces
    else:
        # the OBJ's connectivity indexes the OBJ's vertex order, not these
        raise ValueError(
            f"{fbx_path}: FBX geometry has {len(verts)} vertices but no "
            "polygon indices; cannot borrow the OBJ's connectivity (vertex "
            "orders differ)")
    if len(verts) == 0:
        verts = obj_verts

    # map OBJ attributes onto the FBX vertex order (nearest rest vertex after
    # normalizing both to the unit bbox)
    def norm(v):
        lo, hi = v.min(0), v.max(0)
        return (v - lo) / np.maximum(hi - lo, 1e-9)

    from scipy.spatial import cKDTree
    _, nearest = cKDTree(norm(obj_verts)).query(norm(verts), 1)
    colors = obj_colors[nearest]
    nocs = norm(obj_verts)[nearest]     # normalized rest positions (NOCS)

    # skin weights: repainted automatically whenever the FBX has bones
    t0 = clock()
    bones: List[int] = [c.bone_model for c in scene.clusters]
    if bones:
        heads, tails = bone_endpoints(scene, bones)
        weights = auto_weights(verts, heads, tails)
        inv_bind = np.stack([np.linalg.inv(c.transform_link)
                             for c in scene.clusters])
        bind_mesh = np.stack([c.transform for c in scene.clusters])
        t_lo, t_hi = scene.frame_range()
        fps = scene.frame_rate
        n_frames = max(int(round((t_hi - t_lo) * fps)) + 1, 1)
        times = t_lo + np.arange(n_frames) / fps
        bone_worlds = F.evaluate_bone_worlds(scene, times, bones)
        skin_mats = np.einsum("tbij,bjk,bkl->tbil", bone_worlds, inv_bind,
                              bind_mesh)
        f32 = dict(dtype=torch.float32, device=dev)
        posed = skin_all_frames(torch.as_tensor(verts, **f32),
                                torch.as_tensor(weights, **f32),
                                torch.as_tensor(skin_mats, **f32)
                                ).cpu().numpy()
    else:  # static mesh (rest_pose without armature)
        posed = verts[None]

    if yaw_deg:
        a = np.deg2rad(yaw_deg)
        rz = np.array([[np.cos(a), -np.sin(a), 0],
                       [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
        posed = posed @ rz.T

    delta, scale, size = auto_frame(posed)
    posed = posed + delta[None, None, :]
    secs["skin"] = clock() - t0

    passes = ("color", "pos", "edge")
    for name in passes:
        os.makedirs(os.path.join(output_dir, name), exist_ok=True)
    attrs = torch.as_tensor(np.concatenate([colors, nocs], axis=1),
                            dtype=torch.float32, device=dev)
    faces_t = torch.as_tensor(faces, dtype=torch.long, device=dev)

    for t in range(posed.shape[0]):
        t0 = clock()
        fid, bary = rasterize_frame(posed[t], faces, size, scale)
        t1 = clock()
        img, alpha = shade(torch.from_numpy(fid).to(dev),
                           torch.from_numpy(bary).to(dev), faces_t, attrs)
        out = [to_u8(torch.cat([img[..., :3], alpha[..., None]], -1)),
               to_u8(torch.cat([img[..., 3:], alpha[..., None]], -1))]
        t2 = clock()
        # the reference writes 255 − edge (white ground, black strokes)
        out.append(to_u8(1.0 - edge_from_pos(img[..., 3:], alpha)))
        out = [o.cpu().numpy() for o in out]
        t3 = clock()
        for name, arr in zip(passes, out):
            write_image(os.path.join(output_dir, name, f"{t + 1:04d}.png"),
                        arr)
        t4 = clock()
        for k, dt in zip(("raster", "shade", "edge", "write"),
                         (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            secs[k] += dt
    return {"frames": int(posed.shape[0]), "size": size, "seconds": secs}

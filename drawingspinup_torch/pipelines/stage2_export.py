"""Stage-2b export: trained SDF → carved, smoothed u8 occupancy on the device
→ marching tetrahedra → quadric remesh (counterpart of the production
export of ``drawingspinup_tpu/pipelines/stage2_recon.py``:
``isosurface_device`` :573, ``isosurface_from_smoothed`` :588).

  1. ``bbox_pass``: the SDF on a coarse (R/4+1)³ grid over the AABB; the
     gaussian-smoothed negative region + 10 % margin is the fine grid's
     extent (scipy on the host, as JAX).
  2. ``smoothed_field``: a coarse (R/4+1)³ grid over that extent; the 4³
     fine blocks whose coarse cell comes within 2 coarse cells of the
     surface (dilated by one block) are evaluated at full resolution, the
     rest filled from their cell's low corner (only the sign matters
     there); then the front-mask carve, a separable gaussian (σ 1, radius
     4, three 1-D convolutions over symmetric padding, which is scipy's
     'reflect') and u8 quantization, all on the device.
  3. ``isosurface_from_smoothed``: the native extractor on the u8 field at
     0.5, vertices to world coordinates, remesh to ``face_count``.

Field values go through bf16 on their way to the grid, as JAX's export
evaluator rounds them. Every R % 4 == 0 takes this path, at 64 as at 512.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from drawingspinup_torch.models.fields import sdf_forward
from drawingspinup_torch.models.hashgrid import progressive_mask
from drawingspinup_torch.render import mesh_post
from drawingspinup_torch.render.marching import marching_tetrahedra

BLOCK = 4
BAND_CELLS = 2.0
EVAL_CHUNK = 1 << 20          # points per field evaluation


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class FieldEvaluator:
    """The trained SDF at the export's band state (level mask and active
    levels of ``step``), evaluated in chunks without autograd, values
    rounded through bf16. ``launches`` counts its field evaluations."""

    def __init__(self, cfg, params, step: int, device):
        self.cfg, self.params, self.device = cfg, params, device
        grid = cfg.sdf.grid
        self.level_mask = progressive_mask(grid, step, device)
        self.n_active = min(grid.current_level(step), grid.n_levels)
        self.launches = 0

    @torch.no_grad()
    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        out = []
        for i in range(0, pts.shape[0], EVAL_CHUNK):
            sdf, _ = sdf_forward(self.cfg.sdf, self.params["geometry"],
                                 pts[i:i + EVAL_CHUNK].contiguous(),
                                 self.level_mask, self.n_active)
            out.append(sdf.to(torch.bfloat16).float())
            self.launches += 1
        return torch.cat(out) if out else pts.new_zeros((0,))

    def grid(self, vmin: np.ndarray, vmax: np.ndarray, res: int
             ) -> torch.Tensor:
        """(res, res, res) values at vmin + i/(res−1)·(vmax − vmin),
        indexed (x, y, z)."""
        i = torch.arange(res, device=self.device)
        idx = torch.stack(torch.meshgrid(i, i, i, indexing="ij"),
                          dim=-1).reshape(-1, 3)
        return self(self._points(idx, vmin, vmax, res)).reshape(res, res, res)

    def _points(self, idx: torch.Tensor, vmin, vmax, res: int):
        inv_denom = torch.tensor(np.float32(1.0 / (res - 1)),
                                 device=self.device)
        lo = torch.as_tensor(np.asarray(vmin, np.float32), device=self.device)
        hi = torch.as_tensor(np.asarray(vmax, np.float32), device=self.device)
        t = idx.to(torch.float32) * inv_denom
        return lo + t * (hi - lo)

    def blocks(self, ids: torch.Tensor, vmin, vmax, res: int
               ) -> torch.Tensor:
        """(K, 4³) values of the fine blocks ``ids`` (K, 3) of a res³ grid."""
        b = BLOCK
        r = torch.arange(b, device=self.device)
        offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                           dim=-1).reshape(-1, 3)
        idx = (ids[:, None, :] * b + offs[None]).reshape(-1, 3)
        return self(self._points(idx, vmin, vmax, res)).reshape(-1, b ** 3)


def bbox_pass(ev: FieldEvaluator, resolution: int, radius: float
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Fine-grid extent: the smoothed negative region of a coarse
    (R/4+1)³ grid over the AABB, + 10 % margin."""
    from scipy.ndimage import gaussian_filter

    coarse_res = resolution // 4 + 1
    lo = np.array([-radius] * 3, np.float32)
    hi = np.array([radius] * 3, np.float32)
    level = ev.grid(lo, hi, coarse_res).cpu().numpy()
    neg = np.argwhere(gaussian_filter((level <= 0).astype(np.float32),
                                      1.0) > 0.5)
    if len(neg) == 0:
        raise RuntimeError("empty isosurface (no negative SDF region)")
    v_lo = neg.min(0) / (coarse_res - 1) * 2 * radius - radius
    v_hi = neg.max(0) / (coarse_res - 1) * 2 * radius - radius
    margin = (v_hi - v_lo) * 0.1
    vmin = np.clip(v_lo - margin, -radius, radius).astype(np.float32)
    vmax = np.clip(v_hi + margin, -radius, radius).astype(np.float32)
    return vmin, vmax


def band_blocks(coarse: torch.Tensor, vmin: np.ndarray, vmax: np.ndarray,
                band_cells: float = BAND_CELLS) -> torch.Tensor:
    """(K, 3) ids of the fine blocks within ``band_cells`` coarse cells of
    the surface, dilated by one block (wrapping, as ``np.roll``)."""
    nb = coarse.shape[0] - 1
    cell_world = float(np.max((vmax - vmin) / nb))
    band = band_cells * cell_world
    a = coarse.abs()
    blk_min = a[:-1, :-1, :-1]
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                if dx or dy or dz:
                    blk_min = torch.minimum(
                        blk_min, a[dx:dx + nb, dy:dy + nb, dz:dz + nb])
    active = blk_min < band
    d = active.clone()
    for axis in range(3):
        d |= torch.roll(active, 1, dims=axis) | torch.roll(active, -1,
                                                           dims=axis)
    return torch.nonzero(d)


def front_crop(front_mask: np.ndarray, vmin: np.ndarray, vmax: np.ndarray,
               resolution: int) -> np.ndarray:
    """The [x, z] carve mask resampled to the fine grid's extent (a copy of
    the JAX package's ``front_crop``); values 0-255."""
    size = front_mask.shape[0] / 2
    x0 = int(np.floor(vmin[0] * size + size))
    x1 = int(np.ceil(vmax[0] * size + size))
    z0 = int(np.floor(vmin[2] * size + size))
    z1 = int(np.ceil(vmax[2] * size + size))
    crop = front_mask[max(x0, 0):x1, max(z0, 0):z1]
    from PIL import Image
    return np.asarray(Image.fromarray(
        (np.clip(crop, 0, 1) * 255).astype(np.uint8)).resize(
        (resolution, resolution), Image.BICUBIC), np.float32)


def gaussian_kernel(sigma: float = 1.0, radius: int = 4) -> np.ndarray:
    ks = np.arange(-radius, radius + 1, dtype=np.float32)
    w = np.exp(-0.5 * (ks / sigma) ** 2)
    return w / w.sum()


def _symmetric_pad(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Pad ``r`` on both sides of ``axis``, mirrored with the edge included
    (numpy 'symmetric', scipy 'reflect'); ``F.pad``'s 'reflect' excludes
    the edge."""
    n = x.shape[axis]
    head = x.narrow(axis, 0, r).flip(axis)
    tail = x.narrow(axis, n - r, r).flip(axis)
    return torch.cat([head, x, tail], dim=axis)


def gaussian_blur3d(x: torch.Tensor, sigma: float = 1.0,
                    radius: int = 4) -> torch.Tensor:
    """Separable gaussian of an (R, R, R) f32 field as three 1-D
    convolutions over symmetric padding (scipy ``gaussian_filter``,
    mode 'reflect', truncate 4)."""
    w = torch.as_tensor(gaussian_kernel(sigma, radius), device=x.device)
    k = 2 * radius + 1
    for axis in range(3):
        shape = [1, 1, 1, 1, 1]
        shape[2 + axis] = k
        xp = _symmetric_pad(x, axis, radius)
        x = F.conv3d(xp[None, None], w.reshape(shape))[0, 0]
    return x


def smooth_pack(coarse: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                crop: torch.Tensor, resolution: int) -> torch.Tensor:
    """Occupancy from the coarse cells' low corners, overridden by the
    evaluated band blocks, carved by ``crop`` (R, R) over [x, z], smoothed
    and quantized: (R, R, R) uint8 with field = u8/255."""
    nb, b = resolution // BLOCK, BLOCK
    cell = (coarse[:-1, :-1, :-1] <= 0).to(torch.float32)
    blocks = cell[..., None, None, None].expand(nb, nb, nb, b, b, b).clone()
    if len(ids):
        blocks[ids[:, 0], ids[:, 1], ids[:, 2]] = \
            (vals <= 0).to(torch.float32).reshape(-1, b, b, b)
    x = blocks.permute(0, 3, 1, 4, 2, 5).reshape(resolution, resolution,
                                                 resolution)
    x = x * (crop[:, None, :] > 0.5)
    x = gaussian_blur3d(x)
    return torch.round(x * 255.0).to(torch.uint8)


def smoothed_field(ev: FieldEvaluator, vmin: np.ndarray, vmax: np.ndarray,
                   resolution: int, front_mask: Optional[np.ndarray] = None,
                   times: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """The carved, smoothed, quantized occupancy (R, R, R) u8 on the
    device; ``times`` gets the band evaluation's and the smoothing's
    seconds."""
    R = resolution
    if R % BLOCK:
        raise ValueError(f"export resolution {R} is not a multiple of {BLOCK}")
    t0 = time.time()
    coarse = ev.grid(vmin, vmax, R // BLOCK + 1)
    ids = band_blocks(coarse, vmin, vmax)
    vals = ev.blocks(ids, vmin, vmax, R)
    _sync(ev.device)
    t1 = time.time()
    crop = front_crop(front_mask, vmin, vmax, R) / 255.0 \
        if front_mask is not None else np.ones((R, R), np.float32)
    out = smooth_pack(coarse, ids, vals,
                      torch.as_tensor(crop, device=ev.device), R)
    _sync(ev.device)
    if times is not None:
        times["band_eval"] = t1 - t0
        times["smooth_pack"] = time.time() - t1
    return out


def isosurface_from_smoothed(smoothed_u8: np.ndarray, vmin: np.ndarray,
                             vmax: np.ndarray, resolution: int,
                             face_count: int = 50000, remeshing: bool = True,
                             times: Optional[Dict[str, float]] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """March the u8 field at 0.5, move the vertices to world coordinates,
    remesh to ``face_count``."""
    t0 = time.time()
    verts, faces = marching_tetrahedra(smoothed_u8, 0.5)
    verts = verts / (resolution - 1)
    verts = vmin[None, :] + verts * (vmax - vmin)[None, :]
    t1 = time.time()
    if remeshing and len(faces) > face_count:
        verts, faces = mesh_post.remesh(verts, faces, face_count)
    if times is not None:
        times["march"] = t1 - t0
        times["remesh"] = time.time() - t1
    return verts, faces


def export_mesh(cfg, params, resolution: int, step: int, device,
                front_mask: Optional[np.ndarray] = None,
                face_count: int = 50000
                ) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """bbox → band field → march → remesh; returns (verts, faces, times),
    times holding each part's seconds and ``field_evals``, the field
    evaluations it ran."""
    times: Dict[str, float] = {}
    ev = FieldEvaluator(cfg, params, step, device)
    t0 = time.time()
    vmin, vmax = bbox_pass(ev, resolution, cfg.radius)
    times["bbox"] = time.time() - t0
    field = smoothed_field(ev, vmin, vmax, resolution, front_mask, times)
    field = field.cpu().numpy()
    verts, faces = isosurface_from_smoothed(field, vmin, vmax, resolution,
                                            face_count, times=times)
    times["field_evals"] = ev.launches
    return verts, faces, times

"""Stage-2b export: trained SDF → occupancy → marching tetrahedra → quadric
remesh, by one of the two chains of
``drawingspinup_tpu/pipelines/stage2_recon.py``, chosen as ``recon_uid``
chooses there (``use_device_smooth``).

Device-smooth chain (``isosurface_device`` :573, ``isosurface_from_smoothed``
:588), for R ≥ 256 with R % 4 == 0 unless ``DSU_DEVICE_SMOOTH`` is ""/"0":
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

Level chain (``isosurface_level`` :608, ``isosurface_from_level`` :627),
every other case:
  1. ``bbox_pass(use_blocks=False)``: the same bounds from a coarse grid
     spaced as ``np.linspace``, (R/4+1)³ where the fine grid is sparse,
     else min(R, 128)³;
  2. the SDF on the R³ grid over that extent on the device: dense
     (``dense_grid``) below R = 256 or where R % 4 ≠ 0, else band-sparse
     as step 2 above with the values kept (``sparse_level``, which is how
     ``DSU_DEVICE_SMOOTH=0`` runs at R ≥ 256);
  3. ``isosurface_from_level`` on the host: front-mask carve (PIL bicubic),
     ``smooth_binary`` (scipy's gaussian), the native extractor on the f32
     field at 0.5, remesh.

Every field evaluation runs through ``FieldEvaluator`` (the hash-grid
encode kernel on the card) at the export's band state, and its values go
through bf16, as JAX's export evaluators round them.

Each part is a span of ``core/profiling.py`` (``PARTS`` names them by
chain; ``export.save`` is ``recon_uid``'s), and each field evaluation
counts ``export.field_eval``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from drawingspinup_torch.core import profiling
from drawingspinup_torch.models.fields import sdf_forward
from drawingspinup_torch.models.hashgrid import progressive_mask
from drawingspinup_torch.render import mesh_post
from drawingspinup_torch.render.marching import (
    marching_tetrahedra, smooth_binary,
)

BLOCK = 4
BAND_CELLS = 2.0
EVAL_CHUNK = 1 << 20          # points per field evaluation
# each chain's parts on the device and on the host, in the order they run
PARTS = {"device_smooth": (("bbox", "band_eval", "smooth_pack"),
                           ("march", "remesh")),
         "level": (("bbox", "grid_eval"),
                   ("carve_smooth", "march", "remesh"))}


def xla_linspace(lo: float, hi: float, res: int, device) -> torch.Tensor:
    """``jnp.linspace(lo, hi, res)`` in f32 as XLA compiles it for the CPU
    in JAX's grid program: ``lo·(1 − i·c) + i·(hi·c)`` with
    ``c = f32(1/(res − 1))``, ``1 − i·c`` and the last multiply-add each
    rounded once (fused), and ``hi`` itself last. The products are exact
    in float64, so each fused step is one float64 sum rounded to f32."""
    c = np.float32(1.0 / (res - 1))
    hc = float(np.float32(np.float32(hi) * c))
    i = torch.arange(res - 1, dtype=torch.float64, device=device)
    one_t = (1 - i * float(c)).float().double()
    out = (float(np.float32(lo)) * one_t + (i * hc).float().double()).float()
    return torch.cat([out, torch.tensor([float(np.float32(hi))],
                                        device=device)])


class FieldEvaluator:
    """The trained SDF at the export's band state (level mask and active
    levels of ``step``), evaluated in chunks without autograd, values
    rounded through bf16; each chunk counts ``export.field_eval``."""

    def __init__(self, cfg, params, step: int, device):
        self.cfg, self.params, self.device = cfg, params, device
        grid = cfg.sdf.grid
        self.level_mask = progressive_mask(grid, step, device)
        self.n_active = min(grid.current_level(step), grid.n_levels)

    @torch.no_grad()
    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        out = []
        for i in range(0, pts.shape[0], EVAL_CHUNK):
            sdf, _ = sdf_forward(self.cfg.sdf, self.params["geometry"],
                                 pts[i:i + EVAL_CHUNK].contiguous(),
                                 self.level_mask, self.n_active)
            out.append(sdf.to(torch.bfloat16).float())
            profiling.count("export.field_eval")
        return torch.cat(out) if out else pts.new_zeros((0,))

    def grid(self, vmin: np.ndarray, vmax: np.ndarray, res: int
             ) -> torch.Tensor:
        """(res, res, res) values at vmin + i/(res−1)·(vmax − vmin),
        indexed (x, y, z)."""
        i = torch.arange(res, device=self.device)
        idx = torch.stack(torch.meshgrid(i, i, i, indexing="ij"),
                          dim=-1).reshape(-1, 3)
        return self(self._points(idx, vmin, vmax, res)).reshape(res, res, res)

    def dense_grid(self, vmin: np.ndarray, vmax: np.ndarray, res: int
                   ) -> torch.Tensor:
        """(res, res, res) values on the slab grid of JAX's
        ``eval_sdf_grid``: x at ``np.linspace(vmin[0], vmax[0], res)`` in
        f32, y and z at ``xla_linspace``'s."""
        dev = self.device
        xs = torch.from_numpy(np.linspace(vmin[0], vmax[0], res,
                                          dtype=np.float32)).to(dev)
        lin = [xla_linspace(vmin[k], vmax[k], res, dev) for k in (1, 2)]
        ys, zs = torch.meshgrid(lin[0], lin[1], indexing="ij")
        plane = torch.stack([torch.zeros_like(ys), ys, zs],
                            dim=-1).reshape(-1, 3)
        per = max(1, EVAL_CHUNK // plane.shape[0])
        out = []
        for i in range(0, res, per):
            x = xs[i:i + per]
            pts = plane.repeat(len(x), 1)
            pts[:, 0] = x.repeat_interleave(plane.shape[0])
            out.append(self(pts))
        return torch.cat(out).reshape(res, res, res)

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


def bbox_pass(ev: FieldEvaluator, resolution: int, radius: float,
              sparse: bool = True, use_blocks: bool = True
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Fine-grid extent: the smoothed negative region of a coarse grid over
    the AABB, + 10 % margin. The grid is (R/4+1)³ when ``sparse``, else
    min(R, 128)³, spaced as the fine blocks (``use_blocks``) or as the
    slabs. Span ``export.bbox``."""
    from scipy.ndimage import gaussian_filter

    lo = np.array([-radius] * 3, np.float32)
    hi = np.array([radius] * 3, np.float32)
    coarse_res = resolution // 4 + 1 if sparse else min(resolution, 128)
    with profiling.span("export.bbox"):
        level = (ev.grid if use_blocks else ev.dense_grid)(lo, hi,
                                                           coarse_res)
        level = level.cpu().numpy()
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
                   resolution: int, front_mask: Optional[np.ndarray] = None
                   ) -> torch.Tensor:
    """The carved, smoothed, quantized occupancy (R, R, R) u8 on the
    device; spans ``export.band_eval`` and ``export.smooth_pack``, each
    waiting for the card at its end."""
    R = resolution
    if R % BLOCK:
        raise ValueError(f"export resolution {R} is not a multiple of {BLOCK}")
    with profiling.span("export.band_eval", sync=True):
        coarse = ev.grid(vmin, vmax, R // BLOCK + 1)
        ids = band_blocks(coarse, vmin, vmax)
        vals = ev.blocks(ids, vmin, vmax, R)
    with profiling.span("export.smooth_pack", sync=True):
        crop = front_crop(front_mask, vmin, vmax, R) / 255.0 \
            if front_mask is not None else np.ones((R, R), np.float32)
        return smooth_pack(coarse, ids, vals,
                           torch.as_tensor(crop, device=ev.device), R)


def isosurface_from_smoothed(smoothed_u8: np.ndarray, vmin: np.ndarray,
                             vmax: np.ndarray, resolution: int,
                             face_count: int = 50000, remeshing: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """March the u8 field at 0.5, move the vertices to world coordinates,
    remesh to ``face_count``; spans ``export.march``, ``export.remesh``."""
    with profiling.span("export.march"):
        verts, faces = marching_tetrahedra(smoothed_u8, 0.5)
        verts = verts / (resolution - 1)
        verts = vmin[None, :] + verts * (vmax - vmin)[None, :]
    return _remesh(verts, faces, face_count, remeshing)


def _remesh(verts: np.ndarray, faces: np.ndarray, face_count: int,
            remeshing: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Remesh to ``face_count`` where there are more faces, in the span
    ``export.remesh`` either way."""
    with profiling.span("export.remesh"):
        if remeshing and len(faces) > face_count:
            verts, faces = mesh_post.remesh(verts, faces, face_count)
    return verts, faces


def use_device_smooth(resolution: int) -> bool:
    """JAX's choice of export chain (``recon_uid``, stage2_recon.py:880):
    device-smooth for R ≥ 256 with R % 4 == 0 unless ``DSU_DEVICE_SMOOTH``
    is "" or "0", the level chain otherwise."""
    return (resolution >= 256 and resolution % 4 == 0
            and os.environ.get("DSU_DEVICE_SMOOTH", "1") not in ("", "0"))


def sparse_level(ev: FieldEvaluator, vmin: np.ndarray, vmax: np.ndarray,
                 resolution: int) -> torch.Tensor:
    """The SDF on the R³ grid from a coarse (R/4+1)³ slab grid and the band
    blocks at full resolution, the other blocks filled from their cell's
    low corner (only the sign matters there): JAX's
    ``eval_sdf_grid_sparse``."""
    R, b = resolution, BLOCK
    if R % b:
        raise ValueError(f"export resolution {R} is not a multiple of {b}")
    nb = R // b
    coarse = ev.dense_grid(vmin, vmax, nb + 1)
    ids = band_blocks(coarse, vmin, vmax)
    grid = coarse[:-1, :-1, :-1, None, None, None].expand(
        nb, nb, nb, b, b, b).clone()
    if len(ids):
        grid[ids[:, 0], ids[:, 1], ids[:, 2]] = \
            ev.blocks(ids, vmin, vmax, R).reshape(-1, b, b, b)
    return grid.permute(0, 3, 1, 4, 2, 5).reshape(R, R, R)


def isosurface_level(ev: FieldEvaluator, resolution: int, radius: float,
                     sparse: Optional[bool] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The level chain's device half: bbox, then the SDF on the R³ grid
    (span ``export.grid_eval``), band-sparse where R ≥ 256 and R % 4 == 0
    unless ``sparse`` says → (level (R, R, R) f32 on the host, vmin,
    vmax)."""
    if sparse is None:
        sparse = resolution >= 256 and resolution % BLOCK == 0
    vmin, vmax = bbox_pass(ev, resolution, radius, sparse, use_blocks=False)
    with profiling.span("export.grid_eval"):
        level = sparse_level(ev, vmin, vmax, resolution) if sparse \
            else ev.dense_grid(vmin, vmax, resolution)
        level = level.cpu().numpy()
    return level, vmin, vmax


def isosurface_from_level(level: np.ndarray, vmin: np.ndarray,
                          vmax: np.ndarray, resolution: int,
                          front_mask: Optional[np.ndarray] = None,
                          face_count: int = 50000, remeshing: bool = True
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The level chain's host half: front-mask carve and binary smoothing
    (span ``export.carve_smooth``), marching tetrahedra at 0.5
    (``export.march``), remesh (``export.remesh``)."""
    with profiling.span("export.carve_smooth"):
        binary = level <= 0
        if front_mask is not None:
            crop = front_crop(front_mask, vmin, vmax, resolution)
            binary = binary & (crop[:, None, :] > 127)
        smoothed = smooth_binary(binary.astype(np.float32), 1.0)
    with profiling.span("export.march"):
        verts, faces = marching_tetrahedra(smoothed, 0.5)
        verts = verts / (resolution - 1)
        verts = vmin[None, :] + verts * (vmax - vmin)[None, :]
    return _remesh(verts, faces, face_count, remeshing)


def export_field(cfg, params, resolution: int, step: int, device,
                 front_mask: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
    """The export's device half, by the chain ``use_device_smooth`` picks:
    the bbox and the smoothed u8 field (device-smooth chain) or the level
    field (level chain), copied to the host → {"chain", "field", "vmin",
    "vmax"}."""
    ev = FieldEvaluator(cfg, params, step, device)
    if use_device_smooth(resolution):
        chain = "device_smooth"
        vmin, vmax = bbox_pass(ev, resolution, cfg.radius)
        field = smoothed_field(ev, vmin, vmax, resolution,
                               front_mask).cpu().numpy()
    else:
        chain = "level"
        field, vmin, vmax = isosurface_level(ev, resolution, cfg.radius)
    return {"chain": chain, "field": field, "vmin": vmin, "vmax": vmax}


def export_host(out: Dict[str, Any], resolution: int,
                front_mask: Optional[np.ndarray] = None,
                face_count: int = 50000) -> Tuple[np.ndarray, np.ndarray]:
    """The export's host half on ``export_field``'s output: march and
    remesh → (verts, faces). Reads nothing on the device."""
    if out["chain"] == "device_smooth":
        return isosurface_from_smoothed(out["field"], out["vmin"],
                                        out["vmax"], resolution, face_count)
    return isosurface_from_level(out["field"], out["vmin"], out["vmax"],
                                 resolution, front_mask, face_count)


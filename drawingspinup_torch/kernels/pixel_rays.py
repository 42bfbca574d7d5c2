"""One NSR step's pixel rays and targets: the fused CUDA kernel's wrapper
and its plain PyTorch twin.

The drawn (view, y, x) pixels of a step become world ortho rays
(``rays_o``, ``rays_d``), the pixels' 48-byte target rows of the packed
``(V·H·W, 12)`` f32 table, and the views' weights. On the TPU the row fetch
was ``pallas_gather(kind="rowdma")`` of ``scripts/bench_pallas_gather.py``;
its port ``row_gather.cu`` took 0.006 ms of device time a step against
~25 eager launches around it. ``csrc/pixel_rays.cu`` does all of it in one
launch (one thread a ray, the row fetched with ``gather_row<12>`` of
``hashgrid_common.cuh``), with no host-to-device copy.

``sample`` runs the twin on CPU tensors and the kernel on CUDA tensors; on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from drawingspinup_torch.kernels import hashgrid as hk

# Launches of the kernel wrapper since the last reset; the smoke run resets
# it to show that the recon path went through the kernel.
LAUNCHES = 0

Rays = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def ray_origins(h: int, w: int, yi: torch.Tensor, xi: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """(R, 3) camera-space ortho origins of the drawn pixels' centres,
    ``((x + 0.5) / w − 0.5) · 2`` (and y), z = 0."""
    ox = ((xi.to(dtype) + 0.5) / w - 0.5) * 2.0
    oy = ((yi.to(dtype) + 0.5) / h - 0.5) * 2.0
    return torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1)


# The twin's row fetch, ``tab[idx]``; timing the unfused build swaps the
# row-gather kernel in here.
fetch_rows = hk.row_gather_reference


def pixel_rays_reference(c2w: torch.Tensor, view_weights: torch.Tensor,
                         pixels: torch.Tensor, h: int, w: int,
                         vi: torch.Tensor, yi: torch.Tensor,
                         xi: torch.Tensor) -> Rays:
    """(rays_o (R, 3), rays_d (R, 3), target rows (R, 12), view weights
    (R,)) of the drawn pixels: c2w (V, 3, 4), view_weights (V,), pixels
    (V·H·W, 12) (``train/nsr.py::pack_pixels``), vi/yi/xi (R,) int64."""
    dt = c2w.dtype
    origins = ray_origins(h, w, yi, xi, dt)
    dirs = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=origins.device
                        ).expand(origins.shape)
    rot = c2w[vi]
    rays_d = torch.einsum("rij,rj->ri", rot[:, :, :3], dirs)
    rays_o = torch.einsum("rij,rj->ri", rot[:, :, :3], origins) + rot[:, :, 3]
    rays_d = rays_d / torch.clamp(
        torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-9)
    flat = ((vi * h + yi) * w + xi).to(torch.int32)
    return rays_o, rays_d, fetch_rows(pixels, flat), view_weights[vi]


def ray_ulps(got: Rays, want: Rays, c2w: torch.Tensor, h: int, w: int,
             vi: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor
             ) -> Tuple[float, float]:
    """How far ``got``'s (rays_o, rays_d) lie from ``want``'s, in f32 ulps:
    of Σ_j |R_ij o_j| + |t_i| for each rays_o component (the magnitude of
    the terms it sums), of |want_i| for each unit rays_d component. The
    kernel is held to its twin by this distance, since the twin's einsum
    and norm sum in their own order."""
    eps = torch.finfo(torch.float32).eps
    origins = ray_origins(h, w, yi, xi, torch.float32)
    rot = c2w[vi]
    scale_o = (rot[:, :, :3].abs() * origins.abs()[:, None, :]).sum(-1) \
        + rot[:, :, 3].abs()
    scale_d = want[1].abs().clamp(min=torch.finfo(torch.float32).tiny)
    return (((got[0] - want[0]).abs() / (eps * scale_o)).max().item(),
            ((got[1] - want[1]).abs() / (eps * scale_d)).max().item())


def pixel_rays(c2w: torch.Tensor, view_weights: torch.Tensor,
               pixels: torch.Tensor, h: int, w: int, vi: torch.Tensor,
               yi: torch.Tensor, xi: torch.Tensor) -> Rays:
    """Launch the fused kernel on the current stream (f32 tables, int64
    draws, one CUDA device). Out-of-range draws are clamped: the target
    row into [0, V·H·W), the view into [0, V)."""
    global LAUNCHES
    dev = c2w.device
    tensors = (c2w, view_weights, pixels, vi, yi, xi)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"pixel_rays: every tensor must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    v = c2w.shape[0]
    if c2w.dtype != torch.float32 or tuple(c2w.shape) != (v, 3, 4) \
            or view_weights.dtype != torch.float32 \
            or tuple(view_weights.shape) != (v,):
        raise ValueError(f"pixel_rays: c2w must be f32 (V, 3, 4) and "
                         f"view_weights f32 (V,), got {c2w.dtype} "
                         f"{tuple(c2w.shape)} / {view_weights.dtype} "
                         f"{tuple(view_weights.shape)}")
    if pixels.dtype != torch.float32 or pixels.dim() != 2 \
            or tuple(pixels.shape) != (v * h * w, 12) \
            or not pixels.is_contiguous():
        raise ValueError(f"pixel_rays: pixels must be a contiguous f32 "
                         f"({v * h * w}, 12) table, got {pixels.dtype} "
                         f"{tuple(pixels.shape)}")
    r = vi.shape[0] if vi.dim() == 1 else -1
    for name, t in (("vi", vi), ("yi", yi), ("xi", xi)):
        if t.dtype != torch.int64 or tuple(t.shape) != (r,) \
                or not t.is_contiguous():
            raise ValueError(f"pixel_rays: {name} must be contiguous int64 "
                             f"(R,) like vi, got {t.dtype} "
                             f"{tuple(t.shape)}")
    rays_o = torch.empty((r, 3), dtype=torch.float32, device=dev)
    rays_d = torch.empty((r, 3), dtype=torch.float32, device=dev)
    px = torch.empty((r, 12), dtype=torch.float32, device=dev)
    vw = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return rays_o, rays_d, px, vw
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    c2w, view_weights = c2w.contiguous(), view_weights.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = ext.pixel_rays(vi.data_ptr(), yi.data_ptr(), xi.data_ptr(), r,
                             c2w.data_ptr(), view_weights.data_ptr(), v, h, w,
                             pixels.data_ptr(), rays_o.data_ptr(),
                             rays_d.data_ptr(), px.data_ptr(), vw.data_ptr(),
                             stream)
    hk._raise_on(ext, "pixel_rays", err)
    LAUNCHES += 1
    return rays_o, rays_d, px, vw


def sample(c2w: torch.Tensor, view_weights: torch.Tensor,
           pixels: torch.Tensor, h: int, w: int, vi: torch.Tensor,
           yi: torch.Tensor, xi: torch.Tensor) -> Rays:
    """The plain twin for CPU tensors, the kernel for CUDA tensors."""
    if c2w.device.type == "cpu":
        return pixel_rays_reference(c2w, view_weights, pixels, h, w, vi, yi,
                                    xi)
    return pixel_rays(c2w, view_weights, pixels, h, w, vi, yi, xi)

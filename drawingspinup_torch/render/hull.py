"""Static visual-hull ray intervals for NSR training (counterpart of
``drawingspinup_tpu/render/hull.py``).

A point is inside the visual hull iff its projection into every view lands
inside that view's dilated mask. Per-ray [t_near, t_far] are marched once at
``compute_hw``² rays per view and bilinearly upsampled to the mask size, so
the fixed sample budget concentrates around the surface. Rays that never
enter the hull keep the full AABB span.

JAX's ``reduce_window`` max dilation with "SAME" padding is ``max_pool2d``
with −inf padding here; ``jax.image.resize(..., "bilinear")`` (upsampling)
is ``F.interpolate(..., align_corners=False)``, which clamps at the borders
as JAX renormalises there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from drawingspinup_torch.render import neus
from drawingspinup_torch.render.cameras import ortho_ray_grid, rays_to_world


def _dilate_mask(m: torch.Tensor, px: int) -> torch.Tensor:
    """(V, H, W) float 0/1 → max-pool dilated by ``px`` pixels each side."""
    if px <= 0:
        return m
    k = 2 * px + 1
    return F.max_pool2d(
        F.pad(m[:, None], (px, px, px, px), value=-float("inf")), k,
        stride=1)[:, 0]


def hull_t_ranges(masks: torch.Tensor, c2w: torch.Tensor, radius: float,
                  compute_hw: Optional[int] = None, n_march: int = 128,
                  dilate_px: int = 24, pad: float = 0.05,
                  min_span: float = 0.1,
                  out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Per-pixel visual-hull intervals of every view's ortho rays: masks
    (V, H, W) float 0/1, c2w (V, 3, 4) OpenCV → (V, H, W, 2) f32, [..., 0]
    t_near and [..., 1] t_far, clamped to the AABB span."""
    v, h, w = masks.shape
    out_hw = out_hw or (h, w)
    hc = wc = int(compute_hw or min(256, h))
    origins, dirs = ortho_ray_grid(wc, hc)
    ro, rd = rays_to_world(origins.reshape(-1, 3)[None],
                           dirs.reshape(-1, 3)[None],
                           c2w.detach().cpu().numpy()[:, None])
    dev = masks.device
    tr = _hull_march(masks.float(), c2w.float(),
                     torch.from_numpy(np.ascontiguousarray(ro)).to(dev),
                     torch.from_numpy(np.ascontiguousarray(rd)).to(dev),
                     radius, n_march, dilate_px, pad, min_span)
    tr = tr.reshape(v, hc, wc, 2)
    if (hc, wc) != tuple(out_hw):
        tr = F.interpolate(tr.permute(0, 3, 1, 2), size=tuple(out_hw),
                           mode="bilinear", align_corners=False
                           ).permute(0, 2, 3, 1)
    return tr.float().contiguous()


def _first_true(b: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(b.to(torch.uint8), dim=-1)


@torch.no_grad()
def _hull_march(masks, c2w, ro, rd, radius, n_march, dilate_px, pad,
                min_span):
    v, h, w = masks.shape
    md = _dilate_mask(masks, dilate_px)
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    t_nb, t_fb = neus.aabb_intersect(ro, rd, radius)
    t_fb = torch.maximum(t_fb, t_nb + 1e-4)
    u = (torch.arange(n_march, dtype=torch.float32, device=ro.device)
         + 0.5) / n_march
    t = t_nb[:, None] + (t_fb - t_nb)[:, None] * u
    p = ro[:, None, :] + rd[:, None, :] * t[..., None]

    inside = torch.ones(t.shape, dtype=torch.bool, device=ro.device)
    for tv in range(v):
        r = c2w[tv, :, :3]
        q = torch.einsum("nmi,ij->nmj", p - c2w[tv, :, 3], r)
        xi = (q[..., 0] * 0.5 + 0.5) * w - 0.5
        yi = (q[..., 1] * 0.5 + 0.5) * h - 0.5
        xq = torch.round(xi).to(torch.int64).clamp(0, w - 1)
        yq = torch.round(yi).to(torch.int64).clamp(0, h - 1)
        inb = (q[..., 0].abs() <= 1.0) & (q[..., 1].abs() <= 1.0)
        inside &= torch.where(inb, md[tv][yq, xq] > 0.5,
                              torch.ones_like(inb))

    any_in = inside.any(dim=-1)
    i_first = _first_true(inside)
    i_last = n_march - 1 - _first_true(inside.flip(-1))
    t_first = torch.gather(t, -1, i_first[:, None])[:, 0]
    t_last = torch.gather(t, -1, i_last[:, None])[:, 0]
    step = (t_fb - t_nb) / n_march
    tn = t_first - pad - step
    tf = t_last + pad + step
    mid = 0.5 * (tn + tf)
    half = torch.clamp(0.5 * (tf - tn), min=0.5 * min_span)
    tn = torch.minimum(torch.maximum(mid - half, t_nb), t_fb)
    tf = torch.minimum(torch.maximum(mid + half, t_nb), t_fb)
    tn = torch.where(any_in, tn, t_nb)
    tf = torch.where(any_in, tf, t_fb)
    return torch.stack([tn, tf], dim=-1)

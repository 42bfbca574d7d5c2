"""NeuS volume rendering with fixed shapes (counterpart of
``drawingspinup_tpu/render/neus.py``): AABB slab test, stratified and
inverse-CDF importance samples, the NeuS section alpha with cosine
annealing, and cumprod compositing.

The random draws come in as tensors (``jitter``), never from a generator
inside: the trainer draws them, and the tests hand in JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def aabb_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor,
                   radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test against [-r, r]³: (t_near ≥ 0, t_far); a miss has
    t_far ≤ t_near."""
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-9,
                              torch.sign(rays_d) * 1e-9 + 1e-10, rays_d)
    t0 = (-radius - rays_o) * inv_d
    t1 = (radius - rays_o) * inv_d
    t_min = torch.minimum(t0, t1).amax(dim=-1)
    t_max = torch.maximum(t0, t1).amin(dim=-1)
    return t_min.clamp(min=0.0), t_max


def stratified_samples(t_near: torch.Tensor, t_far: torch.Tensor, n: int,
                       jitter: Optional[torch.Tensor]) -> torch.Tensor:
    """(R,) near/far → (R, n) bin midpoints, moved by (jitter − 0.5)/n when
    a (R, n) uniform ``jitter`` is given."""
    u = (torch.arange(n, dtype=t_near.dtype, device=t_near.device) + 0.5) / n
    u = u.expand(t_near.shape + (n,))
    if jitter is not None:
        u = u + (jitter - 0.5) / n
    return t_near[..., None] + (t_far - t_near)[..., None] * u


def sample_pdf(t_mid: torch.Tensor, weights: torch.Tensor, n: int,
               jitter: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse-CDF importance sampling of n new t per ray from per-bin
    weights; (R, S) → (R, n)."""
    w = weights + 1e-5
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     torch.cumsum(pdf, dim=-1)], dim=-1)
    u = (torch.arange(n, dtype=t_mid.dtype, device=t_mid.device) + 0.5) / n
    u = u.expand(t_mid.shape[:-1] + (n,))
    if jitter is not None:
        u = (u + (jitter - 0.5) / n).clamp(0.0, 1.0 - 1e-6)
    # index = #(cdf entries ≤ u), as JAX's comparison count
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    s = t_mid.shape[-1]
    idx = idx.clamp(1, s)
    below = idx - 1
    above = idx.clamp(max=s - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, idx)
    t_b = torch.gather(t_mid, -1, below)
    t_a = torch.gather(t_mid, -1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-8, torch.ones_like(cdf_a),
                        cdf_a - cdf_b)
    frac = (u - cdf_b) / denom
    return t_b + frac * (t_a - t_b)


def neus_alpha(sdf: torch.Tensor, normal: torch.Tensor, dirs: torch.Tensor,
               dists: torch.Tensor, inv_s: torch.Tensor,
               cos_anneal_ratio) -> torch.Tensor:
    """NeuS section alpha (reference neus.py:90-112)."""
    true_cos = (dirs * normal).sum(dim=-1)
    iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + F.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return alpha.clamp(0.0, 1.0)


def composite(alpha: torch.Tensor, values: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """alpha (R, S) → transmittance weights; each (R, S, C) value summed
    along the samples, plus opacity and the weights."""
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    weights = alpha * trans
    out = {"weights": weights,
           "opacity": weights.sum(dim=-1, keepdim=True)}
    for k, v in values.items():
        out["comp_" + k] = (weights[..., None] * v).sum(dim=-2)
    return out

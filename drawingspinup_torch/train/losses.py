"""NSR reconstruction losses (counterpart of the NSR part of
``drawingspinup_tpu/train/losses.py``): static-shape ranking loss (masked
entries sorted to +inf and cut by a rank threshold), eikonal, sparsity, 3D
normal smoothness, BCE and cosine similarity.

``jnp.argsort`` is stable, so the ranking sort is ``torch.sort(stable=True)``:
masked entries (+inf) tie and keep their order.
"""
from __future__ import annotations

from typing import Optional

import torch


def binary_cross_entropy(x: torch.Tensor, target: torch.Tensor
                         ) -> torch.Tensor:
    x = x.clamp(1e-3, 1.0 - 1e-3)
    return -(target * torch.log(x) + (1.0 - target) * torch.log(1.0 - x))


def ranking_loss(error: torch.Tensor, penalize_ratio: float = 0.7,
                 mask: Optional[torch.Tensor] = None,
                 extra_weights: Optional[torch.Tensor] = None,
                 reduction: str = "mean") -> torch.Tensor:
    """Keep the lowest ``penalize_ratio`` fraction of the (masked) errors."""
    if mask is not None:
        m = mask.to(torch.float32)
        err = torch.where(m > 0, error, torch.full_like(error, float("inf")))
        n_valid = m.sum()
    else:
        err = error
        n_valid = torch.tensor(float(error.shape[0]), device=error.device)
    sorted_err, order = torch.sort(err, stable=True)
    k = torch.floor(penalize_ratio * n_valid)
    keep = torch.arange(err.shape[0], dtype=torch.float32,
                        device=err.device) < k
    sorted_err = torch.where(keep, sorted_err, torch.zeros_like(sorted_err))
    if extra_weights is not None:
        sorted_err = sorted_err * extra_weights[order]
    if reduction == "mean":
        return sorted_err.sum() / torch.clamp(k, min=1.0)
    return sorted_err.sum()


def eikonal_loss(sdf_grad: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    e = (torch.linalg.norm(sdf_grad, dim=-1) - 1.0) ** 2
    if mask is None:
        return e.mean()
    m = mask.to(torch.float32)
    return (e * m).sum() / torch.clamp(m.sum(), min=1.0)


def sparsity_loss(sdf: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    return torch.exp(-scale * sdf.abs()).mean()


def normal_smooth_loss(grad: torch.Tensor,
                       grad_perturb: torch.Tensor) -> torch.Tensor:
    return (grad - grad_perturb).abs().mean()


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    na = torch.linalg.norm(a, dim=-1)
    nb = torch.linalg.norm(b, dim=-1)
    return (a * b).sum(dim=-1) / torch.clamp(na * nb, min=eps)

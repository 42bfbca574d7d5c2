"""Auxiliary encodings and a chunked apply (counterpart of
``drawingspinup_tpu/models/encodings.py``): the positional encoding with
its annealed band mask, the degree-4 spherical-harmonics basis, the
clamped-gradient exp and ``chunk_batch``. No module of either package calls
them; they are here so that the port does all that the JAX package does.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def vanilla_frequency(x: torch.Tensor, n_frequencies: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[sin(2^k x), cos(2^k x)]_k, each band times ``mask[k]`` when given:
    x (..., C) → (..., C·2·n_frequencies)."""
    out = []
    for k in range(n_frequencies):
        band = 2.0 ** k
        m = 1.0 if mask is None else mask[k]
        out += [torch.sin(band * x) * m, torch.cos(band * x) * m]
    return torch.cat(out, dim=-1)


def frequency_mask(n_frequencies: int, step, n_masking_step: int
                   ) -> torch.Tensor:
    """The cosine-annealed band mask at ``step`` (f32); all ones when
    ``n_masking_step <= 0``."""
    if n_masking_step <= 0:
        return torch.ones(n_frequencies)
    t = torch.as_tensor(step, dtype=torch.float32) / n_masking_step \
        * n_frequencies - torch.arange(n_frequencies, dtype=torch.float32)
    return (1.0 - torch.cos(math.pi * t.clamp(0.0, 1.0))) / 2.0


def spherical_harmonics_l4(dirs: torch.Tensor) -> torch.Tensor:
    """The degree-4 real SH basis of unit directions (..., 3) → (..., 16)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.31539156525252005 * (3 * zz - 1),
        -1.0925484305920792 * x * z,
        0.5462742152960396 * (xx - yy),
        -0.5900435899266435 * y * (3 * xx - yy),
        2.890611442640554 * x * y * z,
        -0.4570457994644658 * y * (5 * zz - 1),
        0.3731763325901154 * z * (5 * zz - 3),
        -0.4570457994644658 * x * (5 * zz - 1),
        1.445305721320277 * z * (xx - yy),
        -0.5900435899266435 * x * (xx - 3 * yy),
    ], dim=-1)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp, whose backward is ``g · exp(min(x, 15))`` (JAX's
    ``_trunc_exp_bwd``: only the max is clamped)."""
    return _TruncExp.apply(x)


def chunk_batch(fn: Callable, chunk_size: int, *args: torch.Tensor):
    """``fn`` over row chunks of the leading axis of ``args``, the outputs
    (a tensor or a tuple, list or dict of them) concatenated along it."""
    n = args[0].shape[0]
    outs = [fn(*(a[i:i + chunk_size] for a in args))
            for i in range(0, n, chunk_size)]
    first = outs[0]
    if isinstance(first, dict):
        return {k: torch.cat([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)

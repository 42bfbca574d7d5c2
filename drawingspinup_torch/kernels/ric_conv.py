"""Rotation-invariant 3×3 conv (RIC conv): the CUDA kernels' wrappers, their
plain PyTorch twins, and the autograd Function that joins them.

Counterpart of ``drawingspinup_tpu/kernels/ric_conv.py`` (the Pallas
``_fwd_kernel`` and ``_bwd_kernel`` under a ``custom_vjp``). Layout is the
JAX function's: x (N,H,W,C) f32, wk (9,C,O) f32, swf (9 shifts, 9 taps,
H, W) f32 (``ric_shifted_weights``) → (N,H,W,O) f32.

``ric_conv`` runs ``RICConvFunction`` on every device. Its forward and
backward dispatch on the tensor's device: on the CPU they are the plain
twins (``ric_conv_reference``, ``ric_conv_bwd_reference``), on CUDA the
hand-written kernels in ``csrc/ric_conv_fwd.cu`` and ``csrc/ric_conv_bwd.cu``,
which launch or raise. The backward returns ``dx`` and ``dwk`` and no
gradient to ``swf``, as ``_vjp_bwd`` does, and computes no ``dx`` when the
input needs none.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from drawingspinup_torch.models.ric_tables import SHIFTS

# Launches of each kernel wrapper since the last reset; the smoke run resets
# them to show that the main path went through the kernels.
LAUNCHES = 0           # ric_conv_fwd
BWD_LAUNCHES = 0       # ric_conv_bwd

# Target block count of the dwk split-K product (4 per SM of an H100): the
# batch's pixels are cut into enough fixed slices to reach it, given the
# product's 64 × 128 output tiles and 16-pixel stages (csrc/ric_conv_bwd.cu).
_DWK_TARGET_BLOCKS = 528
_DWK_ROWS, _DWK_COLS, _DWK_STAGE = 64, 128, 16


def _shift2d(y: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """out[:, a, b] = y[:, a+sy, b+sx], zero outside (NHWC)."""
    h, w = y.shape[1], y.shape[2]
    padded = F.pad(y, (0, 0, 1, 1, 1, 1))
    return padded[:, 1 + sy:1 + sy + h, 1 + sx:1 + sx + w]


def ric_conv_reference(x: torch.Tensor, wk: torch.Tensor,
                       swf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch RIC conv: per-tap channel matmul, tap→shift contraction
    with ``swf``, then nine zero-filled shifts (generator_j.py ``fused``)."""
    z = torch.einsum("nhwc,tco->nhwto", x, wk)
    y = torch.einsum("nhwto,ithw->nhwio", z, swf)
    out = None
    for i, (sy, sx) in enumerate(SHIFTS):
        t = _shift2d(y[:, :, :, i], sy, sx)
        out = t if out is None else out + t
    return out


def ric_conv_bwd_reference(x: torch.Tensor, wk: torch.Tensor,
                           swf: torch.Tensor, g: torch.Tensor,
                           need_dx: bool = True
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch VJP of the RIC conv (``_bwd_kernel``'s math): each
    shift's cotangent is g moved back by the shift, zero-filled; ``dz_t`` is
    their sum weighted by the unshifted ``swf``; ``dx = Σ_t dz_t wk[t]ᵀ``
    and ``dwk[t] = Σ xᵀ dz_t`` over the batch. Returns (dx or None, dwk)."""
    dacc = torch.stack([_shift2d(g, -sy, -sx) for sy, sx in SHIFTS], dim=3)
    dz = torch.einsum("nhwio,ithw->nhwto", dacc, swf)
    dwk = torch.einsum("nhwc,nhwto->tco", x, dz)
    dx = torch.einsum("nhwto,tco->nhwc", dz, wk) if need_dx else None
    return dx, dwk


def _check(name: str, x: torch.Tensor, wk: torch.Tensor,
           swf: torch.Tensor) -> None:
    for arg, t in (("x", x), ("wk", wk), ("swf", swf)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (N,H,W,C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if wk.dim() != 3 or wk.shape[0] != 9 or wk.shape[1] != c:
        raise ValueError(f"{name}: wk must be (9,{c},O), got "
                         f"{tuple(wk.shape)}")
    if tuple(swf.shape) != (9, 9, h, w):
        raise ValueError(f"{name}: swf must be (9,9,{h},{w}), got "
                         f"{tuple(swf.shape)}")
    if min(n, h, w, c, wk.shape[2]) == 0:
        raise ValueError(f"{name}: empty tensor")
    if max(x.numel(), n * h * w * wk.shape[2]) >= 2 ** 31:
        raise ValueError(f"{name}: tensor too large for int indices")
    for arg, t in (("x", x), ("wk", wk), ("swf", swf)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {arg} must be on x's CUDA device, got "
                             f"{t.device}")


def _raise_on(ext, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {ext.error_string(err)}")


def ric_conv_fwd(x: torch.Tensor, wk: torch.Tensor,
                 swf: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream; raises on any input
    it does not take and on a failed launch."""
    global LAUNCHES
    _check("ric_conv_fwd", x, wk, swf)
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    n, h, w, c = x.shape
    o = wk.shape[2]
    out = torch.empty((n, h, w, o), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = ext.ric_conv_fwd(x.data_ptr(), wk.data_ptr(), swf.data_ptr(),
                               out.data_ptr(), n, h, w, c, o, stream)
    _raise_on(ext, "ric_conv_fwd", err)
    LAUNCHES += 1
    return out


def dwk_slices(n: int, h: int, w: int, c: int, o: int) -> int:
    """How many fixed pixel slices the dwk product is cut into: enough
    blocks to fill the card, never a slice shorter than one stage. A
    function of the shape alone, so the summation order is too."""
    per_slice = -(-c // _DWK_ROWS) * -(-9 * o // _DWK_COLS)
    return max(1, min(-(-n * h * w // _DWK_STAGE),
                      -(-_DWK_TARGET_BLOCKS // per_slice)))


def ric_conv_bwd(x: torch.Tensor, wk: torch.Tensor, swf: torch.Tensor,
                 g: torch.Tensor, need_dx: bool = True
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Launch the backward kernels on the current stream: dx (unless
    ``need_dx`` is false), then dwk: the sampled cotangent (an (N·H·W, 9, O)
    scratch), fixed split-K partial products, their ordered reduction.
    Returns (dx or None, dwk); raises on any input it does not take and on
    a failed launch."""
    global BWD_LAUNCHES
    _check("ric_conv_bwd", x, wk, swf)
    n, h, w, c = x.shape
    o = wk.shape[2]
    if g.dtype != torch.float32 or tuple(g.shape) != (n, h, w, o) \
            or g.device != x.device:
        raise ValueError(f"ric_conv_bwd: g must be float32 ({n},{h},{w},{o}) "
                         f"on {x.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    if n * h * w * 9 * o >= 2 ** 31:
        raise ValueError("ric_conv_bwd: tensor too large for int indices")
    g = g.contiguous()
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    dwk = torch.empty((9, c, o), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    slices = dwk_slices(n, h, w, c, o)
    dz = torch.empty((n * h * w, 9, o), dtype=torch.float32, device=x.device)
    scratch = torch.empty((slices, c, 9 * o), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if need_dx:
            _raise_on(ext, "ric_conv_bwd (dx)", ext.ric_conv_bwd_dx(
                g.data_ptr(), wk.data_ptr(), swf.data_ptr(), dx.data_ptr(),
                n, h, w, c, o, stream))
        _raise_on(ext, "ric_conv_bwd (dwk)", ext.ric_conv_bwd_dwk(
            x.data_ptr(), g.data_ptr(), swf.data_ptr(), dz.data_ptr(),
            scratch.data_ptr(), dwk.data_ptr(), n, h, w, c, o, slices,
            stream))
    BWD_LAUNCHES += 1
    return dx, dwk


class RICConvFunction(torch.autograd.Function):
    """RIC conv with its VJP: the plain twins on the CPU, the kernels on
    CUDA. No gradient flows to ``swf`` (a constant table)."""

    @staticmethod
    def forward(ctx, x, wk, swf):
        ctx.save_for_backward(x, wk, swf)
        if x.device.type == "cpu":
            return ric_conv_reference(x, wk, swf)
        return ric_conv_fwd(x, wk, swf)

    @staticmethod
    def backward(ctx, g):
        x, wk, swf = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        if x.device.type == "cpu":
            dx, dwk = ric_conv_bwd_reference(x, wk, swf, g, need_dx)
        else:
            dx, dwk = ric_conv_bwd(x, wk, swf, g, need_dx)
        return dx, dwk, None


def ric_conv(x: torch.Tensor, wk: torch.Tensor,
             swf: torch.Tensor) -> torch.Tensor:
    """RIC conv, differentiable in ``x`` and ``wk``: the plain twins for a
    CPU tensor, the kernels for a CUDA tensor."""
    return RICConvFunction.apply(x, wk, swf)

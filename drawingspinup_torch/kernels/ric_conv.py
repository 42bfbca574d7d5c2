"""Rotation-invariant 3×3 conv (RIC conv) forward: the CUDA kernel's wrapper
and its plain PyTorch twin.

Counterpart of ``drawingspinup_tpu/kernels/ric_conv.py`` (the Pallas
``_fwd_kernel``). Layout is the JAX function's: x (N,H,W,C) f32,
wk (9,C,O) f32, swf (9 shifts, 9 taps, H, W) f32 (``ric_shifted_weights``)
→ (N,H,W,O) f32.

``ric_conv`` dispatches on the tensor's device: a CPU tensor goes to
``ric_conv_reference`` (the ``fused`` math of generator_j.py's RICConv), a
CUDA tensor to the hand-written kernel in ``csrc/ric_conv_fwd.cu``, which
launches or raises. Only the forward is ported; the backward kernel comes
with stage-3 training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from drawingspinup_torch.models.ric_tables import SHIFTS

# Kernel launches since the last reset; the smoke run resets it to show the
# main path went through the kernel.
LAUNCHES = 0


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


def _check(x: torch.Tensor, wk: torch.Tensor, swf: torch.Tensor) -> None:
    for name, t in (("x", x), ("wk", wk), ("swf", swf)):
        if t.dtype != torch.float32:
            raise TypeError(f"ric_conv_fwd: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ric_conv_fwd: {name} must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"ric_conv_fwd: x must be (N,H,W,C), got "
                         f"{tuple(x.shape)}")
    n, h, w, c = x.shape
    if wk.dim() != 3 or wk.shape[0] != 9 or wk.shape[1] != c:
        raise ValueError(f"ric_conv_fwd: wk must be (9,{c},O), got "
                         f"{tuple(wk.shape)}")
    if tuple(swf.shape) != (9, 9, h, w):
        raise ValueError(f"ric_conv_fwd: swf must be (9,9,{h},{w}), got "
                         f"{tuple(swf.shape)}")
    if min(n, h, w, c, wk.shape[2]) == 0:
        raise ValueError("ric_conv_fwd: empty tensor")
    if max(x.numel(), n * h * w * wk.shape[2]) >= 2 ** 31:
        raise ValueError("ric_conv_fwd: tensor too large for int indices")
    for name, t in (("x", x), ("wk", wk), ("swf", swf)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ric_conv_fwd: {name} must be on x's CUDA "
                             f"device, got {t.device}")


def ric_conv_fwd(x: torch.Tensor, wk: torch.Tensor,
                 swf: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on any input it
    does not take and on a failed launch."""
    global LAUNCHES
    _check(x, wk, swf)
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    n, h, w, c = x.shape
    o = wk.shape[2]
    out = torch.empty((n, h, w, o), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = ext.ric_conv_fwd(x.data_ptr(), wk.data_ptr(), swf.data_ptr(),
                               out.data_ptr(), n, h, w, c, o, stream)
    if err:
        raise RuntimeError(
            f"ric_conv_fwd launch failed: {ext.error_string(err)}")
    LAUNCHES += 1
    return out


def ric_conv(x: torch.Tensor, wk: torch.Tensor,
             swf: torch.Tensor) -> torch.Tensor:
    """RIC conv forward: the plain twin for a CPU tensor, the kernel for a
    CUDA tensor."""
    if x.device.type == "cpu":
        return ric_conv_reference(x, wk, swf)
    return ric_conv_fwd(x, wk, swf)

"""Attention core of the stage-2a MV UNet: the hand-written bf16 flash kernel
(``csrc/mv_attention.cu``), its wrapper and its plain version.

``attention(q, k, v, heads)`` computes softmax(q·kᵀ/√d)·v per head on
(B, Sq, C) queries and (B, Sk, C) keys and values, d = C / heads, and
dispatches on what it can see in its input:

- bf16 on CUDA launches the kernel (``mv_attention``), always: it reads q,
  k and v where they lie (unit stride last; batch and row strides of 8
  elements; 16-byte aligned), writes a new (B, Sq, C) bf16 tensor, and
  raises on a head dim or a layout it does not take;
- CPU tensors, and f32 or float64 inputs on any device, take the plain
  version (``attention_reference``): upcast to f32 (float64 stays
  float64), ``F.scaled_dot_product_attention``, cast back.

The kernel keeps f32 accumulators and an f32 softmax and rounds P to bf16
for P·V, as half-precision flash attention and the published fp16
pipeline do; ``output_ulps`` measures how far it lies from the plain
version. It replaces no Pallas kernel (the JAX package upcasts to f32 for
TPU v5e); the source note says what bounds it and what its design does.

Each launch counts ``LAUNCHES`` on ``core/profiling.py``'s registry.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from drawingspinup_torch.core import profiling

# the kernel's template cases: the published UNet's 40, 80 and 160, and the
# narrow UNets' 8 and 16 (``cli/mv.py --tiny``, ``parallel/dryrun.py``)
HEAD_DIMS = (8, 16, 40, 80, 160)
LAUNCHES = "mv.attn.launch"     # the launch counter
_ALIGN = 8                      # elements of a 16-byte cp.async chunk


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """The plain version: (B, Sq, C) × (B, Sk, C) → (B, Sq, C) attention,
    scale 1/sqrt(C/heads), computed in f32 (float64 stays float64) and
    returned in q's dtype."""
    dt = q.dtype
    wide = torch.float64 if dt == torch.float64 else torch.float32
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    q = q.reshape(b, sq, heads, d).transpose(1, 2).to(wide)
    k = k.reshape(b, sk, heads, d).transpose(1, 2).to(wide)
    v = v.reshape(b, sk, heads, d).transpose(1, 2).to(wide)
    out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(b, sq, c).to(dt)


def _strides(name: str, t: torch.Tensor):
    """(batch, row) strides in elements the kernel reads ``t`` with; a
    dimension of size 1 is never stepped over and passes 0."""
    shape, st = t.shape, t.stride()
    if st[2] != 1 and shape[2] > 1:
        raise ValueError(f"mv_attention: {name} needs unit stride along C, "
                         f"got strides {st}")
    out = (0 if shape[0] == 1 else st[0], 0 if shape[1] == 1 else st[1])
    if out[0] % _ALIGN or out[1] % _ALIGN or t.data_ptr() % 16:
        raise ValueError(f"mv_attention: {name} needs batch and row "
                         f"strides of multiples of {_ALIGN} elements and a "
                         f"16-byte aligned start, got strides {st} at "
                         f"{t.data_ptr():#x}")
    return out


def mv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 heads: int) -> torch.Tensor:
    """Launch the kernel on the current stream: bf16 q (B, Sq, C), k and v
    (B, Sk, C) on one CUDA device, C / heads in ``HEAD_DIMS``; returns a
    new (B, Sq, C) bf16 tensor that carries no autograd graph. Raises on any
    input it does not take (inputs that require grad while grad is enabled
    among them: the kernel is forward only) and on a failed launch, before
    building anything where the input is wrong."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.dim() != 3:
            raise TypeError(f"mv_attention: {name} must be a 3-d bf16 "
                            f"tensor, got {t.dtype} {tuple(t.shape)}")
    b, sq, c = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, c) or tuple(v.shape) != (b, sk, c):
        raise ValueError(f"mv_attention: k and v must be ({b}, Sk, {c}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if heads <= 0 or c % heads or c // heads not in HEAD_DIMS:
        raise ValueError(f"mv_attention: head dim {c}/{heads} is not one of "
                         f"{HEAD_DIMS}")
    if min(b, sq, sk) == 0 or max(sq, sk) >= 2 ** 31 \
            or max(b, heads) > 65535:
        raise ValueError(f"mv_attention: sizes B {b}, Sq {sq}, Sk {sk}, "
                         f"heads {heads} out of the kernel's range")
    strides = _strides("q", q) + _strides("k", k) + _strides("v", v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("mv_attention: the kernel has no backward pass; "
                           "q, k and v that require grad would lose their "
                           "gradients here")
    if any(t.device.type != "cuda" or t.device != q.device
           for t in (q, k, v)):
        raise ValueError(f"mv_attention: q, k and v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    dev = q.device
    out = torch.empty((b, sq, c), dtype=torch.bfloat16, device=dev)
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    # the raw stream of q's device: torch.cuda.current_stream() costs ~10 µs
    # of host time a call, which 3600 calls a uid would feel
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *strides, sq * c, c, b, sq, sk, heads, c // heads,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = ext.mv_attention(*args)
    else:
        with torch.cuda.device(dev):
            err = ext.mv_attention(*args)
    if err:
        raise RuntimeError(f"mv_attention launch failed: "
                           f"{ext.error_string(err)}")
    profiling.count(LAUNCHES)
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """The attention core: the kernel for bf16 on CUDA, the plain version
    for CPU tensors and for f32 and float64 inputs; raises on any other
    CUDA dtype."""
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        return mv_attention(q, k, v, heads)
    if q.device.type == "cpu" or q.dtype in (torch.float32, torch.float64):
        return attention_reference(q, k, v, heads)
    raise TypeError(f"attention: no core for {q.dtype} on {q.device}")


def output_ulps(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor,
                heads: int) -> float:
    """The largest |got − want| of two (B, Sq, C) attention outputs, in
    bf16 ulps of max |v| over the keys and width of its (row, head).

    Why that unit: the kernel rounds each weight p of P to bf16 (relative
    error ≤ 2⁻⁸), which moves Σ p·v / Σ p by at most 2⁻⁸ · max |v|, less
    than one ulp of max |v|; each side's rounding of its output to bf16
    adds at most half an ulp of |out| ≤ max |v|. So the kernel and the
    plain version, which rounds only the output, lie within 2 such ulps;
    f32 sums in another order and ex2.approx add far less."""
    b, sq, c = got.shape
    d = c // heads
    vmax = v.float().abs().reshape(b, -1, heads, d).amax(dim=(1, 3))
    # bf16 ulp of x: 2^(floor(log2 x) − 7); at least the smallest normal's
    ulp = torch.exp2(torch.floor(torch.log2(
        vmax.clamp_min(torch.finfo(torch.bfloat16).tiny))) - 7)
    diff = (got.float() - want.float()).abs().reshape(b, sq, heads, d)
    return float((diff / ulp[:, None, :, None]).max())


def output_rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ over the whole of two attention outputs.

    ``output_ulps`` bounds the worst element by max |v| of its row and
    head, which is loose where many keys share the weight: at the views
    fold (6144 keys) a typical |out| is a few hundredths of max |v|. This
    limit reads every element at its own size. The kernel's roundings (P
    and the output to bf16) read about 2e-3 here, the output's rounding
    alone about 1e-3; a dropped tile of 64 keys of 6144, or d = 40 scaled
    by its padded 48, reads 1e-1 and more (the emulation's slips in
    ``tests/test_torch_mv_attention_kernel.py``)."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(
        torch.finfo(torch.float32).tiny))

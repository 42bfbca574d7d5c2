"""Rotation-invariant 3×3 conv (RIC conv): the CUDA kernels' wrappers, their
plain PyTorch twins, and the autograd Function that joins them.

Counterpart of ``drawingspinup_tpu/kernels/ric_conv.py`` (the Pallas
``_fwd_kernel`` and ``_bwd_kernel`` under a ``custom_vjp``). Layout is the
JAX function's: x (N,H,W,C) f32, wk (9,C,O) f32, swf (9 shifts, 9 taps,
H, W) f32 (``ric_shifted_weights``) → (N,H,W,O) f32.

``ric_conv`` runs ``RICConvFunction`` on every device. Its forward and
backward dispatch on the tensor's device: on the CPU they are the plain
twins (``ric_conv_reference``, ``ric_conv_bwd_reference``), on CUDA the
hand-written kernels in ``csrc/``, which launch or raise. The forward on
CUDA (``ric_conv_fwd``, ``csrc/ric_conv_fwd_gemm.cu``) is one 3xTF32
tensor-core implicit GEMM, out = U · Wk with U the sampled input of
``ric_conv_sample_reference`` built tile by tile in shared memory;
``fwd_plan`` plans its output width and split-K slices. The backward
returns ``dx`` and ``dwk`` and no gradient to ``swf``, as ``_vjp_bwd``
does, and computes no ``dx`` when the input needs none. On CUDA it is
four parts, each its own function: the sampled cotangent ``dz``
(``bwd_dz``, ``csrc/ric_conv_bwd.cu``), then two 3xTF32 tensor-core GEMMs
over it (``bwd_dx``, ``bwd_dwk``, ``csrc/ric_conv_bwd_gemm.cu``) whose
fixed split-K slices are summed in order; ``gemm_plan`` plans their tiles
and splits from the shape alone.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from drawingspinup_torch.core import profiling
from drawingspinup_torch.models.ric_tables import SHIFTS

# The backward GEMM's tiles (csrc/ric_conv_bwd_gemm.cu, which refuses a
# launch planned with others): a block computes a GEMM_BM × GEMM_BN tile of
# the product over GEMM_BK-deep stages.
GEMM_BM, GEMM_BN, GEMM_BK = 64, 64, 32
SMS = 132                       # streaming multiprocessors of an H100
# A launch aims at four blocks per SM; a split-K slice walks at least four
# stages, so that its double buffer has something to overlap.
_TARGET_BLOCKS = 4 * SMS
_MIN_SLICE_STAGES = 4

# The forward's tiles (csrc/ric_conv_fwd_gemm.cu, which refuses a launch
# planned with others): an 8×8 pixel tile (64 rows, one wgmma M), channel
# chunks of FWD_CK, and an output width of one of FWD_BN. One block runs on
# an SM at a time, so a launch aims at two waves; a slice walks at least
# three stages, as many as the smallest ring holds.
FWD_TILE, FWD_CK = 8, 32
FWD_BN = (32, 64, 128)
_FWD_TARGET_BLOCKS = 2 * SMS
_MIN_FWD_SLICE_STAGES = 3


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


def ric_conv_sample_reference(x: torch.Tensor,
                              swf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sampled input U (N,H,W,9,C) of the forward's implicit
    GEMM: ``U[..., t, :] = Σ_i shift_i(swf[i, t] · x)``, zero-filled, so
    that ``U.view(P, 9·C) @ wk.view(9·C, O)`` is ``ric_conv_reference``."""
    u = None
    for i, (sy, sx) in enumerate(SHIFTS):
        xs = _shift2d(x, sy, sx)
        ws = _shift2d(swf[i].permute(1, 2, 0)[None], sy, sx)[0]   # (H,W,9)
        term = ws[None, :, :, :, None] * xs[:, :, :, None, :]
        u = term if u is None else u + term
    return u


def ric_conv_bwd_dz_reference(g: torch.Tensor,
                              swf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sampled cotangent (N,H,W,9,O): each shift's cotangent
    is g moved back by the shift, zero-filled; ``dz_t`` is their sum
    weighted by the unshifted ``swf``."""
    dacc = torch.stack([_shift2d(g, -sy, -sx) for sy, sx in SHIFTS], dim=3)
    return torch.einsum("nhwio,ithw->nhwto", dacc, swf)


def ric_conv_bwd_reference(x: torch.Tensor, wk: torch.Tensor,
                           swf: torch.Tensor, g: torch.Tensor,
                           need_dx: bool = True
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch VJP of the RIC conv (``_bwd_kernel``'s math): the
    sampled cotangent ``dz`` (``ric_conv_bwd_dz_reference``), then
    ``dx = Σ_t dz_t wk[t]ᵀ`` and ``dwk[t] = Σ xᵀ dz_t`` over the batch.
    Returns (dx or None, dwk)."""
    dz = ric_conv_bwd_dz_reference(g, swf)
    dwk = torch.einsum("nhwc,nhwto->tco", x, dz)
    dx = torch.einsum("nhwto,tco->nhwc", dz, wk) if need_dx else None
    return dx, dwk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One launch of the backward's GEMM, C (m × n) = A (m × k) · B (k × n),
    on a grid of (m tiles, n tiles, slices) blocks: slice s sums k over
    ``bounds()[s]``, into its own partial product, and the partial products
    are added in slice order."""
    m: int
    n: int
    k: int
    slice_k: int
    slices: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (_cdiv(self.m, GEMM_BM), _cdiv(self.n, GEMM_BN), self.slices)

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def bounds(self) -> List[Tuple[int, int]]:
        """Each slice's [k0, k1), in the order the slices are summed."""
        return [(s * self.slice_k, min(self.k, (s + 1) * self.slice_k))
                for s in range(self.slices)]


def gemm_plan(m: int, n: int, k: int) -> GemmPlan:
    """Split of an (m × k)·(k × n) product: as many fixed K slices, each a
    whole number of stages and at least ``_MIN_SLICE_STAGES`` deep, as bring
    the grid to about ``_TARGET_BLOCKS`` blocks (one slice where the output
    tiles alone reach it). A function of the shape alone, and so is the
    summation order."""
    tiles = _cdiv(m, GEMM_BM) * _cdiv(n, GEMM_BN)
    stages = _cdiv(k, GEMM_BK)
    want = max(1, min(_cdiv(_TARGET_BLOCKS, tiles),
                      stages // _MIN_SLICE_STAGES))
    per = _cdiv(stages, want)
    return GemmPlan(m, n, k, per * GEMM_BK, _cdiv(stages, per))


def bwd_plan(n: int, h: int, w: int, c: int, o: int
             ) -> Tuple[GemmPlan, GemmPlan]:
    """The (dx, dwk) GEMM plans of the backward at x (n, h, w, c) and o
    outputs, with P = n·h·w pixels flattened across the batch and J = 9·o:
    dx = dz (P × J) · wkᵀ (J × c), dwk = xᵀ (c × P) · dz (P × J)."""
    p, j = n * h * w, 9 * o
    return gemm_plan(p, c, j), gemm_plan(c, j, p)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """One launch of the forward (csrc/ric_conv_fwd_gemm.cu) at x (n, h, w,
    c) and o outputs: a block per (8×8 pixel tile, ``bn`` outputs, slice);
    the K of 9·c is walked in stages of one tap of one ``FWD_CK``-channel
    chunk (chunk-major, tap-minor), and slice s sums the stages
    ``bounds()[s]`` into its own partial product, added in slice order."""
    n: int
    h: int
    w: int
    c: int
    o: int
    bn: int
    slice_stages: int
    slices: int

    @property
    def tiles_y(self) -> int:
        return _cdiv(self.h, FWD_TILE)

    @property
    def tiles_x(self) -> int:
        return _cdiv(self.w, FWD_TILE)

    @property
    def o_tiles(self) -> int:
        return _cdiv(self.o, self.bn)

    @property
    def stages(self) -> int:
        return 9 * _cdiv(self.c, FWD_CK)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.n * self.tiles_y * self.tiles_x, self.o_tiles,
                self.slices)

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def tile_origin(self, bx: int) -> Tuple[int, int, int]:
        """(image, first row, first column) of grid column ``bx``'s tile."""
        per_image = self.tiles_y * self.tiles_x
        tile = bx % per_image
        return (bx // per_image, (tile // self.tiles_x) * FWD_TILE,
                (tile % self.tiles_x) * FWD_TILE)

    def bounds(self) -> List[Tuple[int, int]]:
        """Each slice's stages [s0, s1), in the order the slices are
        summed."""
        return [(s * self.slice_stages,
                 min(self.stages, (s + 1) * self.slice_stages))
                for s in range(self.slices)]


def fwd_plan(n: int, h: int, w: int, c: int, o: int) -> FwdPlan:
    """The forward's launch: ``bn`` the narrowest of ``FWD_BN`` that holds
    o (the widest, tiled, past it); and as many fixed stage slices, each at
    least ``_MIN_FWD_SLICE_STAGES`` deep, as bring the grid to about
    ``_FWD_TARGET_BLOCKS`` blocks (one slice where the tiles alone reach
    it). A function of the shape alone, and so is the summation order."""
    bn = next((b for b in FWD_BN if o <= b), FWD_BN[-1])
    tiles = n * _cdiv(h, FWD_TILE) * _cdiv(w, FWD_TILE) * _cdiv(o, bn)
    stages = 9 * _cdiv(c, FWD_CK)
    want = max(1, min(_cdiv(_FWD_TARGET_BLOCKS, tiles),
                      stages // _MIN_FWD_SLICE_STAGES))
    per = _cdiv(stages, want)
    return FwdPlan(n, h, w, c, o, bn, per, _cdiv(stages, per))


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
    """Launch the forward on the current stream, on ``fwd_plan``'s tiles
    and slices; raises on any input it does not take and on a failed
    launch. The span ``ric.fwd.launch`` and the counter of that name cover
    the extension's call; the rest of the call is checks, plan and
    allocations."""
    _check("ric_conv_fwd", x, wk, swf)
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    n, h, w, c = x.shape
    o = wk.shape[2]
    plan = fwd_plan(n, h, w, c, o)
    out = torch.empty((n, h, w, o), dtype=torch.float32, device=x.device)
    # wk's B tiles, split into TF32 hi and lo by the launch's pre-pass
    wsplit = torch.empty((plan.o_tiles, plan.stages, 2, plan.bn * FWD_CK),
                         dtype=torch.float32, device=x.device)
    part = out if plan.slices == 1 else torch.empty(
        (plan.slices, n, h, w, o), dtype=torch.float32, device=x.device)
    with profiling.span("ric.fwd.launch"), torch.cuda.device(x.device):
        err = ext.ric_conv_fwd(x.data_ptr(), wk.data_ptr(), swf.data_ptr(),
                               wsplit.data_ptr(), part.data_ptr(),
                               out.data_ptr(), n, h, w, c, o, plan.bn,
                               FWD_CK, plan.slice_stages, plan.slices,
                               _stream())
    _raise_on(ext, "ric_conv_fwd", err)
    profiling.count("ric.fwd.launch")
    return out


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The part wrappers' own checks: f32, contiguous, on one CUDA device
    (``ric_conv_bwd`` checks shapes before it calls them)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous float32 on "
                             f"one CUDA device, got {t.dtype} on {t.device}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def bwd_dz(g: torch.Tensor, swf: torch.Tensor) -> torch.Tensor:
    """Launch the cotangent-sampling kernel: dz (N·H·W, 9, O) from g
    (N,H,W,O) and swf (9,9,H,W)."""
    _require_cuda("ric_conv_bwd (dz)", g, swf)
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    n, h, w, o = g.shape
    dz = torch.empty((n * h * w, 9, o), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        _raise_on(ext, "ric_conv_bwd (dz)", ext.ric_conv_bwd_dz(
            g.data_ptr(), swf.data_ptr(), dz.data_ptr(), n, h, w, o,
            _stream()))
    return dz


def _gemm(ext, name: str, a: torch.Tensor, a_kmajor: bool, b: torch.Tensor,
          part: torch.Tensor, plan: GemmPlan) -> None:
    _raise_on(ext, name, ext.ric_conv_bwd_gemm(
        a.data_ptr(), int(a_kmajor), b.data_ptr(), part.data_ptr(), plan.m,
        plan.n, plan.k, plan.slice_k, plan.slices, GEMM_BM, GEMM_BN, GEMM_BK,
        _stream()))


def bwd_dx(dz: torch.Tensor, wk: torch.Tensor,
           plan: GemmPlan) -> torch.Tensor:
    """Launch dx (P, C) = dz (P, 9·O) · wkᵀ (9·O, C) on the GEMM kernel, and
    the ordered sum of its slices where the plan splits K."""
    _require_cuda("ric_conv_bwd (dx)", dz, wk)
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    wkt = wk.transpose(1, 2).contiguous()       # (9, O, C): B is (9·O, C)
    dx = torch.empty((plan.m, plan.n), dtype=torch.float32, device=dz.device)
    part = dx if plan.slices == 1 else torch.empty(
        (plan.slices, plan.m, plan.n), dtype=torch.float32, device=dz.device)
    with torch.cuda.device(dz.device):
        _gemm(ext, "ric_conv_bwd (dx)", dz, True, wkt, part, plan)
        if plan.slices > 1:
            err = ext.ric_conv_bwd_sum_slices(part.data_ptr(), dx.data_ptr(),
                                              dx.numel(), plan.slices,
                                              _stream())
            _raise_on(ext, "ric_conv_bwd (dx sum)", err)
    return dx


def bwd_dwk(x: torch.Tensor, dz: torch.Tensor,
            plan: GemmPlan) -> torch.Tensor:
    """Launch dwk = xᵀ (C, P) · dz (P, 9·O) on the GEMM kernel into its
    (slices, C, 9·O) partial products, then their ordered sum, permuted to
    (9, C, O)."""
    _require_cuda("ric_conv_bwd (dwk)", x, dz)
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    c, o = plan.m, plan.n // 9
    part = torch.empty((plan.slices, plan.m, plan.n), dtype=torch.float32,
                       device=x.device)
    dwk = torch.empty((9, c, o), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _gemm(ext, "ric_conv_bwd (dwk)", x, False, dz, part, plan)
        _raise_on(ext, "ric_conv_bwd (dwk sum)", ext.ric_conv_bwd_dwk_reduce(
            part.data_ptr(), dwk.data_ptr(), c, o, plan.slices, _stream()))
    return dwk


def ric_conv_bwd(x: torch.Tensor, wk: torch.Tensor, swf: torch.Tensor,
                 g: torch.Tensor, need_dx: bool = True
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Launch the backward on the current stream: the sampled cotangent
    (``bwd_dz``), dx unless ``need_dx`` is false (``bwd_dx``), then dwk
    (``bwd_dwk``), on the plans of ``bwd_plan``, under the spans
    ``ric.bwd.dz``, ``ric.bwd.dx`` and ``ric.bwd.dwk``; counts
    ``ric.bwd.launch``. Returns (dx or None, dwk); raises on any input it
    does not take and on a failed launch."""
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
    dx_plan, dwk_plan = bwd_plan(n, h, w, c, o)
    dx = None
    with torch.cuda.device(x.device):
        with profiling.span("ric.bwd.dz"):
            dz = bwd_dz(g, swf)
        if need_dx:
            with profiling.span("ric.bwd.dx"):
                dx = bwd_dx(dz, wk, dx_plan).view(n, h, w, c)
        with profiling.span("ric.bwd.dwk"):
            dwk = bwd_dwk(x, dz, dwk_plan)
    profiling.count("ric.bwd.launch")
    return dx, dwk


class RICConvFunction(torch.autograd.Function):
    """RIC conv with its VJP: the plain twins on the CPU, the kernels on
    CUDA, under the spans ``ric.fwd`` and ``ric.bwd`` on either. No
    gradient flows to ``swf`` (a constant table)."""

    @staticmethod
    def forward(ctx, x, wk, swf):
        with profiling.span("ric.fwd"):
            ctx.save_for_backward(x, wk, swf)
            if x.device.type == "cpu":
                return ric_conv_reference(x, wk, swf)
            return ric_conv_fwd(x, wk, swf)

    @staticmethod
    def backward(ctx, g):
        with profiling.span("ric.bwd"):
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

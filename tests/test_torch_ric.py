"""PyTorch port: RIC conv tables, plain twins, autograd Function and kernel
wrappers (drawingspinup_torch/models/ric_tables.py, kernels/ric_conv.py)
against the JAX package.

Tolerances: the twin and the JAX formulations sum the same f32 products in
different orders, so the forward agrees to atol = rtol = 2e-5 (the bound
tests/test_ric_pallas.py uses for the Pallas kernel against ``fused``),
and the VJP to atol = rtol = 3e-4 (its bound for the Pallas VJP: dwk sums
N·H·W·9 products per element). The copied numpy tables must be
bit-equal. The CUDA backward's arithmetic (3xTF32 products over fixed
split-K slices, summed in order) is emulated here in numpy on the
planner's slices and held to the same bounds, and to float64 within 1e-5
relative L2 at a dwk that sums 40 960 pixels. The CUDA forward's (f32
sampling, 3xTF32 products into a fresh accumulator per stage, fixed stage
slices summed in order) is emulated the same way on ``fwd_plan``'s slices,
held to the twin and the Pallas forward at 2e-5 and to float64 within 1e-5
relative L2 at K = 9·256 and at C = 6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drawingspinup_tpu.kernels.ric_conv import ric_conv as pallas_ric_conv
from drawingspinup_tpu.models import generator_j as jgen
from drawingspinup_torch.core import profiling
from drawingspinup_torch.kernels import _build
from drawingspinup_torch.kernels import ric_conv as ric_kernels
from drawingspinup_torch.models import ric_tables

TOL = dict(atol=2e-5, rtol=2e-5)


def _launches():
    """(forward, backward) RIC launches counted so far."""
    c = profiling.counters()
    return c["ric.fwd.launch"], c["ric.bwd.launch"]


def _inputs(shape, seed):
    n, h, w, c, o = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wk = (rng.standard_normal((9, c, o)) * 0.1).astype(np.float32)
    return x, wk, ric_tables.ric_shifted_weights(h, w)


def _twin(x, wk, swf):
    return ric_kernels.ric_conv_reference(
        torch.from_numpy(x), torch.from_numpy(wk),
        torch.from_numpy(swf.copy())).numpy()


@pytest.mark.parametrize("hw", [(8, 8), (16, 16), (32, 32), (12, 20)])
@pytest.mark.parametrize("name", ["ric_sample_positions",
                                  "ric_shift_weights",
                                  "ric_shifted_weights"])
def test_tables_equal_jax(name, hw):
    got = getattr(ric_tables, name)(*hw)
    want = getattr(jgen, name)(*hw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not got.flags.writeable       # cached and shared: read-only


@pytest.mark.parametrize("variant", ["fused", "pershift"])
@pytest.mark.parametrize("shape", [(2, 12, 12, 5, 7), (1, 16, 16, 6, 8),
                                   (3, 8, 12, 16, 16)])
def test_reference_matches_jax_ricconv(shape, variant):
    x, wk, swf = _inputs(shape, seed=sum(shape))
    mod = jgen.RICConv(features=shape[-1], variant=variant)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(mod.apply({"params": {"kernel": jnp.asarray(wk)}},
                                    jnp.asarray(x)))
    np.testing.assert_allclose(_twin(x, wk, swf), want, **TOL)


def test_reference_matches_pallas_interpret():
    """The Pallas kernel itself, in interpret mode on the CPU."""
    x, wk, swf = _inputs((2, 8, 8, 4, 8), seed=3)
    want = np.asarray(pallas_ric_conv(jnp.asarray(x), jnp.asarray(wk),
                                      jnp.asarray(swf)))
    np.testing.assert_allclose(_twin(x, wk, swf), want, **TOL)


def _cotangent(shape, seed):
    n, h, w, _, o = shape
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, o)).astype(np.float32)


@pytest.mark.parametrize("shape", [(5, 8, 8, 12, 16), (4, 16, 16, 6, 8),
                                   (3, 8, 8, 16, 16), (5, 32, 32, 4, 8)])
def test_bwd_twin_and_function_match_pallas_vjp(shape):
    """``jax.vjp`` of the Pallas ``ric_conv`` (``_bwd_call``, interpret mode)
    against ``ric_conv_bwd_reference`` and against the gradients of the
    autograd Function. At 32² the Pallas grid walks the batch of 5 one
    image per step, accumulating dwk across steps; at 8² it takes all 5
    images in one step."""
    x, wk, swf = _inputs(shape, seed=sum(shape))
    g = _cotangent(shape, seed=1)
    _, vjp = jax.vjp(lambda a, b: pallas_ric_conv(a, b, jnp.asarray(swf)),
                     jnp.asarray(x), jnp.asarray(wk))
    want_dx, want_dwk = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tol = dict(atol=3e-4, rtol=3e-4)
    dx, dwk = ric_kernels.ric_conv_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(wk),
        torch.from_numpy(swf.copy()), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), want_dx, **tol)
    np.testing.assert_allclose(dwk.numpy(), want_dwk, **tol)
    xt = torch.from_numpy(x).requires_grad_(True)
    wkt = torch.from_numpy(wk).requires_grad_(True)
    ric_kernels.ric_conv(xt, wkt, torch.from_numpy(swf.copy())).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **tol)
    np.testing.assert_allclose(wkt.grad.numpy(), want_dwk, **tol)


@pytest.mark.parametrize("needs_dx", [True, False])
def test_function_matches_autograd_of_twin(needs_dx, monkeypatch):
    """The Function's backward against autograd through
    ``ric_conv_reference``, at 2e-5; without an input gradient no dx is
    computed."""
    shape = (2, 12, 20, 5, 7)
    x, wk, swf = _inputs(shape, seed=2)
    g = torch.from_numpy(_cotangent(shape, seed=3))
    swf_t = torch.from_numpy(swf.copy())
    calls = []
    bwd = ric_kernels.ric_conv_bwd_reference
    monkeypatch.setattr(ric_kernels, "ric_conv_bwd_reference",
                        lambda *a: calls.append(a[4]) or bwd(*a))
    x1, wk1 = torch.from_numpy(x).requires_grad_(needs_dx), \
        torch.from_numpy(wk).requires_grad_(True)
    ric_kernels.ric_conv(x1, wk1, swf_t).backward(g)
    x2, wk2 = torch.from_numpy(x).requires_grad_(needs_dx), \
        torch.from_numpy(wk).requires_grad_(True)
    ric_kernels.ric_conv_reference(x2, wk2, swf_t).backward(g)
    assert calls == [needs_dx]
    np.testing.assert_allclose(wk1.grad.numpy(), wk2.grad.numpy(), **TOL)
    if needs_dx:
        np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), **TOL)
    else:
        assert x1.grad is None


def test_cpu_tensor_runs_twin_and_launches_nothing():
    x, wk, swf = _inputs((1, 8, 8, 3, 4), seed=5)
    wkt = torch.from_numpy(wk).requires_grad_(True)
    got = ric_kernels.ric_conv(torch.from_numpy(x), wkt,
                               torch.from_numpy(swf.copy()))
    np.testing.assert_array_equal(got.detach().numpy(), _twin(x, wk, swf))
    got.sum().backward()
    assert _launches() == (0, 0)
    assert _build._ext is None


@pytest.mark.parametrize("wrapper", ["fwd", "bwd"])
@pytest.mark.parametrize("case", ["cpu", "dtype", "x_rank", "wk_shape",
                                  "swf_shape", "noncontig"])
def test_kernel_wrapper_rejects_before_build(case, wrapper):
    """ric_conv_fwd and ric_conv_bwd check their inputs before they build
    or launch anything; a CPU tensor is refused, never computed."""
    x = torch.zeros(1, 8, 8, 4)
    wk = torch.zeros(9, 4, 6)
    swf = torch.zeros(9, 9, 8, 8)
    if case == "dtype":
        x = x.double()
    elif case == "x_rank":
        x = x[0]
    elif case == "wk_shape":
        wk = torch.zeros(9, 5, 6)
    elif case == "swf_shape":
        swf = torch.zeros(9, 9, 8, 7)
    elif case == "noncontig":
        x = torch.zeros(1, 8, 4, 8).transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        if wrapper == "fwd":
            ric_kernels.ric_conv_fwd(x, wk, swf)
        else:
            ric_kernels.ric_conv_bwd(x, wk, swf, torch.zeros(1, 8, 8, 6))
    assert _launches() == (0, 0)
    assert _build._ext is None


# (H = W, C, O) of the RIC convs of a stage-1 training step on 40 × 32²
# patches (chip_smoke.py's TRAIN_SHAPES)
TRAIN_SHAPES = [(32, 6, 32), (16, 32, 64), (8, 64, 128), (8, 128, 128),
                (16, 256, 128), (32, 192, 128), (32, 166, 64), (32, 64, 64)]
# the CUDA tests' ragged (N, H, W, C, O) shapes
ODD_SHAPES = [(2, 12, 20, 21, 7), (1, 9, 17, 5, 40), (3, 16, 16, 64, 128),
              (4, 8, 8, 128, 130), (2, 32, 32, 166, 64), (1, 1, 1, 3, 33)]


@pytest.mark.parametrize(
    "shape", [(40, hw, hw, c, o) for hw, c, o in TRAIN_SHAPES]
    + [(4, hw, hw, c, o) for hw, c, o in TRAIN_SHAPES] + ODD_SHAPES)
def test_bwd_plan_slices_cover_k_in_order(shape):
    """Each GEMM's split-K slices are whole stages, non-empty, contiguous
    from 0 to K in index order, and the same for the same shape; at the
    training batch every launch fills the H100's 132 SMs."""
    n, h, w, c, o = shape
    p, j = n * h * w, 9 * o
    dx_plan, dwk_plan = ric_kernels.bwd_plan(*shape)
    assert (dx_plan, dwk_plan) == ric_kernels.bwd_plan(*shape)
    for plan, mnk in ((dx_plan, (p, c, j)), (dwk_plan, (c, j, p))):
        assert (plan.m, plan.n, plan.k) == mnk
        bounds = plan.bounds()
        assert len(bounds) == plan.slices == plan.grid[2] >= 1
        assert bounds[0][0] == 0 and bounds[-1][1] == plan.k
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(k0 < k1 and k0 % ric_kernels.GEMM_BK == 0
                   for k0, k1 in bounds)
        if n == 40:
            assert plan.blocks >= ric_kernels.SMS, (plan, plan.blocks)


def _rna_tf32(a):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits (the low 13 bits cleared)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _emulated_gemm(a, b, plan, split=True):
    """The GEMM kernel's arithmetic: per 8-deep k-step, lo·hi + hi·lo +
    hi·hi of the TF32 splits (hi·hi alone without ``split``) in f32, added
    in order to its K slice's f32 sum; the slices' partial products added
    in the planner's order."""
    kp = -(-plan.k // 8) * 8                    # K zero-filled to whole k-steps
    a = np.pad(a, ((0, 0), (0, kp - plan.k)))
    b = np.pad(b, ((0, kp - plan.k), (0, 0)))
    ah, bh = _rna_tf32(a), _rna_tf32(b)
    al, bl = _rna_tf32(a - ah), _rna_tf32(b - bh)

    def steps(x, y):                            # (k-steps, m, n) products
        return np.einsum("msk,skn->smn", x.reshape(plan.m, -1, 8),
                         y.reshape(-1, 8, plan.n))

    part = steps(ah, bh)
    if split:
        part = (steps(al, bh) + steps(ah, bl)) + part
    out = np.zeros((plan.m, plan.n), np.float32)
    for k0, k1 in plan.bounds():
        acc = np.zeros_like(out)
        for step in part[k0 // 8:-(-k1 // 8)]:
            acc = acc + step
        out = out + acc
    return out


def _emulated_bwd(x, wk, swf, g, split=True):
    """dx and dwk as the CUDA backward computes them: dz from the twin's
    sampling, then the two products on ``bwd_plan``'s slices."""
    n, h, w, c = x.shape
    o = wk.shape[2]
    dz = ric_kernels.ric_conv_bwd_dz_reference(
        torch.from_numpy(g), torch.from_numpy(swf.copy())).numpy()
    dz = dz.reshape(n * h * w, 9 * o)
    dx_plan, dwk_plan = ric_kernels.bwd_plan(n, h, w, c, o)
    wkt = np.ascontiguousarray(wk.transpose(0, 2, 1)).reshape(9 * o, c)
    dx = _emulated_gemm(dz, wkt, dx_plan, split).reshape(n, h, w, c)
    part = _emulated_gemm(np.ascontiguousarray(x.reshape(-1, c).T), dz,
                          dwk_plan, split)
    return dx, part.reshape(c, 9, o).transpose(1, 0, 2)


@pytest.mark.parametrize("shape", [(5, 8, 8, 12, 16), (4, 16, 16, 6, 8),
                                   (3, 8, 8, 16, 16), (5, 32, 32, 4, 8)])
def test_emulated_3xtf32_bwd_matches_twin_and_pallas_vjp(shape):
    """The CUDA backward's arithmetic against ``ric_conv_bwd_reference``
    and the Pallas VJP (interpret mode), at the Pallas-VJP bound."""
    x, wk, swf = _inputs(shape, seed=sum(shape))
    g = _cotangent(shape, seed=1)
    _, vjp = jax.vjp(lambda a, b: pallas_ric_conv(a, b, jnp.asarray(swf)),
                     jnp.asarray(x), jnp.asarray(wk))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    twin = ric_kernels.ric_conv_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(wk),
        torch.from_numpy(swf.copy()), torch.from_numpy(g))
    tol = dict(atol=3e-4, rtol=3e-4)
    for got, jax_ref, ref in zip(_emulated_bwd(x, wk, swf, g), want, twin):
        np.testing.assert_allclose(got, ref.numpy(), **tol)
        np.testing.assert_allclose(got, jax_ref, **tol)


def test_emulated_3xtf32_dwk_matches_float64_over_40960_pixels():
    """At conv0's training shape (40 × 32², dwk's K = 40 960) the 3xTF32
    products sit within 1e-5 relative L2 of float64, dx too; TF32 alone
    (hi·hi) does not."""
    shape = (40, 32, 32, 6, 8)
    x, wk, swf = _inputs(shape, seed=7)
    g = _cotangent(shape, seed=8)
    assert ric_kernels.bwd_plan(*shape)[1].k == 40960
    want = ric_kernels.ric_conv_bwd_reference(
        *(torch.from_numpy(a).double() for a in (x, wk, swf.copy(), g)))

    def rel(got, ref):
        ref = ref.numpy()
        return np.linalg.norm(got - ref) / np.linalg.norm(ref)

    dx, dwk = _emulated_bwd(x, wk, swf, g)
    assert rel(dwk, want[1]) <= 1e-5 and rel(dx, want[0]) <= 1e-5
    assert rel(_emulated_bwd(x, wk, swf, g, split=False)[1], want[1]) > 1e-5


@pytest.mark.parametrize("part", ["dz", "dx", "dwk"])
def test_bwd_parts_reject_cpu_tensors_before_build(part):
    """Each part of the CUDA backward refuses a CPU tensor, never computes
    it, and builds nothing."""
    x, wk = torch.zeros(1, 8, 8, 4), torch.zeros(9, 4, 6)
    dz = torch.zeros(64, 9, 6)
    dx_plan, dwk_plan = ric_kernels.bwd_plan(1, 8, 8, 4, 6)
    with pytest.raises(ValueError):
        if part == "dz":
            ric_kernels.bwd_dz(torch.zeros(1, 8, 8, 6),
                               torch.zeros(9, 9, 8, 8))
        elif part == "dx":
            ric_kernels.bwd_dx(dz, wk, dx_plan)
        else:
            ric_kernels.bwd_dwk(x, dz, dwk_plan)
    assert _build._ext is None


@pytest.mark.parametrize(
    "shape", [(40, hw, hw, c, o) for hw, c, o in TRAIN_SHAPES]
    + [(4, hw, hw, c, o) for hw, c, o in TRAIN_SHAPES] + ODD_SHAPES)
def test_fwd_plan_tiles_cover_pixels_and_slices_cover_k(shape):
    """The forward's 8×8 tiles cover every pixel of every image once, its
    output tiles every output, its stage slices the 9·ceil(C / 32) stages
    contiguously from 0 in index order; the plan is the same for the same
    shape, and at the training batch every launch fills the 132 SMs."""
    n, h, w, c, o = shape
    plan = ric_kernels.fwd_plan(*shape)
    assert plan == ric_kernels.fwd_plan(*shape)
    assert (plan.n, plan.h, plan.w, plan.c, plan.o) == shape
    assert plan.bn in ric_kernels.FWD_BN
    assert plan.o_tiles * plan.bn >= o > (plan.o_tiles - 1) * plan.bn
    tile = ric_kernels.FWD_TILE
    seen = np.zeros((n, h, w), np.int64)
    for bx in range(plan.grid[0]):
        img, y0, x0 = plan.tile_origin(bx)
        assert img < n and y0 < h and x0 < w
        seen[img, y0:y0 + tile, x0:x0 + tile] += 1
    assert (seen == 1).all()
    assert plan.stages == 9 * -(-c // ric_kernels.FWD_CK)
    bounds = plan.bounds()
    assert len(bounds) == plan.slices == plan.grid[2] >= 1
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.stages
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(s0 < s1 for s0, s1 in bounds)
    assert plan.grid[1] == plan.o_tiles
    if n == 40:
        assert plan.blocks >= ric_kernels.SMS, (plan, plan.blocks)


FWD_SHAPES = [(2, 8, 8, 4, 8), (1, 12, 20, 5, 7), (3, 8, 12, 16, 16),
              (2, 16, 16, 40, 130)]


@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_sample_reference_times_wk_matches_twin_and_pallas(shape):
    """U · Wk, with U from ``ric_conv_sample_reference``, against
    ``ric_conv_reference`` and the Pallas ``ric_conv`` (interpret mode)."""
    n, h, w, c, o = shape
    x, wk, swf = _inputs(shape, seed=sum(shape))
    u = ric_kernels.ric_conv_sample_reference(torch.from_numpy(x),
                                              torch.from_numpy(swf.copy()))
    assert tuple(u.shape) == (n, h, w, 9, c)
    got = (u.reshape(-1, 9 * c) @ torch.from_numpy(wk).reshape(9 * c, o)
           ).reshape(n, h, w, o).numpy()
    np.testing.assert_allclose(got, _twin(x, wk, swf), **TOL)
    want = np.asarray(pallas_ric_conv(jnp.asarray(x), jnp.asarray(wk),
                                      jnp.asarray(swf)))
    np.testing.assert_allclose(got, want, **TOL)


def _shift(a, sy, sx):
    """out[:, a, b] = a[:, a+sy, b+sx], zero outside (rows and columns are
    axes 1 and 2)."""
    out = np.zeros_like(a)
    h, w = a.shape[1], a.shape[2]
    ys, xs = slice(max(0, -sy), min(h, h - sy)), slice(max(0, -sx),
                                                      min(w, w - sx))
    yd, xd = slice(max(0, sy), min(h, h + sy)), slice(max(0, sx),
                                                     min(w, w + sx))
    out[:, ys, xs] = a[:, yd, xd]
    return out


def _emulated_fwd(x, wk, swf, split=True):
    """The CUDA forward's arithmetic: U sampled in f32 in the kernel's
    order (tap 4 from the center shift alone); per stage (one tap of one
    32-channel chunk, k-steps of 8 channels) lo·hi, hi·lo and hi·hi of the
    TF32 splits (hi·hi alone without ``split``) added in order into a fresh
    f32 accumulator, which is added to its slice's f32 sum; the slices'
    partial products added in ``fwd_plan``'s order."""
    n, h, w, c = x.shape
    o = wk.shape[2]
    plan = ric_kernels.fwd_plan(n, h, w, c, o)
    ck = ric_kernels.FWD_CK
    xs = [_shift(x, sy, sx) for sy, sx in ric_tables.SHIFTS]
    ws = [_shift(swf[i], sy, sx)                       # (9 taps, H, W)
          for i, (sy, sx) in enumerate(ric_tables.SHIFTS)]
    u = np.zeros((9, n, h, w, c), np.float32)
    for t in range(9):
        for i in ([4] if t == 4 else range(9)):
            u[t] = u[t] + ws[i][t][None, :, :, None] * xs[i]
    u = u.reshape(9, -1, c)
    split_tf32 = (lambda a: (_rna_tf32(a), _rna_tf32(a - _rna_tf32(a))))
    out = np.zeros((n * h * w, o), np.float32)
    for s0, s1 in plan.bounds():
        acc = np.zeros_like(out)
        for s in range(s0, s1):
            chunk, t = divmod(s, 9)
            c0 = chunk * ck
            depth = min(ck, -(-(c - c0) // 8) * 8)
            a = np.zeros((n * h * w, depth), np.float32)
            b = np.zeros((depth, o), np.float32)
            a[:, :min(depth, c - c0)] = u[t][:, c0:c0 + depth]
            b[:min(depth, c - c0)] = wk[t, c0:c0 + depth]
            (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
            fresh = np.zeros_like(out)
            for k in range(0, depth, 8):
                kk = slice(k, k + 8)
                for pa, pb in (((al, bh), (ah, bl)) if split else ()) + (
                        (ah, bh),):
                    fresh = fresh + pa[:, kk] @ pb[kk]
            acc = acc + fresh
        out = out + acc
    return out.reshape(n, h, w, o)


@pytest.mark.parametrize("shape", FWD_SHAPES + [(40, 8, 8, 64, 16)])
def test_emulated_3xtf32_fwd_matches_twin_and_pallas(shape):
    """The CUDA forward's arithmetic against the twin and the Pallas forward
    (interpret mode) at 2e-5; the last shape cuts K into slices."""
    x, wk, swf = _inputs(shape, seed=sum(shape) + 1)
    got = _emulated_fwd(x, wk, swf)
    np.testing.assert_allclose(got, _twin(x, wk, swf), **TOL)
    want = np.asarray(pallas_ric_conv(jnp.asarray(x), jnp.asarray(wk),
                                      jnp.asarray(swf)))
    np.testing.assert_allclose(got, want, **TOL)
    if shape[0] == 40:
        assert ric_kernels.fwd_plan(*shape).slices > 1


@pytest.mark.parametrize("shape", [(2, 8, 8, 256, 16), (2, 16, 16, 6, 32)])
def test_emulated_3xtf32_fwd_matches_float64(shape):
    """At upconv2's C (K = 9·256) and conv0's C = 6 the emulated forward sits
    within 1e-5 relative L2 of the twin in float64; TF32 alone (hi·hi) does
    not."""
    x, wk, swf = _inputs(shape, seed=11)
    want = ric_kernels.ric_conv_reference(
        *(torch.from_numpy(a).double() for a in (x, wk, swf.copy()))).numpy()

    def rel(got):
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    assert rel(_emulated_fwd(x, wk, swf)) <= 1e-5
    assert rel(_emulated_fwd(x, wk, swf, split=False)) > 1e-5

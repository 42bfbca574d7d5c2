"""PyTorch port on the GPU: the hand-written RIC conv kernels (forward and
backward) against their plain PyTorch twins, alone and inside
GeneratorJ_RIC.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ric_cuda.py

Tolerances: the forward within 1e-4 of the largest output, the
summation-order error of f32 sums of up to 9·C products (the kernel
samples first and multiplies second; the twin multiplies first), and
within relative L2 1e-5 of the twin run in float64, which plain TF32
misses. The
backward within 3e-4 of the largest twin output, the bound
tests/test_ric_pallas.py sets for the Pallas VJP: dwk sums up to N·H·W·9
products per element."""

import contextlib
import copy

import numpy as np
import pytest
import torch

from drawingspinup_torch.core import profiling
from drawingspinup_torch.kernels import ric_conv as ric_kernels
from drawingspinup_torch.models import generator_j as tgen
from drawingspinup_torch.models import ric_tables
from drawingspinup_torch.train import gan

REL_TOL = 1e-4
BWD_REL_TOL = 3e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    """(forward, backward) RIC launches counted so far."""
    c = profiling.counters()
    return c["ric.fwd.launch"], c["ric.bwd.launch"]


def _inputs(shape, seed, device):
    n, h, w, c, o = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wk = (rng.standard_normal((9, c, o)) * 0.1).astype(np.float32)
    swf = ric_tables.ric_shifted_weights(h, w).copy()
    return tuple(torch.from_numpy(a).to(device) for a in (x, wk, swf))


# (H = W, C, O) of the RIC convs of a stage-1 training step on 32² patches
# (chip_smoke.py's TRAIN_SHAPES), here at N = 4
TRAIN_SHAPES = [(32, 6, 32), (16, 32, 64), (8, 64, 128), (8, 128, 128),
                (16, 256, 128), (32, 192, 128), (32, 166, 64), (32, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 20, 21, 7), (1, 9, 17, 5, 40),
                                   (1, 32, 32, 166, 64),
                                   (3, 16, 16, 64, 128), (1, 1, 1, 3, 33)]
                         + [(4, hw, hw, c, o) for hw, c, o in TRAIN_SHAPES]
                         + [(1, 512, 512, 192, 128)])
def test_kernel_matches_twin(shape, cuda_device):
    """Ragged tiles (H, W not multiples of the 8×8 tile), channel counts
    off the 32-channel chunk and its 16-byte copies, O off the output
    widths and tiled past them, batch > 1, a 1×1 image, every training
    shape and upconv1's 512² serving shape."""
    x, wk, swf = _inputs(shape, 11, cuda_device)
    want = ric_kernels.ric_conv_reference(x, wk, swf)
    before = profiling.counters()["ric.fwd.launch"]
    got = ric_kernels.ric_conv(x, wk, swf)
    torch.cuda.synchronize()
    assert profiling.counters()["ric.fwd.launch"] == before + 1
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), err


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    x, wk, swf = _inputs((1, 40, 40, 48, 64), 2, cuda_device)
    a = ric_kernels.ric_conv(x, wk, swf)
    b = ric_kernels.ric_conv(x, wk, swf)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_fwd_split_k_is_bit_identical_at_8x8(cuda_device):
    """At the resnet convs' 8² training shape the forward's stages are cut
    into slices; two launches give identical bits."""
    shape = (40, 8, 8, 128, 128)
    x, wk, swf = _inputs(shape, 9, cuda_device)
    assert ric_kernels.fwd_plan(*shape).slices > 1
    a = ric_kernels.ric_conv_fwd(x, wk, swf)
    b = ric_kernels.ric_conv_fwd(x, wk, swf)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 32, 32, 6, 32), (4, 16, 16, 256, 128),
                                   (40, 8, 8, 128, 128)])
def test_fwd_is_f32_accurate_where_plain_tf32_is_not(shape, cuda_device):
    """The forward within relative L2 1e-5 of the twin run in float64 (K =
    9·256 at upconv2's C, conv0's C = 6, split K at 8²); the same product on
    TF32-rounded operands, as a plain TF32 kernel would take them, misses
    that limit."""
    n, h, w, c, o = shape
    x, wk, swf = _inputs(shape, 10, cuda_device)
    want = ric_kernels.ric_conv_reference(x.double(), wk.double(),
                                          swf.double())
    got = ric_kernels.ric_conv_fwd(x, wk, swf)
    u = ric_kernels.ric_conv_sample_reference(x, swf).view(-1, 9 * c)
    tf32 = (_rna_tf32(u).double() @ _rna_tf32(wk.view(9 * c, o)).double())
    assert (got.double() - want).norm() <= 1e-5 * want.norm()
    assert (tf32.view(want.shape) - want).norm() > 1e-5 * want.norm()


@pytest.mark.cuda
def test_fwd_launch_refuses_a_foreign_plan(cuda_device):
    """The forward's launcher takes only its own output widths and chunk,
    and slices that cover the stages exactly."""
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    shape = (1, 8, 8, 32, 32)
    x, wk, swf = _inputs(shape, 0, cuda_device)
    plan = ric_kernels.fwd_plan(*shape)
    wsplit = torch.empty(4 * plan.stages * 2 * 128 * ric_kernels.FWD_CK,
                         device=cuda_device)
    out = torch.empty((1, 8, 8, 32), device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(bn, ck, slice_stages, slices):
        return ext.ric_conv_fwd(x.data_ptr(), wk.data_ptr(), swf.data_ptr(),
                                wsplit.data_ptr(), out.data_ptr(),
                                out.data_ptr(), 1, 8, 8, 32, 32, bn, ck,
                                slice_stages, slices, stream)

    assert launch(plan.bn, ric_kernels.FWD_CK, 9, 1) == 0
    torch.cuda.synchronize()
    want = ric_kernels.ric_conv_reference(x, wk, swf)
    assert (out - want).abs().max() <= REL_TOL * want.abs().max()
    assert launch(48, ric_kernels.FWD_CK, 9, 1) != 0
    assert launch(plan.bn, 16, 9, 1) != 0
    assert launch(plan.bn, ric_kernels.FWD_CK, 9, 2) != 0   # a slice past K
    assert launch(plan.bn, ric_kernels.FWD_CK, 4, 2) != 0   # K not covered


@pytest.mark.cuda
def test_cpu_tensor_runs_twin_and_builds_nothing(cuda_device, monkeypatch):
    """With a card present, CPU tensors still take the plain twins forward
    and backward, and nothing is built or launched."""
    from drawingspinup_torch.kernels import _build

    def refuse():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "extension", refuse)
    x, wk, swf = _inputs((2, 12, 20, 5, 7), 4, torch.device("cpu"))
    wk.requires_grad_(True)
    before = _launches()
    got = ric_kernels.ric_conv(x, wk, swf)
    assert torch.equal(got.detach(), ric_kernels.ric_conv_reference(x, wk,
                                                                    swf))
    got.sum().backward()
    assert wk.grad is not None
    assert _launches() == before


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    x, wk, swf = _inputs((1, 8, 8, 4, 4), 0, cuda_device)
    with pytest.raises(ValueError):
        ric_kernels.ric_conv(x, wk.cpu(), swf)


@contextlib.contextmanager
def _plain_ric_convs():
    kernel = ric_kernels.ric_conv
    ric_kernels.ric_conv = ric_kernels.ric_conv_reference
    try:
        yield
    finally:
        ric_kernels.ric_conv = kernel


@pytest.mark.cuda
def test_generator_ric_kernel_path_matches_plain_path(cuda_device):
    """A 7-block, full-width GeneratorJ_RIC on a 64² input: 21 launches,
    output within 1e-3 of the plain path (tanh outputs after 21 layers of
    reordered f32 sums)."""
    model = gan.build_generator(gan.GANConfig(), cuda_device,
                                torch.Generator(cuda_device).manual_seed(0))
    g = torch.Generator(cuda_device).manual_seed(1)
    x = torch.rand((1, 64, 64, 6), generator=g, device=cuda_device) * 2 - 1
    before = profiling.counters()["ric.fwd.launch"]
    with torch.no_grad():
        got = model(x)
        with _plain_ric_convs():
            want = model(x)
    torch.cuda.synchronize()
    assert profiling.counters()["ric.fwd.launch"] == before + 21
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-3


def _cotangent(shape, seed, device):
    n, h, w, _, o = shape
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((n, h, w, o)).astype(np.float32)).to(device)


def _assert_close(got, want):
    err = (got - want).abs().max().item()
    assert err <= BWD_REL_TOL * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 20, 21, 7), (1, 9, 17, 5, 40),
                                   (3, 16, 16, 64, 128), (4, 8, 8, 128, 130),
                                   (2, 32, 32, 166, 64), (1, 1, 1, 3, 33)]
                         + [(4, hw, hw, c, o) for hw, c, o in TRAIN_SHAPES])
def test_bwd_kernel_matches_twin(shape, cuda_device):
    """Ragged tiles, C and O off the GEMM's 64-wide tiles and its 16-byte
    copies (C = 5, 6, 21, 166; O = 7), N > 1, a 1×1 image, and every
    training shape; the sampled cotangent against its twin too; one launch
    counted per call."""
    x, wk, swf = _inputs(shape, 12, cuda_device)
    g = _cotangent(shape, 13, cuda_device)
    want_dx, want_dwk = ric_kernels.ric_conv_bwd_reference(x, wk, swf, g)
    before = profiling.counters()["ric.bwd.launch"]
    dx, dwk = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    torch.cuda.synchronize()
    assert profiling.counters()["ric.bwd.launch"] == before + 1
    _assert_close(dx, want_dx)
    _assert_close(dwk, want_dwk)
    dz = ric_kernels.bwd_dz(g, swf)
    want_dz = ric_kernels.ric_conv_bwd_dz_reference(g, swf)
    _assert_close(dz.view(want_dz.shape), want_dz)


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic(cuda_device):
    """dwk is a reduction over 40·32·32 pixels in fixed slices: two
    launches give identical bits."""
    shape = (40, 32, 32, 64, 64)
    x, wk, swf = _inputs(shape, 3, cuda_device)
    g = _cotangent(shape, 4, cuda_device)
    assert ric_kernels.bwd_plan(*shape)[1].slices > 1
    dx_a, dwk_a = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    dx_b, dwk_b = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    assert torch.equal(dwk_a, dwk_b) and torch.equal(dx_a, dx_b)


@pytest.mark.cuda
def test_bwd_split_k_is_bit_identical_at_8x8(cuda_device):
    """At the resnet convs' 8² training shape both products are cut into
    split-K slices; two launches give identical bits."""
    shape = (40, 8, 8, 128, 128)
    x, wk, swf = _inputs(shape, 5, cuda_device)
    g = _cotangent(shape, 6, cuda_device)
    assert all(p.slices > 1 for p in ric_kernels.bwd_plan(*shape))
    dx_a, dwk_a = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    dx_b, dwk_b = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    assert torch.equal(dx_a, dx_b) and torch.equal(dwk_a, dwk_b)


def _rna_tf32(t):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits (the low 13 bits cleared)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 32, 32, 6, 32), (40, 8, 8, 128, 128)])
def test_bwd_is_f32_accurate_where_plain_tf32_is_not(shape, cuda_device):
    """dx and dwk within relative L2 1e-5 of the twin run in float64 (dwk
    sums 40 960 pixels at conv0's shape); the same products on TF32-rounded
    operands, as a plain TF32 kernel would take them, miss that limit."""
    n, h, w, c, o = shape
    x, wk, swf = _inputs(shape, 7, cuda_device)
    g = _cotangent(shape, 8, cuda_device)
    want = ric_kernels.ric_conv_bwd_reference(
        *(t.double() for t in (x, wk, swf, g)))
    got = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    dz = _rna_tf32(ric_kernels.bwd_dz(g, swf).view(-1, 9 * o)).double()
    wkt = wk.transpose(1, 2).reshape(9 * o, c)
    tf32 = (dz @ _rna_tf32(wkt).double(),
            (_rna_tf32(x.view(-1, c)).double().t() @ dz).view(c, 9, o)
            .permute(1, 0, 2))
    for a, t, b in zip(got, tf32, want):
        assert (a.double() - b).norm() <= 1e-5 * b.norm()
        assert (t.reshape(b.shape) - b).norm() > 1e-5 * b.norm()


@pytest.mark.cuda
def test_gemm_launch_refuses_a_foreign_plan(cuda_device):
    """The GEMM launcher takes only its own tile sizes and K slices that
    are whole stages covering K exactly."""
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    a = torch.ones((64, 32), device=cuda_device)
    b = torch.ones((32, 64), device=cuda_device)
    out = torch.empty((64, 64), device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(bm, slice_k, slices):
        return ext.ric_conv_bwd_gemm(
            a.data_ptr(), 1, b.data_ptr(), out.data_ptr(), 64, 64, 32,
            slice_k, slices, bm, ric_kernels.GEMM_BN, ric_kernels.GEMM_BK,
            stream)

    assert launch(ric_kernels.GEMM_BM, 32, 1) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 32.0))
    assert launch(2 * ric_kernels.GEMM_BM, 32, 1) != 0
    assert launch(ric_kernels.GEMM_BM, 32, 2) != 0     # a slice past K
    assert launch(ric_kernels.GEMM_BM, 16, 2) != 0     # not a whole stage


@pytest.mark.cuda
def test_autograd_skips_dx_when_input_needs_none(cuda_device):
    shape = (2, 16, 16, 6, 32)
    x, wk, swf = _inputs(shape, 5, cuda_device)
    g = _cotangent(shape, 6, cuda_device)
    wk.requires_grad_(True)
    before = profiling.counters()["ric.bwd.launch"]
    ric_kernels.ric_conv(x, wk, swf).backward(g)
    assert profiling.counters()["ric.bwd.launch"] == before + 1
    assert x.grad is None
    _, want = ric_kernels.ric_conv_bwd_reference(x, wk.detach(), swf, g,
                                                 need_dx=False)
    _assert_close(wk.grad, want)
    dx, dwk = ric_kernels.ric_conv_bwd(x, wk.detach(), swf, g, need_dx=False)
    assert dx is None and torch.equal(dwk, wk.grad)


@pytest.mark.cuda
def test_generator_ric_train_backward_on_card(cuda_device):
    """A full-width GeneratorJ_RIC in training mode on 4 × 32² patches: 22
    forward and 21 backward launches; every RIC kernel on the loss's path
    gets a finite, nonzero gradient within relative L2 error 1e-2 of the
    plain path's, run in float64; smooth0's output is dropped, so it gets
    none. The bound sits above this step's rounding floor: a random 1e-6
    relative perturbation of the RIC outputs flips ReLU and max-pool
    decisions and moves these gradients by up to ~3e-3."""
    model = gan.build_models(gan.GANConfig(), cuda_device,
                             torch.Generator(cuda_device).manual_seed(0))[0]
    g = torch.Generator(cuda_device).manual_seed(1)
    x = torch.rand((4, 32, 32, 6), generator=g, device=cuda_device) * 2 - 1
    ref = copy.deepcopy(model).double()
    fwd, bwd = _launches()
    model(x).square().mean().backward()
    torch.cuda.synchronize()
    assert profiling.counters()["ric.fwd.launch"] == fwd + 22
    assert profiling.counters()["ric.bwd.launch"] == bwd + 21
    got = {n: m.kernel.grad for n, m in model.named_modules()
           if isinstance(m, tgen.RICConv) and m.kernel.grad is not None}
    assert model.smooth0.kernel.grad is None and len(got) == 21
    with _plain_ric_convs():
        ref(x.double()).square().mean().backward()
    for name, grad in got.items():
        want = getattr(ref, name).kernel.grad
        assert torch.isfinite(grad).all() and grad.abs().max() > 0, name
        err = (grad.double() - want).norm().item()
        assert err <= 1e-2 * want.norm().item(), (name, err)

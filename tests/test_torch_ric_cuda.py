"""PyTorch port on the GPU: the hand-written RIC conv kernels (forward and
backward) against their plain PyTorch twins, alone and inside
GeneratorJ_RIC.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ric_cuda.py

Tolerances: the forward within 1e-4 of the largest output, the
summation-order error of f32 sums of up to 9·C products (the kernel
samples first and multiplies second; the twin multiplies first). The
backward within 3e-4 of the largest twin output, the bound
tests/test_ric_pallas.py sets for the Pallas VJP: dwk sums up to N·H·W·9
products per element."""

import contextlib
import copy

import numpy as np
import pytest
import torch

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


def _inputs(shape, seed, device):
    n, h, w, c, o = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wk = (rng.standard_normal((9, c, o)) * 0.1).astype(np.float32)
    swf = ric_tables.ric_shifted_weights(h, w).copy()
    return tuple(torch.from_numpy(a).to(device) for a in (x, wk, swf))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 20, 21, 7), (1, 9, 17, 5, 40),
                                   (1, 32, 32, 166, 64),
                                   (3, 16, 16, 64, 128), (1, 1, 1, 3, 33)])
def test_kernel_matches_twin(shape, cuda_device):
    """Ragged tiles (H, W not multiples of the 8×16 tile), channel counts
    off the 16-channel chunk, O off the 4-wide register tile and across
    both output tilings, batch > 1, a 1×1 image."""
    x, wk, swf = _inputs(shape, 11, cuda_device)
    want = ric_kernels.ric_conv_reference(x, wk, swf)
    before = ric_kernels.LAUNCHES
    got = ric_kernels.ric_conv(x, wk, swf)
    torch.cuda.synchronize()
    assert ric_kernels.LAUNCHES == before + 1
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), err


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    x, wk, swf = _inputs((1, 40, 40, 48, 64), 2, cuda_device)
    a = ric_kernels.ric_conv(x, wk, swf)
    b = ric_kernels.ric_conv(x, wk, swf)
    assert torch.equal(a, b)


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
    before = ric_kernels.LAUNCHES
    with torch.no_grad():
        got = model(x)
        with _plain_ric_convs():
            want = model(x)
    torch.cuda.synchronize()
    assert ric_kernels.LAUNCHES == before + 21
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
                                   (2, 32, 32, 166, 64), (1, 1, 1, 3, 33)])
def test_bwd_kernel_matches_twin(shape, cuda_device):
    """Ragged tiles, C and O off the 16/64-channel chunks, N > 1, a 1×1
    image; one launch counted per call."""
    x, wk, swf = _inputs(shape, 12, cuda_device)
    g = _cotangent(shape, 13, cuda_device)
    want_dx, want_dwk = ric_kernels.ric_conv_bwd_reference(x, wk, swf, g)
    before = ric_kernels.BWD_LAUNCHES
    dx, dwk = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    torch.cuda.synchronize()
    assert ric_kernels.BWD_LAUNCHES == before + 1
    _assert_close(dx, want_dx)
    _assert_close(dwk, want_dwk)


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic(cuda_device):
    """dwk is a reduction over 40·32·32 pixels in fixed slices: two
    launches give identical bits."""
    shape = (40, 32, 32, 64, 64)
    x, wk, swf = _inputs(shape, 3, cuda_device)
    g = _cotangent(shape, 4, cuda_device)
    assert ric_kernels.dwk_slices(*shape) > 1
    dx_a, dwk_a = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    dx_b, dwk_b = ric_kernels.ric_conv_bwd(x, wk, swf, g)
    assert torch.equal(dwk_a, dwk_b) and torch.equal(dx_a, dx_b)


@pytest.mark.cuda
def test_autograd_skips_dx_when_input_needs_none(cuda_device):
    shape = (2, 16, 16, 6, 32)
    x, wk, swf = _inputs(shape, 5, cuda_device)
    g = _cotangent(shape, 6, cuda_device)
    wk.requires_grad_(True)
    before = ric_kernels.BWD_LAUNCHES
    ric_kernels.ric_conv(x, wk, swf).backward(g)
    assert ric_kernels.BWD_LAUNCHES == before + 1
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
    fwd, bwd = ric_kernels.LAUNCHES, ric_kernels.BWD_LAUNCHES
    model(x).square().mean().backward()
    torch.cuda.synchronize()
    assert ric_kernels.LAUNCHES == fwd + 22
    assert ric_kernels.BWD_LAUNCHES == bwd + 21
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

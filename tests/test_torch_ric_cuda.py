"""PyTorch port on the GPU: the hand-written RIC conv kernel against its
plain PyTorch twin, alone and inside GeneratorJ_RIC.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ric_cuda.py

Tolerance: 1e-4 of the largest output, the summation-order error of f32
sums of up to 9·C products (the kernel samples first and multiplies
second; the twin multiplies first)."""

import contextlib

import numpy as np
import pytest
import torch

from drawingspinup_torch.kernels import ric_conv as ric_kernels
from drawingspinup_torch.models import ric_tables
from drawingspinup_torch.train import gan

REL_TOL = 1e-4


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

"""PyTorch port on the GPU: the fused pixel-ray kernel
(``kernels/csrc/pixel_rays.cu``) against its plain PyTorch twin.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_pixel_rays_cuda.py

Tolerances: the target rows and view weights bit-equal; the rays within 2
f32 ulp (``kernels/pixel_rays.py::ray_ulps``, an ulp taken at the
magnitude of the terms each component sums: the twin's einsum and norm run
in cuBLAS and a reduction kernel, in their own order); two launches
bit-identical; out-of-range draws clamped.
"""

import pytest
import torch

from drawingspinup_torch.kernels import pixel_rays as pr
from drawingspinup_torch.train import nsr as tnsr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def seeded(device, v=6, h=1024, w=1024, r=2048, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((v, 3, 3), generator=g,
                                       device=device, dtype=torch.float64))
    c2w = torch.cat([q, torch.randn((v, 3, 1), generator=g, device=device,
                                    dtype=torch.float64) * 2], -1).float()
    vw = torch.rand((v,), generator=g, device=device) + 0.5
    pixels = torch.randn((v * h * w, 12), generator=g, device=device)
    vi = torch.randint(0, v, (r,), generator=g, device=device)
    yi = torch.randint(0, h, (r,), generator=g, device=device)
    xi = torch.randint(0, w, (r,), generator=g, device=device)
    return c2w.contiguous(), vw, pixels, h, w, vi, yi, xi


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 1024, 1024, 2048), (6, 37, 53, 999),
                                   (1, 8, 8, 1)])
def test_pixel_rays_matches_twin(shape, cuda_device):
    v, h, w, r = shape
    c2w, vw, pixels, h, w, vi, yi, xi = seeded(cuda_device, v, h, w, r)
    n0 = pr.LAUNCHES
    got = pr.pixel_rays(c2w, vw, pixels, h, w, vi, yi, xi)
    again = pr.pixel_rays(c2w, vw, pixels, h, w, vi, yi, xi)
    want = pr.pixel_rays_reference(c2w, vw, pixels, h, w, vi, yi, xi)
    torch.cuda.synchronize()
    assert pr.LAUNCHES == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    d_o, d_d = pr.ray_ulps(got, want, c2w, h, w, vi, yi, xi)
    assert d_o <= 2 and d_d <= 2, (d_o, d_d)
    # the dispatch takes the kernel on CUDA tensors
    via = pr.sample(c2w, vw, pixels, h, w, vi, yi, xi)
    assert pr.LAUNCHES == n0 + 3
    assert all(torch.equal(a, b) for a, b in zip(got, via))


@pytest.mark.cuda
def test_pixel_rays_clamps_out_of_range_draws(cuda_device):
    c2w, vw, pixels, h, w, vi, yi, xi = seeded(cuda_device, 3, 16, 16, 64)
    vi[:4] = torch.tensor([-1, 3, 7, 0], device=cuda_device)
    yi[:4] = torch.tensor([0, 15, 15, -5], device=cuda_device)
    xi[:4] = torch.tensor([-2, 15, 40, 0], device=cuda_device)
    got = pr.pixel_rays(c2w, vw, pixels, h, w, vi, yi, xi)
    torch.cuda.synchronize()
    rows = ((vi * h + yi) * w + xi).clamp(0, 3 * h * w - 1)
    assert torch.equal(got[2], pixels[rows])
    assert torch.equal(got[3], vw[vi.clamp(0, 2)])


@pytest.mark.cuda
def test_nsr_sample_pixel_rays_launches_the_kernel(cuda_device):
    c2w, vw, pixels, h, w, vi, yi, xi = seeded(cuda_device, 2, 8, 8, 16)
    data = {"masks": torch.zeros((2, 8, 8), device=cuda_device),
            "c2w": c2w, "view_weights": vw, "pixels": pixels[:128]}
    draws = tnsr.Draws(vi, yi, xi, None, None, None, None)
    n0 = pr.LAUNCHES
    ro, rd, targets = tnsr.sample_pixel_rays(data, draws)
    assert pr.LAUNCHES == n0 + 1
    assert torch.equal(targets["rgb"], pixels[:128][(vi * 8 + yi) * 8 + xi,
                                                     0:3])
    with pytest.raises(ValueError, match="f32"):
        tnsr.sample_pixel_rays({**data, "c2w": c2w.double()}, draws)

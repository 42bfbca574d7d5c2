"""PyTorch port, stage 2b: the plain twin of the fused pixel-ray kernel
(``kernels/pixel_rays.py``) on the CPU.

  * ``train/nsr.py::sample_pixel_rays`` runs the twin on CPU tensors and
    launches nothing; its targets are the data at the drawn pixels, bit for
    bit, on a seeded batch of the production ray count, with and without
    t_range columns;
  * on the same draws its rays are within 2 f32 ulp (``ray_ulps``) of
    JAX's ``train/nsr.py::sample_pixel_rays`` and its targets equal JAX's;
  * the kernel wrapper refuses CPU tensors.
"""

import numpy as np
import pytest
import torch

from drawingspinup_torch.kernels import pixel_rays as pr
from drawingspinup_torch.train import nsr as tnsr


def seeded_data(v=6, h=24, w=32, t_range=True, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    q, _ = np.linalg.qr(rng.standard_normal((v, 3, 3)))
    c2w = np.concatenate([q, rng.standard_normal((v, 3, 1)) * 2], axis=-1)
    data = {"images": t(rng.random((v, h, w, 3))),
            "normals": t(rng.standard_normal((v, h, w, 3))),
            "masks": t(rng.random((v, h, w)) > 0.5),
            "view_weights": t(rng.random(v) + 0.5), "c2w": t(c2w)}
    if t_range:
        data["t_range"] = t(rng.random((v, h, w, 2)))
    data["pixels"] = tnsr.pack_pixels(data)
    g = torch.Generator().manual_seed(seed)
    draws = tnsr.make_draws(tnsr.NSRConfig(), v, h, w, g, "cpu")
    return data, draws


def targets_at(data, vi, yi, xi):
    want = {"rgb": data["images"][vi, yi, xi],
            "normal": data["normals"][vi, yi, xi],
            "mask": data["masks"][vi, yi, xi].float(),
            "view_weights": data["view_weights"][vi]}
    if "t_range" in data:
        want["t_range"] = data["t_range"][vi, yi, xi]
    return want


@pytest.mark.parametrize("t_range,dtype", [(True, torch.float32),
                                           (False, torch.float32),
                                           (True, torch.float64)])
def test_sample_pixel_rays_is_the_twin(t_range, dtype):
    data, draws = seeded_data(t_range=t_range)
    data["c2w"] = data["c2w"].to(dtype)
    v, h, w = data["masks"].shape
    assert draws.vi.shape == (tnsr.NSRConfig().train_num_rays,)
    n0 = pr.LAUNCHES
    ro, rd, targets = tnsr.sample_pixel_rays(data, draws)
    assert pr.LAUNCHES == n0
    want = pr.pixel_rays_reference(data["c2w"], data["view_weights"],
                                   data["pixels"], h, w, draws.vi, draws.yi,
                                   draws.xi)
    assert torch.equal(ro, want[0]) and torch.equal(rd, want[1])
    assert ro.dtype == rd.dtype == dtype
    want_t = targets_at(data, draws.vi, draws.yi, draws.xi)
    assert sorted(targets) == sorted(want_t)
    for k in want_t:
        assert torch.equal(targets[k], want_t[k]), k


@pytest.mark.parametrize("t_range", [True, False])
def test_sample_pixel_rays_matches_jax(t_range):
    import jax
    import jax.numpy as jnp

    from drawingspinup_tpu.train import nsr as jnsr

    data, _ = seeded_data(t_range=t_range, seed=3)
    v, h, w = data["masks"].shape
    n = tnsr.NSRConfig().train_num_rays
    key = jax.random.PRNGKey(7)
    jdata = {k: jnp.asarray(t.numpy()) for k, t in data.items()
             if k != "pixels"}
    j_o, j_d, j_t = jnsr.sample_pixel_rays(key, jdata, n)
    # the draws JAX's function makes from its key
    kv, ky, kx = jax.random.split(key, 3)
    vi, yi, xi = (torch.from_numpy(np.array(
        jax.random.randint(k, (n,), 0, hi))).long()
        for k, hi in ((kv, v), (ky, h), (kx, w)))
    draws = tnsr.Draws(vi, yi, xi, None, None, None, None)
    ro, rd, targets = tnsr.sample_pixel_rays(data, draws)
    want = (torch.from_numpy(np.array(j_o)), torch.from_numpy(np.array(j_d)))
    ulps = pr.ray_ulps((ro, rd), want, data["c2w"], h, w, vi, yi, xi)
    assert max(ulps) <= 2, ulps
    assert sorted(targets) == sorted(j_t)
    for k in j_t:
        np.testing.assert_array_equal(
            targets[k].numpy(), np.asarray(j_t[k], np.float32), err_msg=k)


def test_kernel_wrapper_refuses_cpu_tensors():
    data, draws = seeded_data()
    v, h, w = data["masks"].shape
    with pytest.raises(ValueError, match="CUDA"):
        pr.pixel_rays(data["c2w"], data["view_weights"], data["pixels"], h,
                      w, draws.vi, draws.yi, draws.xi)

"""PyTorch port: ``models/encodings.py`` against
``drawingspinup_tpu/models/encodings.py`` on numpy inputs made from a seed,
f32, within relative 1e-6 (``rtol``; ``atol`` 1e-6 of the largest value
for terms that cancel to near 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drawingspinup_tpu.models import encodings as jenc
from drawingspinup_torch.models import encodings as tenc

TOL = 1e-6


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


def _x(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_vanilla_frequency(masked):
    x = _x(0, (37, 3))
    mask = _x(1, (6,), 0.0, 1.0) if masked else None
    want = jenc.vanilla_frequency(jnp.asarray(x), 6,
                                  None if mask is None else jnp.asarray(mask))
    got = tenc.vanilla_frequency(torch.from_numpy(x), 6,
                                 None if mask is None
                                 else torch.from_numpy(mask))
    _close(got, want)


@pytest.mark.parametrize("step,n_masking_step", [(0, 100), (37, 100),
                                                 (250, 100), (37, 0)])
def test_frequency_mask(step, n_masking_step):
    want = jenc.frequency_mask(8, jnp.asarray(step), n_masking_step)
    got = tenc.frequency_mask(8, step, n_masking_step)
    _close(got, want)


def test_spherical_harmonics_l4():
    d = _x(2, (101, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tenc.spherical_harmonics_l4(torch.from_numpy(d)),
           jenc.spherical_harmonics_l4(jnp.asarray(d)))


def test_trunc_exp_and_its_clamped_gradient():
    """Values and the VJP of a random cotangent on x in [-5, 20], across
    the clamp at 15 (points on both sides of it)."""
    x = _x(3, (64,), -5.0, 20.0)
    assert (x > 15).any() and (x < 15).any()
    g = _x(4, (64,), 0.5, 1.5)
    want, vjp = jax.vjp(jenc.trunc_exp, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tenc.trunc_exp(xt)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    _close(got, want)
    _close(dx, want_dx)
    hi = x > 15
    np.testing.assert_allclose(dx.numpy()[hi], g[hi] * np.exp(np.float32(15)),
                               rtol=TOL)


def test_chunk_batch():
    """A row count the chunk does not divide: the same rows as the
    unchunked call and as JAX's padded chunks, for a tuple output."""
    a, b = _x(5, (23, 4)), _x(6, (23, 2))

    def jfn(u, v):
        return jnp.tanh(u) * 2.0, jnp.sum(v, axis=-1, keepdims=True)

    def tfn(u, v):
        return torch.tanh(u) * 2.0, torch.sum(v, dim=-1, keepdim=True)

    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tenc.chunk_batch(tfn, 8, ta, tb)
    whole = tfn(ta, tb)
    want = jenc.chunk_batch(jfn, 8, jnp.asarray(a), jnp.asarray(b))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w, j in zip(got, whole, want):
        assert torch.equal(g, w)
        _close(g, j)
    single = tenc.chunk_batch(lambda u: u * 3.0, 10, ta)
    assert torch.equal(single, ta * 3.0)
    named = tenc.chunk_batch(lambda u, v: {"u": u + 1.0, "v": v * 2.0}, 5,
                             ta, tb)
    assert torch.equal(named["u"], ta + 1.0)
    assert torch.equal(named["v"], tb * 2.0)

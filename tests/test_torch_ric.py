"""PyTorch port: RIC conv tables, plain twins, autograd Function and kernel
wrappers (drawingspinup_torch/models/ric_tables.py, kernels/ric_conv.py)
against the JAX package.

Tolerances: the twin and the JAX formulations sum the same f32 products in
different orders, so the forward agrees to atol = rtol = 2e-5 (the bound
tests/test_ric_pallas.py uses for the Pallas kernel against ``fused``),
and the VJP to atol = rtol = 3e-4 (its bound for the Pallas VJP: dwk sums
N·H·W·9 products per element). The copied numpy tables must be
bit-equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drawingspinup_tpu.kernels.ric_conv import ric_conv as pallas_ric_conv
from drawingspinup_tpu.models import generator_j as jgen
from drawingspinup_torch.kernels import _build
from drawingspinup_torch.kernels import ric_conv as ric_kernels
from drawingspinup_torch.models import ric_tables

TOL = dict(atol=2e-5, rtol=2e-5)


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
    assert ric_kernels.LAUNCHES == ric_kernels.BWD_LAUNCHES == 0
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
    assert ric_kernels.LAUNCHES == ric_kernels.BWD_LAUNCHES == 0
    assert _build._ext is None

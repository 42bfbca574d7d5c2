"""PyTorch port: RIC conv tables, plain twin and kernel wrapper
(drawingspinup_torch/models/ric_tables.py, kernels/ric_conv.py) against the
JAX package.

Tolerances: the twin and the JAX formulations sum the same f32 products in
different orders, so they agree to atol = rtol = 2e-5 (the bound
tests/test_ric_pallas.py uses for the Pallas kernel against ``fused``).
The copied numpy tables must be bit-equal."""

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


def test_cpu_tensor_runs_twin_and_launches_nothing():
    x, wk, swf = _inputs((1, 8, 8, 3, 4), seed=5)
    before = ric_kernels.LAUNCHES
    got = ric_kernels.ric_conv(torch.from_numpy(x), torch.from_numpy(wk),
                               torch.from_numpy(swf.copy()))
    np.testing.assert_array_equal(got.numpy(), _twin(x, wk, swf))
    assert ric_kernels.LAUNCHES == before == 0
    assert _build._ext is None


@pytest.mark.parametrize("case", ["cpu", "dtype", "x_rank", "wk_shape",
                                  "swf_shape", "noncontig"])
def test_kernel_wrapper_rejects_before_build(case):
    """ric_conv_fwd checks its inputs before it builds or launches
    anything; a CPU tensor is refused, never computed."""
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
        ric_kernels.ric_conv_fwd(x, wk, swf)
    assert ric_kernels.LAUNCHES == 0 and _build._ext is None

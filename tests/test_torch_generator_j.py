"""PyTorch port: GeneratorJ_RIC / GeneratorJ eval forward, the flax → torch
parameter converter and GANConfig, against the JAX package (training mode:
tests/test_torch_train.py).

Weights come from the JAX generator's own init (as ``gan.init_state``
runs it) plus batch statistics drawn from a numpy seed (so batch norm is not the identity), converted with
``utils/jax_params.py``. Inputs come from numpy seeds.

Tolerance 1e-4 absolute on outputs in [-1, 1] (tanh): each layer's f32
sums run in another order in the two frameworks (ulp-level), and up to
about twenty layers compound that; the JAX side runs at
``default_matmul_precision("highest")`` so no bf16 pass hides in it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drawingspinup_tpu.models import generator_j as jgen
from drawingspinup_tpu.train import gan as jgan
from drawingspinup_torch.models import generator_j as tgen
from drawingspinup_torch.train import gan as tgan
from drawingspinup_torch.utils import jax_params
from mv_parity import rel_l2

TOL = 1e-4
# the bf16 tests' floor: a port that computed in f32 would sit ~1e-6 from
# JAX's f32 output, far below this share of JAX's own bf16 distance
BF16_FLOOR = 0.25
SMALL = dict(filters=(8, 16, 16, 16, 16, 8), resnet_blocks=2)


def random_batch_stats(stats, seed):
    """Replace every flax batch-norm statistic with seeded, non-trivial
    values (mean ~ N(0, 0.1²), var ∈ [0.5, 1.5])."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = np.shape(leaf)
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, stats)


@functools.lru_cache(maxsize=None)
def jax_variables(cfg, seed):
    """(params, batch_stats) of the JAX generator as ``gan.init_state``
    initialises it (``gen.init`` at one patch, train mode), as numpy, with
    ``random_batch_stats`` in place of its unit statistics. The rest of
    ``init_state`` (discriminator, VGG, optimizers) is not needed here."""
    gen, _, _ = jgan.build_models(cfg)
    p = cfg.patch_size
    variables = jax.jit(functools.partial(gen.init, train=True))(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, p, p, cfg.input_channels), jnp.float32))
    params = jax.tree.map(np.asarray, variables["params"])
    return params, random_batch_stats(variables["batch_stats"], seed)


def port_generator(cfg, params, stats):
    model = tgan.build_generator(tgan.GANConfig(**dataclasses.asdict(cfg)),
                                 "cpu")
    model.load_state_dict(jax_params.to_state_dict(params, stats))
    return model


def jax_forward(cfg, params, stats, x):
    gen, _, _ = jgan.build_models(cfg, ric_variant="fused")
    with jax.default_matmul_precision("highest"):
        return np.asarray(gen.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(x), train=False))


@pytest.mark.parametrize("generator", ["GeneratorJ_RIC", "GeneratorJ"])
@pytest.mark.parametrize("hw", [(16, 16), (24, 32)])
def test_eval_forward_matches_jax(generator, hw):
    cfg = jgan.GANConfig(generator=generator, **SMALL)
    params, stats = jax_variables(cfg, seed=7)
    x = np.random.default_rng(sum(hw)).uniform(
        -1, 1, (2, *hw, cfg.input_channels)).astype(np.float32)
    want = jax_forward(cfg, params, stats, x)
    with torch.no_grad():
        got = port_generator(cfg, params, stats)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("generator", ["GeneratorJ_RIC", "GeneratorJ"])
def test_converter_keys_match_exactly(generator):
    """Every flax leaf lands on a port parameter or buffer and every port
    parameter or buffer is filled (the dead smooth0 / smooth_bn branch of
    GeneratorJ_RIC included), with the converted shapes."""
    cfg = jgan.GANConfig(generator=generator, **SMALL)
    params, stats = jax_variables(cfg, seed=7)
    sd = jax_params.to_state_dict(params, stats)
    model = tgan.build_generator(tgan.GANConfig(**dataclasses.asdict(cfg)),
                                 "cpu")
    result = model.load_state_dict(sd, strict=False)
    assert result.missing_keys == [] and result.unexpected_keys == []
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_ric_forward_runs_21_convs_at_production_depth():
    """One eval forward of the 7-block GeneratorJ_RIC is 21 RIC convs: the
    dead smooth0 / smooth_bn branch is skipped."""
    model = tgan.build_generator(tgan.GANConfig(), "cpu",
                                 torch.Generator().manual_seed(0))
    calls = []
    for name, mod in model.named_modules():
        if isinstance(mod, tgen.RICConv):
            mod.register_forward_hook(
                lambda m, i, o, name=name: calls.append(name))
    with torch.no_grad():
        model(torch.zeros(1, 16, 16, 6))
    assert len(calls) == 21
    assert "smooth0" not in calls and "smooth1" in calls


def test_ganconfig_fields_and_defaults_match_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(tgan.GANConfig) == spec(jgan.GANConfig)


def test_seeded_init_is_reproducible():
    a, b = (tgan.build_generator(tgan.GANConfig(**SMALL), "cpu",
                                 torch.Generator().manual_seed(3))
            for _ in range(2))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_upsample_and_pool_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tgen.upsample2x(torch.from_numpy(x)).numpy(),
        np.asarray(jgen.upsample2x(jnp.asarray(x))))
    import flax.linen as nn
    np.testing.assert_array_equal(
        tgen._maxpool2x(torch.from_numpy(x)).numpy(),
        np.asarray(nn.max_pool(jnp.asarray(x), (2, 2), strides=(2, 2))))


# ------------------------------------------------------------------ bf16 --

@pytest.mark.parametrize("generator", ["GeneratorJ_RIC", "GeneratorJ"])
def test_bf16_eval_forward_no_farther_from_f32_than_jax(generator):
    """``compute_dtype="bfloat16"`` on the same f32 params: the output is
    f32 at the boundary, within JAX's own bounds of the f32 forward
    (``tests/test_stage3.py``: max 0.15, mean 0.03), and no farther
    (relative L2) from JAX's f32 forward than 1.25 × JAX's bf16 forward,
    which serves with the ``pershift`` RIC schedule (its (N,H,W,9,O)
    intermediate rounded to bf16; the port's kernels keep it f32), nor
    nearer than ``BF16_FLOOR`` × it (the port does compute in bf16)."""
    cfg = jgan.GANConfig(generator=generator, **SMALL)
    c16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params, stats = jax_variables(cfg, seed=7)
    x = np.random.default_rng(11).uniform(
        -1, 1, (2, 32, 32, cfg.input_channels)).astype(np.float32)
    j32 = jax_forward(cfg, params, stats, x)
    gen16, _, _ = jgan.build_models(c16, ric_variant="pershift")
    j16 = np.asarray(gen16.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), train=False))
    with torch.no_grad():
        t32 = port_generator(cfg, params, stats)(torch.from_numpy(x))
        t16 = port_generator(c16, params, stats)(torch.from_numpy(x))
    assert t16.dtype == torch.float32 and t16.shape == t32.shape
    t16, t32 = t16.numpy(), t32.numpy()
    assert np.abs(t16 - t32).max() < 0.15
    assert np.abs(t16 - t32).mean() < 0.03
    d_port, d_jax = rel_l2(t16, j32), rel_l2(j16, j32)
    assert BF16_FLOOR * d_jax <= d_port <= 1.25 * d_jax, (d_port, d_jax)

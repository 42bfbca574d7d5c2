"""Shared helpers of the stage-2a parity tests
(``tests/test_torch_stage2a*.py``, ``tests/test_torch_mv_split.py``): JAX
flax trees filled with seeded numpy values, the conversion to the port's
modules, NHWC ↔ NCHW, relative L2, JAX's noise chain, JAX's pipeline in
float64, and a safetensors writer."""

import contextlib
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drawingspinup_torch.utils.jax_params import mv_params


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def seeded_tree(init_fn, *args, seed: int = 0, scale: float = 1.0):
    """A flax ``params`` tree of ``init_fn``'s shapes, filled with seeded
    normal values (std ``scale``/sqrt(fan-in) for kernels, 0.1 for biases,
    1 ± 0.1 for norm scales): every weight nonzero, the joint attentions'
    zero-initialised projections included."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias" or len(s.shape) == 1:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (scale * rng.standard_normal(s.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def load_into(module: torch.nn.Module, part: str, params) -> torch.nn.Module:
    module.load_state_dict(mv_params({part: to_numpy(params)})[part],
                           strict=True)
    return module.eval()


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_noises(seed: int, shape, steps: int):
    """JAX's draws of ``MVPipeline.__call__`` (NHWC ``shape``): the initial
    latents from the first split of PRNGKey(seed), then one normal per
    step from the loop's splits; returned NCHW, f32."""
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    out = [jax.random.normal(k0, shape)]
    for _ in range(steps):
        key, kn = jax.random.split(key)
        out.append(jax.random.normal(kn, shape))
    return [nchw(np.asarray(x)) for x in out]


def distances(got, want):
    """(max abs, relative L2) of ``got`` from ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), rel_l2(got, want)


class F64:
    """A module namespace whose ``float32`` is float64 (JAX modules read
    their fixed dtypes through it at trace time)."""

    def __init__(self, mod, f64):
        self._mod, self._f64 = mod, f64

    def __getattr__(self, name):
        return self._f64 if name == "float32" else getattr(self._mod, name)


class _F32Normal:
    """``jax.random`` whose ``normal`` draws f32 and casts to float64."""

    def __getattr__(self, name):
        if name == "normal":
            return lambda key, shape: jax.random.normal(
                key, shape, jnp.float32).astype(jnp.float64)
        return getattr(jax.random, name)


class _F32Draws:
    """``jax`` with ``_F32Normal`` as ``random``, so that the float64 run
    consumes the f32 run's draws."""

    random = _F32Normal()

    def __getattr__(self, name):
        return getattr(jax, name)


class _TwoPassNorm:
    """``flax.linen`` whose GroupNorm takes the variance in two passes."""

    def __init__(self, nn):
        self._nn = nn

    def __getattr__(self, name):
        if name == "GroupNorm":
            return functools.partial(self._nn.GroupNorm,
                                     use_fast_variance=False)
        return getattr(self._nn, name)


@contextlib.contextmanager
def jax_mv_float64():
    """JAX's stage-2a pipeline in float64 on one device, with nothing in
    the JAX package edited: x64 on; the fixed f32 of the sampler's eps
    cast, the attention core and the timestep embedding read as float64;
    the draws f32 cast to float64 (the f32 run's draws); and two parts of
    JAX's libraries that stay in f32 or lose float64 digits under x64
    swapped: ``jax.nn.dot_product_attention`` takes its softmax in f32
    whatever the dtype (the CLIP embeddings then part from float64 by
    ~6e-8 relative), and flax's GroupNorm computes the variance as
    E[x²] − E[x]², which at the tiny UNet's 1×1 level, where
    mean²/variance reaches 7e7, loses digits even in float64; there it
    takes two passes, as the port's. One part stays f32 on purpose on both
    sides: the DDIM coefficients, from the f32 ``alphas_cumprod`` table,
    which XLA computes inside the jitted loop with other f32 roundings
    than numpy's step by step (an ulp of sigma moves the update by
    ~1e-7)."""
    from jax._src.nn import functions as jax_nn_functions

    from drawingspinup_tpu.models import attention_mv, unet_mv2d
    from drawingspinup_tpu.pipelines import stage2_mv

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stage2_mv, "jnp", F64(jnp, jnp.float64))
        mp.setattr(stage2_mv, "jax", _F32Draws())
        mp.setattr(stage2_mv, "_mv_batch_sharding", lambda batch: None)
        for mod in (attention_mv, unet_mv2d):
            mp.setattr(mod, "jnp", F64(jnp, jnp.float64))
            mp.setattr(mod, "nn", _TwoPassNorm(mod.nn))
        mp.setattr(jax_nn_functions, "np", F64(np, np.float64))
        with jax.enable_x64(True):
            yield


def jax_float64_latents(jcfg, params, image, **kw) -> np.ndarray:
    """The denoised latents (2·Nv, h, w, 4), normals first, of JAX's
    pipeline of ``jcfg`` (``kw`` replaced) in float64 on the f32
    ``params`` tree (numpy) and ``image``, seed 0. The VAE decode is
    skipped: the full SD VAE in float64 takes minutes on XLA's CPU
    backend, and its parity is held apart."""
    from drawingspinup_tpu.pipelines import stage2_mv

    with jax_mv_float64():
        cfg = dataclasses.replace(jcfg, compute_dtype="float64", **kw)
        tree = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params)
        pipe = stage2_mv.MVPipeline(cfg, tree)
        sample_loop, _ = pipe._sample_fns()
        pipe._sample_fns = lambda: (sample_loop, lambda vae, z: z)
        out = np.concatenate(pipe(np.asarray(image, np.float64), seed=0))
        assert out.dtype == np.float64
        return out


_ST_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
              np.dtype(np.int64): "I64"}


def write_safetensors(path, tensors, bf16=()):
    """A safetensors file written by hand: the 8-byte little-endian header
    length, the JSON header, the raw little-endian data; the names in
    ``bf16`` stored as bfloat16 (the high half of each f32)."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, a in tensors.items():
        if name in bf16:
            raw = (np.ascontiguousarray(a, np.float32).view(np.uint32)
                   >> 16).astype("<u2").tobytes()
            dtype = "BF16"
        else:
            raw = np.ascontiguousarray(a).astype(
                a.dtype.newbyteorder("<")).tobytes()
            dtype = _ST_DTYPES[a.dtype]
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(np.array([len(h)], "<u8").tobytes() + h + b"".join(blobs))

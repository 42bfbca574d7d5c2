"""Shared helpers of the stage-2a parity tests
(``tests/test_torch_stage2a*.py``): JAX flax trees filled with seeded numpy
values, the conversion to the port's modules, NHWC ↔ NCHW, relative L2,
JAX's noise chain, and a safetensors writer."""

import json

import numpy as np
import torch

import jax

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

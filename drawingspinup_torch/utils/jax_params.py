"""Convert a flax ``{params, batch_stats}`` tree of the stage-3 models
into the port's ``state_dict``, and a JAX NSR state (params and optax
state, stage 2b) into the port's params dict and moments (``nsr_params``,
``nsr_opt_state`` at the end of this module).

The input is nested dicts of numpy arrays (``np.asarray`` of each leaf of
flax variables); no JAX is needed. Rules, for GeneratorJ, GeneratorJ_RIC,
DiscriminatorN_IN and PerceptualVGG19 alike (the last two have no batch
statistics, and their ConvBlocks' ``kernel``/``bias`` map as below):

* conv kernels (4-d, flax HWIO) → ``<module>.weight`` in torch OIHW; this
  covers ``head_kernel`` (1, 1, C, 3) → ``head.weight`` (3, C, 1, 1);
* RIC kernels (3-d, (9, C, O)) keep their name and layout;
* ``BatchNorm`` ``scale``/``bias`` and the ``mean``/``var`` statistics →
  ``weight``/``bias``/``running_mean``/``running_var`` (eps 1e-5 in both);
  a ConvBlock's ``BatchNorm_0`` submodule is called ``norm`` here;
* ``head_bias`` → ``head.bias``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_RENAME = {"BatchNorm_0": "norm", "head_kernel": "head.kernel",
           "head_bias": "head.bias", "scale": "weight",
           "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def to_state_dict(params: Mapping[str, Any],
                  batch_stats: Optional[Mapping[str, Any]] = None
                  ) -> Dict[str, torch.Tensor]:
    """flax model variables → torch ``state_dict`` (CPU, f32)."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _leaves(tree):
            a = np.array(leaf, np.float32)       # a writable copy
            key = ".".join(_RENAME.get(p, p) for p in path)
            if key.endswith("kernel") and a.ndim == 4:
                key = key[:-len("kernel")] + "weight"
                a = a.transpose(3, 2, 0, 1)          # HWIO → OIHW
            if key in out:
                raise ValueError(f"duplicate converted key {key!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


# ---------------------------------------------------------------------------
# NSR (stage 2b): params and optimizer state
# ---------------------------------------------------------------------------

def _tensor(leaf: Any) -> torch.Tensor:
    """A numpy (or array-like) leaf as a CPU tensor of the same dtype; bf16
    travels through f32, which holds every bf16 value exactly."""
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def nsr_params(tree: Mapping[str, Any], device="cpu",
               requires_grad: bool = True) -> Dict[str, Any]:
    """JAX NSR params (``geometry.table`` a tuple of per-level arrays,
    ``geometry.mlp.layers[i].{w,b,g}``, ``texture.mlp.layers[i].{w,b}``,
    ``variance.variance``) → the port's params dict, each leaf a tensor of
    the JAX leaf's dtype."""
    def conv(v):
        if isinstance(v, Mapping):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        t = _tensor(v).to(device)
        return t.requires_grad_(requires_grad) if requires_grad else t
    return conv(tree)


def nsr_opt_state(opt_state: Any, device="cpu"):
    """An optax ``multi_transform`` state of three ``adamw`` (the JAX
    trainer's ``make_optimizer``) → (mu, nu, count) with the port's leaf
    names (``train/nsr.py::named_leaves``). Read by attribute; needs no
    JAX."""
    from drawingspinup_torch.train.nsr import GROUPS, named_leaves

    mu, nu, counts = {}, {}, set()
    for group in GROUPS:
        adam = opt_state.inner_states[group].inner_state[0]
        counts.add(int(np.asarray(adam.count)))
        for store, tree in ((mu, adam.mu[group]), (nu, adam.nu[group])):
            for name, leaf in named_leaves(tree, group + "."):
                store[name] = _tensor(leaf).to(device)
    if len(counts) != 1:
        raise ValueError(f"groups disagree on the update count: {counts}")
    return mu, nu, counts.pop()

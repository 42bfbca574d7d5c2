"""Convert a flax ``{params, batch_stats}`` tree of the stage-3 models
into the port's ``state_dict``, a JAX NSR state (params and optax state,
stage 2b) into the port's params dict and moments (``nsr_params``,
``nsr_opt_state``), and the stage-1 FFC generator's variables into its
``state_dict`` (``ffc_params``, at the end of this module).

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

import re
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


# ---------------------------------------------------------------------------
# stage 1: the LaMa FFC generator and its parts
# ---------------------------------------------------------------------------

_FFC_RENAME = {"scale": "weight", "mean": "running_mean",
               "var": "running_var", "conv": "conv_layer", "bn1": "conv1.1"}


def _ffc_top(params: Mapping[str, Any]) -> Dict[str, str]:
    """The flax generator's top-level names → the indices of upstream's
    ``model`` Sequential: 0 pad, 1 init, the downsamples, the blocks, the
    concat, per upsample [ConvTranspose, BN, ReLU], pad, head. Empty for
    a tree that is not a whole generator."""
    if "init" not in params:
        return {}
    nd = sum(1 for k in params if re.fullmatch(r"down\d+", k))
    nb = sum(1 for k in params if re.fullmatch(r"block\d+", k))
    top = {"init": "model.1"}
    top.update({f"down{i}": f"model.{2 + i}" for i in range(nd)})
    top.update({f"block{i}": f"model.{2 + nd + i}" for i in range(nb)})
    up = 3 + nd + nb
    for i in range(nd):
        top[f"up{i}"] = f"model.{up + 3 * i}"
        top[f"up{i}_bn"] = f"model.{up + 3 * i + 1}"
    top["head"] = f"model.{up + 3 * nd + 1}"
    return top


def ffc_params(params: Mapping[str, Any],
               batch_stats: Optional[Mapping[str, Any]] = None
               ) -> Dict[str, torch.Tensor]:
    """flax variables of ``drawingspinup_tpu/models/ffc.py`` (the whole
    ``FFCResNetGenerator`` or one of its parts: ``FourierUnit``,
    ``SpectralTransform``, ``FFCBnAct``, ``FFCResnetBlock``) → the
    ``state_dict`` of the port's module of the same kind (upstream LaMa's
    names, as ``drawingspinup_tpu/utils/torch_port.py`` maps them). Conv
    kernels HWIO → OIHW; the upsampling kernels (kh, kw, in, out) →
    ConvTranspose2d's (in, out, kh, kw); the flax ``BatchNorm_0`` wrapper
    level drops out; ``scale``/``mean``/``var`` →
    ``weight``/``running_mean``/``running_var``; the Fourier unit's
    ``conv`` → ``conv_layer``; SpectralTransform's ``conv1``/``bn1`` →
    ``conv1.0``/``conv1.1``."""
    top = _ffc_top(params)
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _leaves(tree):
            a = np.array(leaf, np.float32)
            names = []
            for i, p in enumerate(path):
                if i == 0 and p in top:
                    names.append(top[p])
                elif p == "BatchNorm_0":
                    continue
                elif p == "conv1" and path[i + 1] == "kernel":
                    names.append("conv1.0")
                else:
                    names.append(_FFC_RENAME.get(p, p))
            if names[-1] == "kernel":
                names[-1] = "weight"
                transposed = re.fullmatch(r"up\d+", path[0]) is not None \
                    and bool(top)
                a = a.transpose((2, 3, 0, 1) if transposed else (3, 2, 0, 1))
            key = ".".join(names)
            if key in out:
                raise ValueError(f"duplicate converted key {key!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out

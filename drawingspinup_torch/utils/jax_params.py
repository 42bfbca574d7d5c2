"""Convert a flax ``{params, batch_stats}`` tree of the stage-3 models
into the port's ``state_dict``, a JAX NSR state (params and optax state,
stage 2b) into the port's params dict and moments (``nsr_params``,
``nsr_opt_state``), the stage-1 FFC generator's variables into its
``state_dict`` (``ffc_params``), the stage-2a pipeline's params
(``mv_params``) and ISNet's variables (``isnet_params``, at the end of this
module).

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


# ---------------------------------------------------------------------------
# stage 2a: the MV-UNet, the SD VAE and the CLIP image encoder
# ---------------------------------------------------------------------------

_MV_TOP = ((r"(down|up)(\d+)_res(\d+)", r"\1_blocks.\2.resnets.\3"),
           (r"(down|up)(\d+)_attn(\d+)", r"\1_blocks.\2.attentions.\3"),
           (r"down(\d+)_downsample", r"down_blocks.\1.downsamplers.0"),
           (r"up(\d+)_upsample", r"up_blocks.\1.upsamplers.0"),
           (r"mid_res(\d+)", r"mid_block.resnets.\1"),
           (r"mid_attn", r"mid_block.attentions.0"),
           (r"block(\d+)", r"transformer_blocks.\1"),
           (r"layer(\d+)", r"vision_model.encoder.layers.\1"))
_CLIP_TOP = {"patch_embedding": "vision_model.embeddings.patch_embedding",
             "class_embedding": "vision_model.embeddings.class_embedding",
             "position_embedding":
                 "vision_model.embeddings.position_embedding.weight",
             "pre_layrnorm": "vision_model.pre_layrnorm",
             "post_layernorm": "vision_model.post_layernorm"}
_CLIP_SUB = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _mv_name(part: str, path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(the port's key of a flax leaf path of the UNet, VAE or CLIP tree,
    whether the leaf is a transformer's 1×1 proj_in/proj_out kernel)."""
    names, proj = [], False
    for i, p in enumerate(path):
        if i == 0 and part == "clip" and p in _CLIP_TOP:
            names.append(_CLIP_TOP[p])
            continue
        if i == len(path) - 1:
            names.append({"kernel": "weight", "scale": "weight"}.get(p, p))
            continue
        for pat, rep in _MV_TOP:
            if re.fullmatch(pat, p):
                # a VAE's down/up sampler is the conv itself in flax
                q = re.sub(pat, rep, p)
                if q.endswith("samplers.0") and path[i + 1] != "conv":
                    q += ".conv"
                names.append(q)
                break
        else:
            if p == "to_out":
                names.append("to_out.0")
            elif i > 0 and path[i - 1] == "ff":
                names.append("net.0.proj" if p == "proj_in" else "net.2")
            elif p in ("proj_in", "proj_out") and path[-1] == "kernel":
                names.append(p)
                proj = True
            elif p in _CLIP_SUB and re.fullmatch(r"layer\d+", path[0]):
                names.append(_CLIP_SUB[p])
            else:
                names.append(p)
    return ".".join(names), proj


def _mv_state(part: str, tree: Mapping[str, Any]
              ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        a = np.array(leaf, np.float32)
        key, proj = _mv_name(part, path)
        if path[-1] == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)          # HWIO → OIHW
            elif proj:
                a = a.T[:, :, None, None]             # 1×1 conv weight
            else:
                a = a.T                               # (in, out) → (out, in)
        if key in out:
            raise ValueError(f"duplicate converted key {key!r}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def mv_params(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX stage-2a pipeline's params (``{"unet", "vae", "clip"}``, or
    any one of them; numpy leaves) → ``{part: state_dict}`` of the port's
    ``UNetMV2D``, ``AutoencoderKL`` and ``CLIPVisionModelWithProjection``
    (diffusers' and transformers' names: the inverse of
    ``drawingspinup_tpu/utils/diffusers_port.py``'s key maps). Dense
    kernels (in, out) → (out, in); conv kernels HWIO → OIHW; a
    transformer's proj_in/proj_out → (out, in, 1, 1), the checkpoint's 1×1
    conv; ``scale`` → ``weight``."""
    return {part: _mv_state(part, tree) for part, tree in params.items()}


# ---------------------------------------------------------------------------
# ISNet (stage-2a background removal)
# ---------------------------------------------------------------------------

_ISNET_LEAF = {("conv", "kernel"): ".weight", ("conv", "bias"): ".bias",
               ("bn", "scale"): ".weight", ("bn", "bias"): ".bias",
               ("bn", "mean"): ".running_mean", ("bn", "var"): ".running_var"}


def _isnet_name(path: Tuple[str, ...]) -> str:
    """A flax ISNet leaf path → upstream's name, as JAX's
    ``port_isnet_torch_state`` maps it (``_src_names``)."""
    if path[-2].startswith("side"):
        return path[-2] + {"kernel": ".weight", "bias": ".bias"}[path[-1]]
    mod, leaf_mod = list(path[:-2]), path[-2]
    child = leaf_mod if mod[-1] == "conv_in" else \
        {"conv": "conv_s1", "bn": "bn_s1"}[leaf_mod]
    return ".".join(mod + [child]) + _ISNET_LEAF[(leaf_mod, path[-1])]


def isnet_params(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX's ISNetDIS variables (``{"params", "batch_stats"}``, numpy
    leaves) → the port's ``ISNetDIS`` ``state_dict`` in upstream's names
    (conv kernels HWIO → OIHW); no ``num_batches_tracked``."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables[coll]):
            a = np.array(leaf, np.float32)
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1)
            key = _isnet_name(path)
            if key in out:
                raise ValueError(f"duplicate converted key {key!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out

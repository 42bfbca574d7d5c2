"""Load a local diffusers-layout Wonder3D checkpoint into the stage-2a
modules (counterpart of ``drawingspinup_tpu/utils/diffusers_port.py``).

The directory holds ``unet/``, ``vae/`` and ``image_encoder/``, each with
``*.safetensors`` files. The port's modules carry diffusers' and
transformers' own parameter names, so loading is a rename and
``load_state_dict(strict=True)``, which raises on a missing or unexpected
key:

* the UNet's joint-attention blocks are stored under their training names
  (``attn_joint_twice.`` → ``attn_joint_mid.``, ``attn_joint.`` →
  ``attn_joint_last.``; Wonder3D's ``unet_mv2d_condition.py:1318-1332``);
* attention blocks saved by diffusers < 0.15 use ``query``/``key``/
  ``value``/``proj_attn``, renamed to ``to_q``/``to_k``/``to_v``/
  ``to_out.0``;
* transformers' ``position_ids`` buffer is dropped.

The safetensors reader is plain numpy (an 8-byte little-endian header
length, the JSON header, then the raw little-endian tensors; bf16 and f16
included), so the loader needs no ``safetensors`` package.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
           "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
           "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of one safetensors file; bf16 tensors come back as
    f32 (exactly: bf16 is the high half of an f32). Raises ValueError on a
    truncated or malformed file."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8:
        raise ValueError(f"{path}: {len(blob)} bytes, no safetensors header")
    n = int(np.frombuffer(blob[:8], "<u8")[0])
    if n > len(blob) - 8:
        raise ValueError(f"{path}: header of {n} bytes in a file of "
                         f"{len(blob)} bytes (truncated)")
    try:
        header = json.loads(blob[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: malformed safetensors header ({e})")
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = _DTYPES.get(meta.get("dtype"))
        if dt is None:
            raise ValueError(f"{path}: {name} has dtype {meta.get('dtype')}")
        lo, hi = meta["data_offsets"]
        shape = tuple(meta["shape"])
        size = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        if not 0 <= lo <= hi <= len(data) or hi - lo != size:
            raise ValueError(f"{path}: {name} spans bytes [{lo}, {hi}) of "
                             f"{len(data)}, shape {shape} needs {size}")
        a = np.frombuffer(data[lo:hi], np.dtype(dt).newbyteorder("<"))
        if meta["dtype"] == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.astype(a.dtype.newbyteorder("="), copy=True
                             ).reshape(shape)
    return out


def read_part(d: str) -> Dict[str, np.ndarray]:
    """Every tensor of a checkpoint part's ``*.safetensors`` files."""
    files = sorted(x for x in os.listdir(d) if x.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"{d}: no .safetensors files")
    out: Dict[str, np.ndarray] = {}
    for fname in files:
        out.update(read_safetensors(os.path.join(d, fname)))
    return out


# The *_twice rules run first: attn_joint. is a substring of
# attn_joint_twice.
_JOINT_RENAMES = (("attn_joint_twice.", "attn_joint_mid."),
                  ("norm_joint_twice.", "norm_joint_mid."),
                  ("attn_joint.", "attn_joint_last."),
                  ("norm_joint.", "norm_joint_last."))


def rename_joint_keys(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Wonder3D's joint-attention training names → the module names."""
    out = {}
    for k, v in state.items():
        for old, new in _JOINT_RENAMES:
            if old in k:
                k = k.replace(old, new)
                break
        out[k] = v
    return out


_DEPRECATED_ATTN = (("query.", "to_q."), ("key.", "to_k."),
                    ("value.", "to_v."), ("proj_attn.", "to_out.0."))


def convert_deprecated_attention(state: Dict[str, np.ndarray]
                                 ) -> Dict[str, np.ndarray]:
    """Old-style attention keys, inside ``attentions.`` blocks only, renamed
    to the modern ones (a pure rename: the shapes agree)."""
    out = {}
    for k, v in state.items():
        if ".attentions." in k:
            for old, new in _DEPRECATED_ATTN:
                if "." + old in k:
                    k = k.replace("." + old, "." + new)
                    break
        out[k] = v
    return out


def load_part(module: torch.nn.Module, part: str,
              state: Dict[str, np.ndarray]) -> None:
    """The renames of ``part`` (``unet``, ``vae`` or ``image_encoder``),
    then a strict load into ``module`` (each tensor cast to the module's
    dtype and device)."""
    if part == "unet":
        state = rename_joint_keys(state)
    if part in ("unet", "vae"):
        state = convert_deprecated_attention(state)
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in state.items() if not k.endswith("position_ids")}
    module.load_state_dict(state, strict=True)


def load_wonder3d(ckpt_dir: str, unet: torch.nn.Module, vae: torch.nn.Module,
                  clip: torch.nn.Module) -> None:
    """Load ``ckpt_dir``'s three parts strictly into the modules."""
    for part, module in (("unet", unet), ("vae", vae),
                         ("image_encoder", clip)):
        sub = os.path.join(ckpt_dir, part)
        if not os.path.isdir(sub):
            raise FileNotFoundError(f"{ckpt_dir}: no {part}/ directory")
        load_part(module, part, read_part(sub))

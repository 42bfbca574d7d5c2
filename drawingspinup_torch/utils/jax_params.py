"""Convert a flax ``{params, batch_stats}`` tree of the stage-3 models
into the port's ``state_dict``.

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

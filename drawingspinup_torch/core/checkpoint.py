"""Checkpoint save/restore for the port: one ``torch.save`` file per step
(counterpart of ``drawingspinup_tpu/core/checkpoint.py``, which uses
orbax directories)."""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

SUFFIX = ".pt"


def save(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` (tensors / plain containers) to ``path`` atomically:
    a crash mid-write leaves the previous file, never a torn one."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore(path: str, map_location: Any = "cpu") -> Dict[str, Any]:
    """Load a file written by ``save``; tensors only, no pickled code."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def latest_step(root: str, prefix: str = "step_") -> Optional[int]:
    """Highest N of the ``<root>/<prefix>N.pt`` files on disk."""
    if not os.path.isdir(root):
        return None
    pat = re.compile(re.escape(prefix) + r"(\d+)" + re.escape(SUFFIX) + "$")
    steps = [int(m.group(1)) for m in map(pat.match, os.listdir(root)) if m]
    return max(steps) if steps else None

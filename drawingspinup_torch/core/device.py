"""Device and precision setup for the port's entry points.

The device is always explicit: ``"cuda"`` by default, ``"cpu"`` only when a
caller asks for it (the CPU tests). A CUDA request on a host without CUDA
raises; nothing falls back to the CPU.

TF32 is switched off for matmuls and cuDNN convolutions. cuDNN's TF32
default would run GeneratorJ's convs and the 1×1 head at about three
decimal digits, while the JAX reference computes them in full f32.

cuDNN is held to deterministic algorithms (and not autotuned): some of its
backward convolutions sum with atomics, and the JAX pipeline gives the
same bits from run to run. The RIC kernels are deterministic by design.
"""
from __future__ import annotations

from typing import Union

import torch


def setup(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Resolve ``device`` and pin f32 math; raises if CUDA is asked for and
    missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev

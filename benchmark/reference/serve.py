"""Plain PyTorch frame serving: a (H, W, 7) u8 source stack (RGBA, edge,
position x and y) → the generator's input features, the eval-mode forward,
tanh, and the u8 RGBA frame, quantised as 8-bit PNGs are written
(``round(255 · v)``, half up).

Written for the benchmark from the semantics the port states in
``drawingspinup_torch/train/gan.py::full_frame_features`` and
``generate_full_rgba`` at commit 87d0b89; imports nothing of the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference import models


def features(stack: torch.Tensor, cfg: Dict
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u8 (H, W, 7) on the device → ((1, H, W, C) f32 features, (H, W)
    alpha): RGB to [-1, 1] with edge pixels (edge < 255) black where the
    configuration uses edges, alpha, position to [-1, 1]."""
    f = stack.to(torch.float32) / 255.0
    rgb, alpha = f[..., 0:3], f[..., 3]
    if cfg["use_edge"]:
        rgb = torch.where((stack[..., 4] < 255)[..., None],
                          torch.zeros_like(rgb), rgb)
    feats = [rgb * 2.0 - 1.0]
    if cfg["use_mask"]:
        feats.append(alpha[..., None])
    if cfg["use_pos"]:
        feats.append(f[..., 5:7] * 2.0 - 1.0)
    return torch.cat(feats, dim=-1)[None], alpha


def quantise(v: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats → u8, half up."""
    return torch.floor(torch.clamp(v, 0.0, 1.0) * 255.0 + 0.5).to(
        torch.uint8)


@torch.no_grad()
def frame(weights: Dict[str, torch.Tensor], stack: torch.Tensor,
          cfg: Dict) -> torch.Tensor:
    """The served (H, W, 4) u8 RGBA frame of one source stack."""
    models.plain_f32()
    x, alpha = features(stack, cfg)
    out = models.generator(weights, x, cfg, training=False)[0]
    return torch.cat([quantise((out + 1.0) * 0.5), quantise(alpha)[..., None]],
                     dim=-1)


@torch.no_grad()
def pre_tanh_stats(weights: Dict[str, torch.Tensor], stack: torch.Tensor,
                   cfg: Dict) -> Tuple[float, float]:
    """(mean, std) of the generator's output before tanh on one stack."""
    models.plain_f32()
    x, _ = features(stack, cfg)
    y = models.generator(weights, x, {**cfg, "tanh": False}, training=False)
    return float(y.mean()), float(y.std())

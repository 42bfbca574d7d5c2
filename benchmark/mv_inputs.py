"""Seeded inputs of the stage-2a cell: the drawings of the seed's character
and the weights of the UNet, the VAE and CLIP, made on the device.

Drawings: distinct frames of ``inputs.frame_stacks``' animation of the
seed's character, each RGBA composited on white as stage 2a's
``load_input`` does (RGB darkened ×0.8 under alpha).

Weights: every parameter that ``reference/mv.py`` lists, drawn from the
seed in one call: weights normal with std 1/√fan-in, biases 0.1·N(0, 1),
norm scales 1 + 0.1·N(0, 1) and shifts 0.1·N(0, 1), CLIP's class and
position tables 0.02·N(0, 1). Nothing is zero: the joint attentions' output
projections, which Wonder3D and the port's ``seeded_init`` start at zero,
are drawn like the rest, so the cross-domain fold adds to the output. The
UNet's query and key projections are drawn at ``QK_SPREAD`` times that
spread: at 1/√fan-in the logits spread by ~1 and a view's queries average
the 6144 keys of the views fold nearly evenly, where a trained multi-view
UNet attends to the matching parts of the other views; at 2 the logits
spread by ~4 and the attention is selective. ``scale_head`` then scales a
head so that its output has a chosen spread. Nothing here imports the
program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark import inputs
from benchmark.reference import mv as ref

Weights = Dict[str, torch.Tensor]
PARTS = {"unet": ref.unet_shapes, "vae": ref.vae_shapes,
         "clip": ref.clip_shapes}
QK_SPREAD = 2.0


def drawings(cfg: Dict, count: int, seed: int, device) -> torch.Tensor:
    """(count, size, size, 3) f32 drawings in [0, 1] on ``device``."""
    size = cfg["image_size"]
    stacks = torch.from_numpy(inputs.frame_stacks(size, count, seed,
                                                  device)).to(device)
    rgba = stacks[..., :4].float() / 255.0
    alpha = rgba[..., 3:4]
    return rgba[..., :3] * 0.8 * alpha + (1.0 - alpha)


def _draw(shapes: List[ref.Shape], g: torch.Generator,
          device) -> Weights:
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    flat = torch.randn((total,), generator=g, device=device)
    out, at = {}, 0
    for name, shape, fan, kind in shapes:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        if kind == "w":
            v = v / math.sqrt(fan)
        elif kind in ("b", "nb"):
            v = 0.1 * v
        elif kind == "nw":
            v = 1.0 + 0.1 * v
        else:
            v = 0.02 * v
        out[name] = v.contiguous()
        at += n
    return out


def weights(cfg: Dict, seed: int, device) -> Dict[str, Weights]:
    """{"unet", "vae", "clip"}: each part's parameters by the port's
    state-dict names, one generator for all three in that order."""
    g = inputs.rng(seed, 9, device)
    out = {part: _draw(shapes(cfg), g, device)
           for part, shapes in PARTS.items()}
    for name, v in out["unet"].items():
        if name.endswith((".to_q.weight", ".to_k.weight")):
            v.mul_(QK_SPREAD)
    return out


@torch.no_grad()
def scale_head(w: Weights, name: str, out: torch.Tensor,
               target_std: float) -> None:
    """Scale the convolution ``name`` (weight and bias) so that its output
    ``out`` would have mean 0 and spread ``target_std``."""
    k = target_std / float(out.std())
    w[f"{name}.weight"].mul_(k)
    w[f"{name}.bias"].copy_(k * (w[f"{name}.bias"] - out.mean(
        dim=(0, 2, 3))))

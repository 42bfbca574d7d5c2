"""Seeded inputs of the stage-3 cells, made on the device in a few large
calls: a character at the frame size (silhouette, colours, the position
pass, the contour), its rest-pose keyframe and "post" drawing, an
animation of distinct frames as u8 source stacks, and the weights of every
model.

The same seed gives the same inputs; every seed gives the same sizes, so
the work of a run does not depend on the seed. Nothing here imports the
program: the weights are dicts keyed by the port's state-dict names, loaded
into the port with ``load_state_dict`` and handed unchanged to the plain
reference.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
_SEED_MASK = (1 << 63) - 1


def stream(seed: int, k: int) -> int:
    """The seed of sub-stream ``k`` of a run seeded ``seed``."""
    return (seed * 1_000_003 + 7919 * k) & _SEED_MASK


def rng(seed: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, k))


# ---------------------------------------------------------------------------
# the character
# ---------------------------------------------------------------------------

def _ellipses(g: torch.Generator, device) -> torch.Tensor:
    """(P, 5) parts in [-1, 1]² coordinates: centre y, x, radii, angle:
    a torso, a head, two arms, two legs, jittered."""
    base = torch.tensor([
        [0.10, 0.00, 0.30, 0.20, 0.0],     # torso
        [-0.42, 0.00, 0.16, 0.15, 0.0],    # head
        [0.00, -0.32, 0.26, 0.07, 0.9],    # arms
        [0.00, 0.32, 0.26, 0.07, -0.9],
        [0.55, -0.12, 0.28, 0.08, 0.15],   # legs
        [0.55, 0.12, 0.28, 0.08, -0.15]], device=device)
    jitter = torch.rand(base.shape, generator=g, device=device) - 0.5
    return base + jitter * torch.tensor([0.06, 0.06, 0.08, 0.03, 0.5],
                                        device=device)


def character(size: int, seed: int, device) -> torch.Tensor:
    """(6, size, size) f32 rest pose: RGB, alpha (soft-edged silhouette),
    position x and y (the body's own coordinates, as a position pass
    renders them)."""
    g = rng(seed, 1, device)
    t = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) \
        / size * 2 - 1
    yy, xx = torch.meshgrid(t, t, indexing="ij")
    inside = torch.full_like(yy, -1e9)
    part = torch.zeros_like(yy, dtype=torch.long)
    for i, (cy, cx, ry, rx, a) in enumerate(_ellipses(g, device).tolist()):
        dy, dx = yy - cy, xx - cx
        u = (dy * math.cos(a) + dx * math.sin(a)) / ry
        v = (-dy * math.sin(a) + dx * math.cos(a)) / rx
        s = 1 - torch.sqrt(u * u + v * v)
        part = torch.where(s > inside, i, part)
        inside = torch.maximum(inside, s)
    alpha = torch.clamp(inside * size * 0.08 + 0.5, 0, 1)
    palette = torch.rand((6, 3), generator=g, device=device)
    low = F.interpolate(torch.rand((1, 3, 8, 8), generator=g, device=device),
                        size=(size, size), mode="bilinear",
                        align_corners=False)[0]
    rgb = 0.7 * palette[part].permute(2, 0, 1) + 0.3 * low
    rgb = rgb * alpha + (1 - alpha)
    return torch.cat([rgb, alpha[None], ((xx + 1) / 2)[None],
                      ((yy + 1) / 2)[None]], dim=0)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(x, 0, 1) * 255 + 0.5).to(torch.uint8)


def _contour(alpha: torch.Tensor) -> torch.Tensor:
    """u8 edge pass of (N, 1, H, W) alpha: 0 on the silhouette's outline
    (a 3×3 dilation that differs from the 3×3 erosion), 255 elsewhere."""
    m = (alpha > 0.5).float()
    dil = F.max_pool2d(m, 3, 1, 1)
    ero = -F.max_pool2d(-m, 3, 1, 1)
    return torch.where(dil > ero, 0, 255).to(torch.uint8)


def frame_stacks(size: int, frames: int, seed: int, device,
                 chunk: int = 8) -> np.ndarray:
    """(frames, size, size, 7) u8 source stacks of an animation of the
    seed's character: RGBA, edge, position x and y, each frame the rest
    pose turned and moved by its own amount (distinct frames)."""
    base = character(size, seed, device)[None]
    g = rng(seed, 2, device)
    phase = torch.rand((2,), generator=g, device=device) * 2 * math.pi
    out = np.empty((frames, size, size, 7), np.uint8)
    for f0 in range(0, frames, chunk):
        f = torch.arange(f0, min(f0 + chunk, frames), device=device,
                         dtype=torch.float32)
        ang = 0.35 * torch.sin(2 * math.pi * f / frames + phase[0])
        shift = 0.08 * torch.sin(4 * math.pi * f / frames + phase[1])
        theta = torch.zeros((len(f), 2, 3), device=device)
        theta[:, 0, 0] = torch.cos(ang)
        theta[:, 0, 1] = -torch.sin(ang)
        theta[:, 1, 0] = torch.sin(ang)
        theta[:, 1, 1] = torch.cos(ang)
        theta[:, 0, 2] = shift
        theta[:, 1, 2] = 0.5 * shift
        grid = F.affine_grid(theta, (len(f), 6, size, size),
                             align_corners=False)
        img = F.grid_sample(base.expand(len(f), -1, -1, -1), grid,
                            align_corners=False)
        alpha = img[:, 3:4]
        rgb = img[:, 0:3] + (1 - alpha)         # on white, as rendered
        stack = torch.cat([_to_u8(rgb), _to_u8(alpha), _contour(alpha),
                           _to_u8(img[:, 4:6])], dim=1)
        out[f0:f0 + len(f)] = stack.permute(0, 2, 3, 1).cpu().numpy()
    return out


def keyframe_images(size: int, seed: int, device
                    ) -> Dict[str, np.ndarray]:
    """u8 images of the rest-pose keyframe: ``color`` RGBA (the render),
    ``pos`` RGB (the position pass), ``edge`` gray (the contour) and
    ``post`` RGBA (the character drawing the translator learns: the
    render's shapes in other colours, with strokes)."""
    ch = character(size, seed, device)
    g = rng(seed, 3, device)
    alpha = ch[3:4]
    tint = torch.rand((3, 1, 1), generator=g, device=device)
    strokes = F.interpolate(torch.rand((1, 1, 64, 64), generator=g,
                                       device=device), size=(size, size),
                            mode="nearest")[0]
    drawn = torch.clamp(0.6 * ch[0:3] + 0.4 * tint - 0.15 * strokes, 0, 1)
    drawn = drawn * alpha + (1 - alpha)
    pos = torch.cat([ch[4:6], torch.zeros_like(alpha)], dim=0)
    imgs = {"color": torch.cat([ch[0:3], alpha], 0),
            "pos": pos,
            "post": torch.cat([drawn, alpha], 0)}
    out = {k: _to_u8(v).permute(1, 2, 0).cpu().numpy()
           for k, v in imgs.items()}
    out["edge"] = _contour(alpha[None])[0, 0].cpu().numpy()
    return out


def write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path, compress_level=1)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _conv_shapes(cfg: Dict) -> List[Tuple[str, tuple, int]]:
    """(name, shape, fan-in) of every convolution weight of ``cfg``'s
    generator, in the port's state-dict names and layouts: RIC kernels
    (9, C, O), cuDNN weights (O, C, k, k), the head (3, C, 1, 1)."""
    from benchmark.work import generator_layers

    out = []
    for l in generator_layers(cfg, cfg["frame_size"], training=True):
        if l.kind == "ric":
            out.append((f"{l.name}.kernel", (9, l.c, l.o), 9 * l.c))
        else:
            out.append((f"{l.name}.weight", (l.o, l.c, l.k, l.k),
                        l.c * l.k * l.k))
    return out


def _bn_names(cfg: Dict) -> List[Tuple[str, int]]:
    """(prefix, features) of every batch norm of ``cfg``'s generator."""
    f, blocks = cfg["filters"], cfg["resnet_blocks"]
    if cfg["generator"] == "GeneratorJ_RIC":
        names = [("bn0", f[0]), ("bn1", f[1]), ("bn2", f[2])]
        names += [(f"res{i}_bn", f[2]) for i in range(blocks)]
        names += [("up2_bn", f[4]), ("up1_bn", f[4])]
    else:
        names = [("conv0.norm", f[0]), ("conv1.norm", f[1]),
                 ("conv2.norm", f[2])]
        names += [(f"res{i}_conv0.norm", f[2]) for i in range(blocks)]
        names += [("upconv2.norm", f[4]), ("upconv1.norm", f[4])]
    if cfg["append_smoothers"]:
        names.append(("smooth_bn", f[5]))
    return names


def _he(shapes: List[Tuple[str, tuple, int]], g: torch.Generator,
        device) -> Weights:
    """He-normal weights (variance 2 / fan-in, clipped at ±2σ) for every
    shape, drawn in one call and cut into leaves."""
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn((total,), generator=g, device=device).clamp_(-2, 2)
    out, at = {}, 0
    for name, shape, fan in shapes:
        n = math.prod(shape)
        std = math.sqrt(2.0 / fan) / 0.87962566103423978
        out[name] = (flat[at:at + n] * std).view(shape)
        at += n
    return out


def generator_weights(cfg: Dict, seed: int, device,
                      trained: bool) -> Weights:
    """``cfg``'s generator at its published widths. Untrained: He-normal
    convolutions, batch norms at 1, 0 with running statistics 0, 1, the
    head's bias 0 (the state a training run starts from). Trained: batch
    norms with spread affine parameters and running statistics, as a
    trained translator has them (the head is then scaled by
    ``rescale_head``)."""
    g = rng(seed, 4, device)
    w = _he(_conv_shapes(cfg), g, device)
    w["head.bias"] = torch.zeros((3,), device=device)
    bns = _bn_names(cfg)
    n = sum(c for _, c in bns)
    r = torch.randn((4, n), generator=g, device=device)
    u = torch.rand((n,), generator=g, device=device)
    at = 0
    for name, c in bns:
        sl = slice(at, at + c)
        if trained:
            w[f"{name}.weight"] = 1 + 0.1 * r[0, sl]
            w[f"{name}.bias"] = 0.1 * r[1, sl]
            w[f"{name}.running_mean"] = 0.1 * r[2, sl]
            w[f"{name}.running_var"] = 0.5 + u[sl]
        else:
            w[f"{name}.weight"] = torch.ones((c,), device=device)
            w[f"{name}.bias"] = torch.zeros((c,), device=device)
            w[f"{name}.running_mean"] = torch.zeros((c,), device=device)
            w[f"{name}.running_var"] = torch.ones((c,), device=device)
        at += c
    return {k: v.contiguous() for k, v in w.items()}


def rescale_head(w: Weights, mean: float, std: float,
                 target_std: float = 0.5) -> None:
    """Scale the head so that an output of (``mean``, ``std``) before tanh
    becomes (0, ``target_std``): random weights otherwise drive most
    pixels into tanh's flat ends, where a comparison of u8 frames checks
    little."""
    k = target_std / std
    w["head.weight"].mul_(k)
    w["head.bias"].copy_(k * (w["head.bias"] - mean))


def discriminator_weights(cfg: Dict, seed: int, device) -> Weights:
    from benchmark.work import discriminator_layers

    layers = discriminator_layers(cfg, cfg["patch_size"])
    g = rng(seed, 5, device)
    w = _he([(f"{l.name}.weight", (l.o, l.c, l.k, l.k), l.c * l.k * l.k)
             for l in layers], g, device)
    for l in layers:
        w[f"{l.name}.bias"] = torch.zeros((l.o,), device=device)
    return w


def vgg_weights(seed: int, device) -> Weights:
    """The VGG19 prefix's three convolutions, random (no ImageNet weights
    in the checkout), biases small and random."""
    from benchmark.work import vgg_layers

    layers = vgg_layers(32)
    g = rng(seed, 6, device)
    w = _he([(f"{l.name}.weight", (l.o, l.c, l.k, l.k), l.c * l.k * l.k)
             for l in layers], g, device)
    b = 0.01 * torch.randn((sum(l.o for l in layers),), generator=g,
                           device=device)
    at = 0
    for l in layers:
        w[f"{l.name}.bias"] = b[at:at + l.o].contiguous()
        at += l.o
    return w

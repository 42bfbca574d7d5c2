"""AutoencoderKL, the Stable-Diffusion VAE of stage 2a (counterpart of
``drawingspinup_tpu/models/vae.py``).

SD-1.x topology: a 128/256/512/512-channel encoder with a mid
self-attention, a 4-channel diagonal Gaussian latent, scaling factor
0.18215; the pipeline calls ``encode_mode`` (the mean, scaled) and
``decode``. Layout NCHW, f32; parameter names are diffusers'
(``encoder.down_blocks.0.resnets.0.conv1``,
``decoder.mid_block.attentions.0.to_q``, ``quant_conv``, …).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

SCALING_FACTOR = 0.18215


def _gn(ch: int) -> nn.GroupNorm:
    """GroupNorm(32), fewer groups for narrow test configs."""
    return nn.GroupNorm(min(32, ch), ch, eps=1e-6)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4


class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _gn(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _gn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over the H·W tokens, softmax(q·kᵀ/√C)·v,
    written out (the map is small: 32² tokens at 256² input)."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = _gn(ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        y = self.to_out[0](att @ v)
        return x + y.reshape(n, h, w, c).permute(0, 3, 1, 2)


class _Sampler(nn.Module):
    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride,
                              padding=0 if stride == 2 else 1)


class _Block(nn.Module):
    def __init__(self, resnets, sampler_name: str, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch), VAEResnet(ch, ch)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        bo = cfg.block_out_channels
        self.conv_in = nn.Conv2d(3, bo[0], 3, padding=1)
        blocks, cin = [], bo[0]
        for bi, ch in enumerate(bo):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VAEResnet(cin, ch))
                cin = ch
            blocks.append(_Block(resnets, "downsamplers",
                                 _Sampler(ch, 2) if bi < len(bo) - 1
                                 else None))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(bo[-1])
        self.conv_norm_out = _gn(bo[-1])
        self.conv_out = nn.Conv2d(bo[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                # SD pads the downsampling convs asymmetrically, (0, 1)
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        bo = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.latent_channels, bo[-1], 3, padding=1)
        self.mid_block = _MidBlock(bo[-1])
        blocks, cin = [], bo[-1]
        for bi, ch in enumerate(reversed(bo)):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnet(cin, ch))
                cin = ch
            blocks.append(_Block(resnets, "upsamplers",
                                 _Sampler(ch, 1) if bi < len(bo) - 1
                                 else None))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _gn(bo[0])
        self.conv_out = nn.Conv2d(bo[0], 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(
                    F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) in [-1, 1] → the mode of the latent Gaussian, scaled:
        (N, 4, H/8, W/8)."""
        moments = self.quant_conv(self.encoder(x))
        return moments[:, :self.cfg.latent_channels] * SCALING_FACTOR

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z / SCALING_FACTOR))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode_mode(x))

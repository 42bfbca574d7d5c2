"""The stage-2a multi-view conditioned diffusion UNet (counterpart of
``drawingspinup_tpu/models/unet_mv2d.py``, Wonder3D's
``mvdiffusion/models/unet_mv2d_condition.py``).

SD-1.5 image-variation topology with MV transformer blocks: conv_in (8
channels: 4 noise ⊕ 4 condition-image latents) → time and class embeddings
(sinusoidal timesteps; camera sincos ⊕ task one-hots through an MLP) → 3
cross-attention down blocks and a plain one → mid block (optional
cross-domain attention) → mirrored up blocks with skip concatenations →
GroupNorm, SiLU, conv_out (4).

Layout NCHW; parameter names are diffusers' (``conv_in``,
``time_embedding.linear_1``, ``down_blocks.0.resnets.0.conv1``,
``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q``, …), so a
Wonder3D ``unet/`` checkpoint loads strictly
(``utils/diffusers_port.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from drawingspinup_torch.models.attention_mv import TransformerMV2D


@dataclasses.dataclass(frozen=True)
class UNetMVConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    projection_class_embeddings_input_dim: int = 10
    num_views: int = 6
    sparse_mv_attention: bool = False
    # joint (cross-domain) attention in every transformer block, mid or
    # last placement; the Wonder3D-joint checkpoint trains the mid one
    cd_attention_mid: bool = True
    cd_attention_last: bool = False


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True, shift=0): [cos | sin], in
    f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class TimestepEmbedMLP(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=1e-5)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(32, cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A down or up block: ``resnets``, ``attentions`` (or none), and its
    ``downsamplers``/``upsamplers``, under diffusers' names."""

    def __init__(self, resnets, attentions, sampler_name: str,
                 sampler: Optional[nn.Module]):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _MidBlock(nn.Module):
    def __init__(self, ch: int, temb: int, attention: nn.Module):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, temb),
                                      ResnetBlock2D(ch, ch, temb)])
        self.attentions = nn.ModuleList([attention])


class UNetMV2D(nn.Module):
    def __init__(self, cfg: UNetMVConfig = UNetMVConfig()):
        super().__init__()
        self.cfg = c = cfg
        bo = c.block_out_channels
        temb = bo[0] * 4

        def transformer(ch):
            return TransformerMV2D(
                ch, c.attention_heads, cross_dim=c.cross_attention_dim,
                num_views=c.num_views,
                sparse_mv_attention=c.sparse_mv_attention,
                cd_attention_mid=c.cd_attention_mid,
                cd_attention_last=c.cd_attention_last)

        self.conv_in = nn.Conv2d(c.in_channels, bo[0], 3, padding=1)
        self.time_embedding = TimestepEmbedMLP(bo[0], temb)
        self.class_embedding = TimestepEmbedMLP(
            c.projection_class_embeddings_input_dim, temb)

        n = len(bo)
        skips = [bo[0]]
        cin = bo[0]
        down = []
        for bi, ch in enumerate(bo):
            final = bi == n - 1
            resnets, attns = [], []
            for _ in range(c.layers_per_block):
                resnets.append(ResnetBlock2D(cin, ch, temb))
                cin = ch
                if not final:
                    attns.append(transformer(ch))
                skips.append(ch)
            down.append(_Block(resnets, attns, "downsamplers",
                               None if final else Downsample(ch)))
            if not final:
                skips.append(ch)
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _MidBlock(bo[-1], temb, transformer(bo[-1]))

        up = []
        prev = bo[-1]
        for bi, ch in enumerate(reversed(bo)):
            first = bi == 0
            resnets, attns = [], []
            for _ in range(c.layers_per_block + 1):
                resnets.append(ResnetBlock2D(prev + skips.pop(), ch, temb))
                prev = ch
                if not first:
                    attns.append(transformer(ch))
            up.append(_Block(resnets, attns, "upsamplers",
                             Upsample(ch) if bi < n - 1 else None))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(32, bo[0], eps=1e-5)
        self.conv_out = nn.Conv2d(bo[0], c.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps,
                encoder_hidden_states: torch.Tensor,
                class_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample (B, 8, H, W); timesteps (B,), a scalar tensor or an int;
        encoder_hidden_states (B, S, cross_dim) CLIP tokens; class_labels
        (B, proj_dim) camera ⊕ task sincos embeddings. All in one dtype."""
        c = self.cfg
        min_hw = 1 << (len(c.block_out_channels) - 1)
        if sample.shape[2] < min_hw or sample.shape[3] < min_hw:
            raise ValueError(
                f"latent {sample.shape[2]}×{sample.shape[3]} too small for "
                f"{len(c.block_out_channels)} UNet levels (needs ≥ {min_hw}): "
                "skip connections cannot align once a downsample floors at 1")
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        # sincos in f32, then the compute dtype, as JAX's
        temb = timestep_embedding(timesteps, c.block_out_channels[0]
                                  ).to(sample.dtype)
        temb = self.time_embedding(temb)
        if class_labels is not None:
            temb = temb + self.class_embedding(class_labels.to(sample.dtype))

        h = self.conv_in(sample)
        skips = [h]
        for blk in self.down_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(h, temb)
                if blk.attentions is not None:
                    h = blk.attentions[li](h, encoder_hidden_states)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, encoder_hidden_states)
        h = mid.resnets[1](h, temb)

        for blk in self.up_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if blk.attentions is not None:
                    h = blk.attentions[li](h, encoder_hidden_states)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))

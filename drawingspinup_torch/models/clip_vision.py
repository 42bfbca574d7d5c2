"""CLIP vision encoder with projection, stage 2a's image conditioning
(counterpart of ``drawingspinup_tpu/models/clip_vision.py``: ViT-L/14 at
224, hidden 1024, projection 768, as transformers'
``CLIPVisionModelWithProjection``, whose parameter names it carries:
``vision_model.embeddings.patch_embedding``,
``vision_model.encoder.layers.0.self_attn.q_proj``, ``visual_projection``,
…). f32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from drawingspinup_torch.ops.image import resize

# CLIP preprocessing constants (openai/clip-vit-large-patch14 processor)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    projection_dim: int = 768


def preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) float [0, 1] → normalised (B, 3, size, size): the
    bicubic resize of ``ops/image.py`` (``jax.image.resize``'s), then the
    CLIP mean and std."""
    x = resize(images, (size, size))
    mean = torch.tensor(IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=x.dtype, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


class CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2)

        att = F.scaled_dot_product_attention(
            split(self.q_proj(x)), split(self.k_proj(x)),
            split(self.v_proj(x)))
        return self.out_proj(att.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))   # quick_gelu


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = CLIPAttention(d, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = CLIPMLP(d, d * cfg.mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding(
            (cfg.image_size // p) ** 2 + 1, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1,
                                                                          2)
        cls = self.class_embedding.expand(b, 1, -1)
        return torch.cat([cls, patches], dim=1) \
            + self.position_embedding.weight[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.embeddings = CLIPEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(d, eps=1e-5)  # transformers' name
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(d, eps=1e-5)


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size,
                                           cfg.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, size, size) preprocessed → (B, projection_dim) image
        embeddings."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixel_values))
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))

"""Stage-3 style translator: configuration, generator construction,
full-frame inference and checkpoints (counterpart of
``drawingspinup_tpu/train/gan.py``). The patch-GAN training step comes
with the backward RIC conv kernel."""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from drawingspinup_torch.core import checkpoint as ckpt
from drawingspinup_torch.models.generator_j import GeneratorJ, GeneratorJ_RIC


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Same fields and defaults as the JAX ``GANConfig`` (a test pins
    them), so configs move between the two packages. Inference reads the
    generator fields and ``input_channels``; ``compute_dtype`` must be
    float32 (bf16 is not ported); ``ric_variant`` names a JAX schedule and
    is not read here: RIC convs run the CUDA kernel on the GPU."""
    generator: str = "GeneratorJ_RIC"      # GeneratorJ | GeneratorJ_RIC
    filters: Tuple[int, ...] = (32, 64, 128, 128, 128, 64)
    resnet_blocks: int = 7
    tanh: bool = True
    append_smoothers: bool = True
    input_channels: int = 6                # 3 rgb + 1 mask + 2 pos
    disc_filters: int = 12
    disc_layers: int = 2
    lr: float = 4e-4
    weight_decay: float = 1e-5
    batch_size: int = 40
    patch_size: int = 32
    reconstruction_weight: float = 4.0
    perception_weight: float = 6.0
    adversarial_weight: float = 0.5
    log_interval: int = 1000
    eval_frame_limit: Optional[int] = 8
    epochs: int = 3
    use_image_loss: bool = True
    vgg_npz: Optional[str] = None
    compute_dtype: str = "float32"
    ric_variant: str = "pallas"


Generator = Union[GeneratorJ, GeneratorJ_RIC]


def build_generator(cfg: GANConfig, device: Union[str, torch.device],
                    generator: Optional[torch.Generator] = None
                    ) -> Generator:
    """The configured generator in eval mode, randomly initialised from
    ``generator`` (a ``torch.Generator`` on ``device``)."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r}: only float32 is ported")
    cls = {"GeneratorJ": GeneratorJ, "GeneratorJ_RIC": GeneratorJ_RIC}[
        cfg.generator]
    model = cls(filters=cfg.filters, resnet_blocks=cfg.resnet_blocks,
                tanh=cfg.tanh, append_smoothers=cfg.append_smoothers,
                input_channels=cfg.input_channels, device=device,
                generator=generator)
    return model.eval().requires_grad_(False)


def full_frame_features(x_u8: np.ndarray, use_mask: bool, use_pos: bool,
                        use_edge: bool, device: Union[str, torch.device]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (H, W, 7) uint8 source stack of
    ``stage3_data.load_full_frame_u8`` → ((1, H, W, C_in) f32 generator
    input, (H, W) f32 alpha), on ``device``.

    Same math as the JAX ``_full_frame_runner_u8``: features from u8/255,
    edge pixels (u8 < 255) blacked out, alpha is the pre-overlay alpha."""
    xt = torch.from_numpy(np.ascontiguousarray(x_u8)).to(device)
    f = xt.to(torch.float32) / 255.0
    rgb, alpha = f[..., 0:3], f[..., 3]
    if use_edge:
        rgb = torch.where((xt[..., 4] < 255)[..., None], 0.0, rgb)
    feats = [rgb * 2.0 - 1.0]
    if use_mask:
        feats.append(alpha[..., None])
    if use_pos:
        feats.append(f[..., 5:7] * 2.0 - 1.0)
    return torch.cat(feats, dim=-1)[None], alpha


@torch.no_grad()
def generate_full_rgba(model: Generator, x_u8: np.ndarray, use_mask: bool,
                       use_pos: bool, use_edge: bool) -> np.ndarray:
    """Stylize one full frame: the (H, W, 7) uint8 source stack →
    (H, W, 4) uint8 RGBA, quantized as ``write_image`` quantizes."""
    device = next(model.parameters()).device
    x, alpha = full_frame_features(x_u8, use_mask, use_pos, use_edge, device)
    out = model(x)[0]
    rgb8 = (torch.clamp((out + 1.0) * 0.5, 0.0, 1.0) * 255.0 + 0.5).to(
        torch.uint8)
    a8 = (alpha * 255.0 + 0.5).to(torch.uint8)
    return torch.cat([rgb8, a8[..., None]], dim=-1).cpu().numpy()


def checkpoint_path(log_dir: str, step: int) -> str:
    return os.path.join(log_dir, f"model_{step:05d}{ckpt.SUFFIX}")


def save_checkpoint(log_dir: str, model: Generator, step: int) -> None:
    ckpt.save(checkpoint_path(log_dir, step), model.state_dict())


def load_checkpoint(log_dir: str, model: Generator,
                    step: Optional[int] = None) -> Generator:
    """Load ``model_{step:05d}.pt`` (the latest step if None) into
    ``model``; every key must match."""
    if step is None:
        step = ckpt.latest_step(log_dir, prefix="model_")
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {log_dir}")
    device = next(model.parameters()).device
    model.load_state_dict(ckpt.restore(checkpoint_path(log_dir, step),
                                       map_location=device))
    return model

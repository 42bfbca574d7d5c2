"""Stage-1 contour-segmentation trainer (LaMa-style): the port of
``drawingspinup_tpu/train/lama.py``.

The FFC ResNet generator learns the contour probability, supervised: BCE
on the probability clipped to [1e-6, 1 − 1e-6] plus ``dice_weight`` × a
dice loss taken over the whole batch, with Adam (optax ``adam``'s update:
bias-corrected moments, eps 1e-8 outside the square root). Its batch
norms run on the batch's statistics and move their running statistics
once a step (one generator forward), as flax's ``mutable=["batch_stats"]``
does.

The FFC discriminator and its Adam state are built as JAX's
``init_state`` builds them, but ``adversarial_weight > 0`` raises: JAX's
own adversarial branch applies the discriminator with ``{"params": ...}``
only, and its batch norms then fail on the missing ``batch_stats``
(``ScopeCollectionNotFound``; ``ROADMAP.md``, queue 3). The port adds no
branch that the reference cannot run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import numpy as np
import torch

from drawingspinup_torch.models.ffc import (BatchNorm2d,
                                            FFCNLayerDiscriminator,
                                            FFCResNetGenerator)


@dataclasses.dataclass(frozen=True)
class LamaTrainConfig:
    ngf: int = 64
    n_downsampling: int = 3
    n_blocks: int = 9
    resnet_ratio: float = 0.75
    lr: float = 1e-3
    disc_lr: float = 1e-4
    batch_size: int = 8
    adversarial_weight: float = 0.0  # 0 = pure supervised
    feature_matching_weight: float = 10.0
    dice_weight: float = 1.0
    steps: int = 3600


@dataclasses.dataclass
class LamaState:
    """The models (their parameters and batch-norm statistics), the two
    Adam optimizers (moments and counts) and the step count."""

    generator: FFCResNetGenerator
    discriminator: FFCNLayerDiscriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


def build_models(cfg: LamaTrainConfig
                 ) -> Tuple[FFCResNetGenerator, FFCNLayerDiscriminator]:
    """The generator (4 → 1, sigmoid) and the discriminator on the
    1-channel probability, on the CPU."""
    gen = FFCResNetGenerator(input_nc=4, output_nc=1, ngf=cfg.ngf,
                             n_downsampling=cfg.n_downsampling,
                             n_blocks=cfg.n_blocks,
                             resnet_ratio=cfg.resnet_ratio,
                             enable_lfu=False, add_out_act="sigmoid")
    disc = FFCNLayerDiscriminator(input_nc=1, ndf=max(cfg.ngf // 2, 8))
    return gen, disc


@torch.no_grad()
def init_weights(module: torch.nn.Module, generator: torch.Generator
                 ) -> None:
    """flax's initialisers, drawn on the CPU from ``generator``: conv and
    transposed-conv kernels ``he_normal`` and dense kernels
    ``lecun_normal`` (normals truncated at ±2 σ, σ = sqrt(s / fan-in) /
    0.8796, s = 2 and 1), zero biases, identity batch norm."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                          torch.nn.Linear)):
            w = m.weight
            fan_in = w.shape[0] * w[0, 0].numel() \
                if isinstance(m, torch.nn.ConvTranspose2d) else w[0].numel()
            scale = 1.0 if isinstance(m, torch.nn.Linear) else 2.0
            std = math.sqrt(scale / fan_in) / .87962566103423978
            t = torch.empty(w.shape)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            w.copy_(t)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1)


def make_optimizer(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax ``adam(lr)``: betas (0.9, 0.999), eps 1e-8 added to the
    bias-corrected second moment's square root."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def init_state(cfg: LamaTrainConfig, generator: torch.Generator,
               size: int = 512, device: Union[str, torch.device] = "cuda"
               ) -> LamaState:
    """Both models initialised from ``generator`` (generator first, as JAX
    splits its key) on ``device``, and their optimizers. ``size`` is the
    training crop, which the generator's down- and upsamplings must
    reproduce."""
    if size % 2 ** cfg.n_downsampling:
        raise ValueError(f"crop {size} is not a multiple of "
                         f"2^{cfg.n_downsampling}")
    gen, disc = build_models(cfg)
    init_weights(gen, generator)
    init_weights(disc, generator)
    gen, disc = gen.to(device).train(), disc.to(device).train()
    return LamaState(gen, disc, make_optimizer(gen, cfg.lr),
                     make_optimizer(disc, cfg.disc_lr))


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1.0
              ) -> torch.Tensor:
    """1 − (2 Σ pred·gt + eps) / (Σ pred + Σ gt + eps), summed over the
    whole batch."""
    inter = torch.sum(pred * gt)
    return 1.0 - (2 * inter + eps) / (torch.sum(pred) + torch.sum(gt) + eps)


def supervised_losses(cfg: LamaTrainConfig, pred: torch.Tensor,
                      gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The generator's loss on the probability ``pred`` against the 0/1
    mask ``gt`` (both (B, 1, H, W)): BCE on the clipped probability + the
    weighted dice."""
    p = torch.clamp(pred, 1e-6, 1 - 1e-6)
    bce = -torch.mean(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))
    dice = dice_loss(pred, gt)
    return {"g_loss": bce + cfg.dice_weight * dice, "bce": bce, "dice": dice}


def batch_tensors(batch: Dict[str, Union[np.ndarray, torch.Tensor]],
                  like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``BiCarDataset`` batch (NHWC ``input`` (B, H, W, 4), ``gt`` (B, H,
    W) or (B, H, W, 1)) → NCHW tensors of ``like``'s dtype and device."""
    x, gt = (torch.as_tensor(np.asarray(batch[k])) for k in ("input", "gt"))
    if gt.ndim == 3:
        gt = gt[..., None]
    return tuple(t.permute(0, 3, 1, 2).to(like).contiguous()
                 for t in (x, gt))


def train_step(cfg: LamaTrainConfig, state: LamaState,
               batch: Dict[str, Union[np.ndarray, torch.Tensor]]
               ) -> Tuple[LamaState, Dict[str, torch.Tensor]]:
    """One supervised step of the generator, in place on ``state``;
    returns it and the losses (``g_loss``, ``d_loss`` = 0, ``bce``,
    ``dice``) as 0-d tensors on the models' device. The batch is cast to
    the models' dtype (float64 for the accuracy checks)."""
    if cfg.adversarial_weight > 0:
        raise NotImplementedError(
            "LaMa training with adversarial_weight > 0: the JAX trainer "
            "this port follows fails on that branch "
            "(drawingspinup_tpu/train/lama.py applies the discriminator "
            "without its batch_stats: ScopeCollectionNotFound); see "
            "ROADMAP.md, queue 3")
    gen = state.generator.train()
    x, gt = batch_tensors(batch, next(gen.parameters()))
    # One generator forward a step, so that the batch-norm statistics move
    # once. JAX's adversarial branch runs a second forward for the
    # discriminator's input; a port of that branch must reuse this one's
    # output (detached) instead.
    logs = supervised_losses(cfg, gen(x), gt)
    state.g_opt.zero_grad(set_to_none=True)
    logs["g_loss"].backward()
    state.g_opt.step()
    state.step += 1
    logs = {k: v.detach() for k, v in logs.items()}
    logs["d_loss"] = torch.zeros((), dtype=x.dtype, device=x.device)
    return state, logs

"""Stage-3 style translator: configuration, models, the patch-GAN training
step, full-frame inference and checkpoints (counterpart of
``drawingspinup_tpu/train/gan.py``).

The step follows the JAX one (and the reference trainer):
  D step: MSE(D(masked fake), 0) + MSE(D(masked random-GT patch), 1)
  G step: recon_w·L1(G(pre), post) + perc_w·L2(VGG(G(pre)) − VGG(post))
          + adv_w·MSE(D(masked fake), 1), against the updated D
  AdamW lr 4e-4, betas (0.9, 0.999), weight decay 1e-5 on every leaf;
  batch 40 × 32² patches.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from drawingspinup_torch.core import checkpoint as ckpt
from drawingspinup_torch.core import weights_policy
from drawingspinup_torch.models.generator_j import (
    DiscriminatorN_IN, GeneratorJ, GeneratorJ_RIC, PerceptualVGG19,
    load_vgg_weights_npz,
)
from drawingspinup_torch.pipelines.stage3_data import (
    KeyframeData, sample_patches,
)

# Seed of the fixed random VGG features when no VGG19 weights are given
# (the JAX package seeds its own init with the same number).
VGG_SEED = 12345
LOSS_NAMES = ("d_loss", "g_loss", "image_loss", "perception_loss",
              "adversarial_loss")


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Same fields and defaults as the JAX ``GANConfig`` (a test pins
    them), so configs move between the two packages. ``compute_dtype``
    must be float32 (bf16 is not ported); ``ric_variant`` names a JAX
    schedule and is not read here: RIC convs run the CUDA kernels on the
    GPU."""
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


def _generator(cfg: GANConfig, device: Union[str, torch.device],
               generator: Optional[torch.Generator]) -> Generator:
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r}: only float32 is ported")
    cls = {"GeneratorJ": GeneratorJ, "GeneratorJ_RIC": GeneratorJ_RIC}[
        cfg.generator]
    return cls(filters=cfg.filters, resnet_blocks=cfg.resnet_blocks,
               tanh=cfg.tanh, append_smoothers=cfg.append_smoothers,
               input_channels=cfg.input_channels, device=device,
               generator=generator)


def build_generator(cfg: GANConfig, device: Union[str, torch.device],
                    generator: Optional[torch.Generator] = None
                    ) -> Generator:
    """The configured generator in eval mode, without gradients, randomly
    initialised from ``generator`` (a ``torch.Generator`` on ``device``)."""
    return _generator(cfg, device, generator).eval().requires_grad_(False)


def build_models(cfg: GANConfig, device: Union[str, torch.device],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Generator, DiscriminatorN_IN, PerceptualVGG19]:
    """G and D in training mode, initialised from ``generator``, and the
    frozen VGG taps with fixed random features (seed ``VGG_SEED``)."""
    gen = _generator(cfg, device, generator).train()
    disc = DiscriminatorN_IN(num_filters=cfg.disc_filters,
                             n_layers=cfg.disc_layers, device=device,
                             generator=generator)
    vgg = PerceptualVGG19(device=device, generator=torch.Generator(
        device=device).manual_seed(VGG_SEED))
    return gen, disc, vgg.eval().requires_grad_(False)


def resolve_vgg_npz(cfg: GANConfig) -> Optional[str]:
    """Real VGG19 feature weights (``cfg.vgg_npz``, else ``$DSU_VGG19_NPZ``)
    or None, reported as a fail-class degradation: the reference always
    trains against frozen ImageNet VGG19 features, and without them the
    perceptual loss uses fixed random ones. In strict mode (the training
    CLIs without ``--allow-degraded-weights``) that raises."""
    npz = cfg.vgg_npz or os.environ.get("DSU_VGG19_NPZ")
    if npz and os.path.exists(npz):
        return npz
    weights_policy.report_degraded(
        "gan-vgg19",
        "perceptual loss running with FIXED RANDOM VGG features (no VGG19 "
        "weights found — set DSU_VGG19_NPZ or GANConfig.vgg_npz to an npz "
        "from scripts/export_vgg19_npz.py to match the reference's "
        "ImageNet-VGG perceptual loss)", fail=True)
    return None


def make_optimizers(cfg: GANConfig, gen: Generator, disc: DiscriminatorN_IN
                    ) -> Tuple[torch.optim.AdamW, torch.optim.AdamW]:
    """optax ``adamw`` as torch AdamW: eps 1e-8, decoupled weight decay on
    every parameter (biases and norm scales included)."""
    def adamw(params):
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)

    return adamw(gen.parameters()), adamw(disc.parameters())


@dataclasses.dataclass
class TrainState:
    """G, D, the frozen VGG, the two optimizers and the step count. The
    modules and optimizers are updated in place by ``train_step``."""
    gen: Generator
    disc: DiscriminatorN_IN
    vgg: PerceptualVGG19
    g_opt: torch.optim.AdamW
    d_opt: torch.optim.AdamW
    step: int = 0


def init_state(cfg: GANConfig, device: Union[str, torch.device],
               seed: int = 0) -> TrainState:
    """Fresh models from ``seed``, VGG19 weights overlaid when available."""
    gen, disc, vgg = build_models(
        cfg, device, torch.Generator(device=device).manual_seed(seed))
    npz = resolve_vgg_npz(cfg)
    if npz:
        load_vgg_weights_npz(vgg, npz)
        print(f"[gan] perceptual loss: real VGG19 weights from {npz}")
    return TrainState(gen, disc, vgg, *make_optimizers(cfg, gen, disc))


def train_step_on_batch(cfg: GANConfig, state: TrainState,
                        batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """One D update and one G update on a patch batch; returns the losses
    as 0-d device tensors (reading them syncs the host)."""
    gen, disc, vgg = state.gen, state.disc, state.vgg
    gen.train()
    # one G forward: the D step reads it detached, the G loss through it
    fake = gen(batch["pre"])

    state.d_opt.zero_grad(set_to_none=True)
    fl = disc(fake.detach() * batch["pre_mask"])
    tl = disc(batch["already"] * batch["already_mask"])
    d_loss = fl.square().mean() + (tl - 1.0).square().mean()
    d_loss.backward()
    state.d_opt.step()

    # G loss against the updated D; D's parameters take no gradient here,
    # so nothing of it reaches D's next update
    state.g_opt.zero_grad(set_to_none=True)
    post = batch["post"]
    disc.requires_grad_(False)
    try:
        image_loss = (fake - post).abs().mean() if cfg.use_image_loss \
            else fake.new_zeros(())
        # per-map squared sums over the total feature count: the mean over
        # the concatenated feature vector, without building it
        f_fake = vgg(fake)
        with torch.no_grad():
            f_real = vgg(post)
        sq = sum((a - b).square().sum() for a, b in zip(f_fake, f_real))
        perception_loss = sq / sum(a.numel() for a in f_fake)
        fl = disc(fake * batch["pre_mask"])
        adversarial_loss = (fl - 1.0).square().mean()
        g_loss = (cfg.reconstruction_weight * image_loss
                  + cfg.perception_weight * perception_loss
                  + cfg.adversarial_weight * adversarial_loss)
        g_loss.backward()
    finally:
        disc.requires_grad_(True)
    # optax updates every leaf: a leaf without a gradient (GeneratorJ_RIC's
    # smooth0 / smooth_bn) still decays and its moments still move, while
    # torch's AdamW would skip it
    for p in gen.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.g_opt.step()
    state.step += 1
    return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
            "image_loss": image_loss.detach(),
            "perception_loss": perception_loss.detach(),
            "adversarial_loss": adversarial_loss.detach()}


def train_step(cfg: GANConfig, state: TrainState, data: KeyframeData,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Sample a patch batch with ``generator``, then one D and one G
    update."""
    batch = sample_patches(data, generator, cfg.batch_size, cfg.patch_size)
    return train_step_on_batch(cfg, state, batch)


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

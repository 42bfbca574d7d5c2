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

import collections
import dataclasses
import itertools
import os
import weakref
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from drawingspinup_torch.core import checkpoint as ckpt
from drawingspinup_torch.core import profiling
from drawingspinup_torch.core import weights_policy
from drawingspinup_torch.models.generator_j import (
    DiscriminatorN_IN, GeneratorJ, GeneratorJ_RIC, PerceptualVGG19,
    load_vgg_weights_npz, tables_read,
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
    them), so configs move between the two packages. ``compute_dtype``:
    the activations' dtype in G, D and the VGG taps ("float32" or
    "bfloat16"; params, norm statistics, losses and the AdamW update stay
    f32). ``ric_variant`` names a JAX schedule and is not read here: RIC
    convs run the CUDA kernels on the GPU, in training and serving alike."""
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


def compute_dtype(cfg: GANConfig) -> torch.dtype:
    """``cfg.compute_dtype`` as a torch dtype: float32 or bfloat16."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 or "
                         f"bfloat16")
    return getattr(torch, cfg.compute_dtype)


def _generator(cfg: GANConfig, device: Union[str, torch.device],
               generator: Optional[torch.Generator]) -> Generator:
    cls = {"GeneratorJ": GeneratorJ, "GeneratorJ_RIC": GeneratorJ_RIC}[
        cfg.generator]
    return cls(filters=cfg.filters, resnet_blocks=cfg.resnet_blocks,
               tanh=cfg.tanh, append_smoothers=cfg.append_smoothers,
               input_channels=cfg.input_channels, device=device,
               generator=generator, dtype=compute_dtype(cfg))


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
    frozen VGG taps with fixed random features (seed ``VGG_SEED``), all
    three computing in ``cfg.compute_dtype``."""
    gen = _generator(cfg, device, generator).train()
    disc = DiscriminatorN_IN(num_filters=cfg.disc_filters,
                             n_layers=cfg.disc_layers, device=device,
                             generator=generator, dtype=compute_dtype(cfg))
    vgg = PerceptualVGG19(device=device, generator=torch.Generator(
        device=device).manual_seed(VGG_SEED), dtype=compute_dtype(cfg))
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
                        batch: Dict[str, torch.Tensor],
                        reduce: Optional[Callable[[List[torch.Tensor]],
                                                  None]] = None
                        ) -> Dict[str, torch.Tensor]:
    """One D update and one G update on a patch batch; returns the losses
    as 0-d device tensors (reading them syncs the host).

    reduce: averages tensors in place over data-parallel ranks
    (``train/gan_parallel.py``), in ``gan_parallel.py``'s order: D's
    gradients before D's update; then G's gradients, G's batch-norm
    running statistics (its only buffers) and the losses before G's
    update.

    Spans (``core/profiling.py``): ``gan.d_update`` (G's one forward, which
    the D step reads first, then D's forward, loss and backward),
    ``gan.d_opt``, ``gan.g_update`` (VGG, D, loss and G's backward) and
    ``gan.g_opt``, each with its share of ``reduce``."""
    gen, disc, vgg = state.gen, state.disc, state.vgg
    gen.train()
    with profiling.span("gan.d_update"):
        # one G forward: the D step reads it detached, the G loss through it
        fake = gen(batch["pre"])
        state.d_opt.zero_grad(set_to_none=True)
        fl = disc(fake.detach() * batch["pre_mask"])
        tl = disc(batch["already"] * batch["already_mask"])
        d_loss = fl.square().mean() + (tl - 1.0).square().mean()
        d_loss.backward()
    with profiling.span("gan.d_opt"):
        if reduce is not None:
            reduce([p.grad for p in disc.parameters()])
        state.d_opt.step()

    # G loss against the updated D; D's parameters take no gradient here,
    # so nothing of it reaches D's next update
    with profiling.span("gan.g_update"):
        state.g_opt.zero_grad(set_to_none=True)
        post = batch["post"]
        disc.requires_grad_(False)
        try:
            image_loss = (fake - post).abs().mean() if cfg.use_image_loss \
                else fake.new_zeros(())
            # per-map squared sums over the total feature count: the mean
            # over the concatenated feature vector, without building it
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
    with profiling.span("gan.g_opt"):
        # optax updates every leaf: a leaf without a gradient
        # (GeneratorJ_RIC's smooth0 / smooth_bn) still decays and its
        # moments still move, while torch's AdamW would skip it
        for p in gen.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        logs = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                "image_loss": image_loss.detach(),
                "perception_loss": perception_loss.detach(),
                "adversarial_loss": adversarial_loss.detach()}
        if reduce is not None:
            reduce([p.grad for p in gen.parameters()] + list(gen.buffers())
                   + list(logs.values()))
        state.g_opt.step()
    state.step += 1
    return logs


def train_step(cfg: GANConfig, state: TrainState, data: KeyframeData,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Sample a patch batch with ``generator``, then one D and one G
    update: the span ``gan.step``, the step's unit, around ``gan.sample``
    and ``train_step_on_batch``'s spans."""
    with profiling.span("gan.step", unit=True):
        with profiling.span("gan.sample"):
            batch = sample_patches(data, generator, cfg.batch_size,
                                   cfg.patch_size)
        return train_step_on_batch(cfg, state, batch)


def frame_features(xt: torch.Tensor, use_mask: bool, use_pos: bool,
                   use_edge: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (H, W, 7) uint8 source stack of
    ``stage3_data.load_full_frame_u8``, already on its device → ((1, H, W,
    C_in) f32 generator input, (H, W) f32 alpha).

    Same math as the JAX ``_full_frame_runner_u8``: features from u8/255,
    edge pixels (u8 < 255) blacked out, alpha is the pre-overlay alpha."""
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


def full_frame_features(x_u8: np.ndarray, use_mask: bool, use_pos: bool,
                        use_edge: bool, device: Union[str, torch.device]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``frame_features`` of the host stack ``x_u8`` copied to ``device``."""
    xt = torch.from_numpy(np.ascontiguousarray(x_u8)).to(device)
    return frame_features(xt, use_mask, use_pos, use_edge)


def quantise_rgba(out: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The generator's (H, W, 3) output in [-1, 1] and the (H, W) alpha →
    (H, W, 4) uint8 RGBA, quantized as ``write_image`` quantizes."""
    rgb8 = (torch.clamp((out + 1.0) * 0.5, 0.0, 1.0) * 255.0
            + 0.5).to(torch.uint8)
    a8 = (alpha * 255.0 + 0.5).to(torch.uint8)
    return torch.cat([rgb8, a8[..., None]], dim=-1)


def frame_rgba(model: Generator, xt: torch.Tensor, use_mask: bool,
               use_pos: bool, use_edge: bool) -> torch.Tensor:
    """A served frame's device work: the (H, W, 7) uint8 stack on the
    model's device → (H, W, 4) uint8 RGBA there (what a frame graph
    holds)."""
    x, alpha = frame_features(xt, use_mask, use_pos, use_edge)
    return quantise_rgba(model(x)[0], alpha)


# Graphs kept per model, the least recently served key dropped first: each
# holds its frame's activations in a private pool of the caching allocator.
GRAPHS_PER_MODEL = 2
# Frames of a key served eagerly before its graph is captured. They build
# what must live outside a graph's pool: the RIC extension, the RIC tables,
# the libraries' handles and the kernels' attributes.
EAGER_FRAMES = 2


class _FrameGraph:
    """One key's served frame as a CUDA graph: a static uint8 stack on the
    card, the captured ``frame_rgba`` and its static RGBA. ``launched``:
    the counters the capture moved (the kernels' launch counters), which
    each replay adds again; ``tables``: the RIC tables the graph reads, held
    after ``generator_j``'s cache lets them go."""

    def __init__(self) -> None:
        self.eager = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.x: Optional[torch.Tensor] = None
        self.out: Optional[torch.Tensor] = None
        self.launched: collections.Counter = collections.Counter()
        self.tables: List[torch.Tensor] = []

    def upload(self, x_u8: np.ndarray, device: torch.device) -> None:
        xt = torch.from_numpy(np.ascontiguousarray(x_u8))
        if self.x is None:
            self.x = xt.to(device)
        else:
            self.x.copy_(xt)

    def capture(self, model: Generator, flags: Tuple[bool, bool, bool]
                ) -> None:
        before = profiling.counters()
        graph = torch.cuda.CUDAGraph()
        with tables_read() as tables, torch.cuda.graph(graph):
            out = frame_rgba(model, self.x, *flags)
        # a capture launches nothing: its counts move to the replays
        self.launched = profiling.counters() - before
        for name, n in self.launched.items():
            profiling.count(name, -n)
        self.graph, self.out, self.tables = graph, out, tables
        profiling.count("serve.graph.capture")

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launched.items():
            profiling.count(name, n)
        profiling.count("serve.graph.replay")


_GRAPHS: "weakref.WeakKeyDictionary[Generator, collections.OrderedDict]" = \
    weakref.WeakKeyDictionary()


def _frame_graph(model: Generator, x_u8: np.ndarray,
                 flags: Tuple[bool, bool, bool], device: torch.device
                 ) -> Optional[_FrameGraph]:
    """The frame's graph, None where the frame runs eagerly: a model off
    CUDA or in training mode, and a key's first ``EAGER_FRAMES`` frames.
    The key: every parameter's and buffer's address (a replaced tensor
    needs a new capture; one changed in place is read by the replay), the
    stack's shape and dtype, the feature flags, the compute dtype and the
    device; the model itself is held weakly."""
    if device.type != "cuda" or model.training:
        return None
    key = (tuple(t.data_ptr() for t in itertools.chain(
               model.parameters(), model.buffers())),
           x_u8.shape, x_u8.dtype.str, flags, model.dtype, device)
    graphs = _GRAPHS.setdefault(model, collections.OrderedDict())
    fg = graphs.get(key)
    if fg is None:
        fg = graphs[key] = _FrameGraph()
        if len(graphs) > GRAPHS_PER_MODEL:
            graphs.popitem(last=False)
    graphs.move_to_end(key)
    if fg.eager < EAGER_FRAMES:
        fg.eager += 1
        return None
    return fg


def generate_full_rgba(model: Generator, x_u8: np.ndarray, use_mask: bool,
                       use_pos: bool, use_edge: bool) -> np.ndarray:
    """Stylize one full frame: the (H, W, 7) uint8 source stack →
    (H, W, 4) uint8 RGBA, quantized as ``write_image`` quantizes.

    On CUDA with the model in eval mode, a key's frames after its first
    ``EAGER_FRAMES`` replay one CUDA graph of ``frame_rgba``, captured at
    the first of them (``_frame_graph``; a failed capture raises). A
    replay runs the code as it was at the capture: a Python attribute or
    function changed later is not seen. Elsewhere the frame runs eagerly.

    Spans: ``serve.frame`` (the frame's unit, the whole call) around
    ``serve.upload`` (the host-to-card copy: eagerly with the features,
    else into the graph's static stack), ``serve.forward`` (eagerly
    ``model(x)``, the host's enqueueing of it; else the replay, and the
    capture before its first), eagerly ``serve.quantise``, and
    ``serve.readback`` (the host's wait for the card, then the copy back).
    Counters: ``serve.eager``, ``serve.graph.capture`` and
    ``serve.graph.replay`` a frame; a replay also adds the launch counts
    its capture saw."""
    with profiling.span("serve.frame", unit=True), torch.no_grad():
        device = next(model.parameters()).device
        flags = (use_mask, use_pos, use_edge)
        fg = _frame_graph(model, x_u8, flags, device)
        if fg is None:
            profiling.count("serve.eager")
            with profiling.span("serve.upload"):
                x, alpha = full_frame_features(x_u8, *flags, device)
            with profiling.span("serve.forward"):
                out = model(x)[0]
            with profiling.span("serve.quantise"):
                rgba = quantise_rgba(out, alpha)
            with profiling.span("serve.readback"):
                return rgba.cpu().numpy()
        with profiling.span("serve.upload"):
            fg.upload(x_u8, device)
        with profiling.span("serve.forward"):
            if fg.graph is None:
                fg.capture(model, flags)
            fg.replay()
        with profiling.span("serve.readback"):
            return fg.out.cpu().numpy()


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

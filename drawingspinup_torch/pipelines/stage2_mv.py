"""Stage 2a: multi-view diffusion generation (counterpart of
``drawingspinup_tpu/pipelines/stage2_mv.py``, the reference's ``mv.py`` and
Wonder3D's ``pipeline_mvdiffusion_image.py``).

  drawing (stage 1's inpainted RGBA, darkened ×0.8 and composited on
  white, 256²) → CLIP image embedding + VAE condition latents (one per
  view × 2 domains) → camera Δelevation/Δazimuth ⊕ task one-hots → sincos
  → 75-step DDIM over the 12-image batch through the MV-UNet (condition
  latents concatenated to the noisy ones at every step) → VAE decode → 6
  normals + 6 colours, bicubic to 1024² → per-view masks: front = the
  drawing's alpha, back = mirrored, sides = background removal; writes
  ``mv/{normal,color,mask}/<view>.png``.

On the device: the UNet's params and activations in the compute dtype
(bf16 by default), the latents and DDIM updates in f32, CLIP and the VAE in
f32, and the decode, upscale and u8 quantisation. On the host: the masks
(scipy) and the PNG writes. The random draws (the initial latents and one
noise per step) come from an explicit ``torch.Generator`` or are handed in
(``noises``), as the parity tests hand in JAX's.

``MVPipeline.images_u8`` is the unit of work: a drawing on the device to
its 12 u8 images on the host, traced as the span ``mv.uid`` ⊃
``mv.encode``, ``mv.step`` (one a DDIM step) and ``mv.decode``
(``core/profiling.py``); ``generate_uid`` wraps it in the reads, the masks
and the PNG writes (spans ``mv.read``, ``mv.masks``, ``mv.write``).

On CUDA each DDIM step's UNet call after a key's first ``EAGER_CALLS``
replays one CUDA graph of the call (``unet_noise``), so that the host
enqueues a handful of operations a step instead of the UNet's ~1900
launches; the noise draws, the cast of the noise and the DDIM update stay
eager. The CPU, a split batch and grad mode call the UNet eagerly.

Under torchrun with W > 1 ranks the denoise loop splits its batch rows over
the first ``dp`` ranks, ``dp`` the largest divisor of the 2·Nv images that
is at most W (JAX's ``_mv_batch_sharding``; ``batch_split``): each holds the
full weights and the rows of its slice of the latents, from the uncond and
the cond halves alike under guidance, so the guidance combine stays local;
the view and domain folds gather keys and values over the group
(``models/attention_mv.py::RowSplit``). Every rank draws the full-batch
noises from the one generator and keeps its rows, so a split run consumes
the one-rank run's draws. CLIP and the VAE encode run on every rank of the
split; rank 0 gathers the latents, decodes them and writes the PNGs; the
ranks past ``dp`` wait.

Weights: ``load_pretrained`` reads a local diffusers-layout Wonder3D
directory (``utils/diffusers_port.py``); ``MVPipeline.init_random`` draws
them from a seed on the device. The side views' masks come from ISNet DIS
on the device (``models/isnet.py``) when ``DSU_ISNET_CKPT`` names its
weights (a torch ``state_dict`` or an ``.npz`` of the same keys); a set
path that does not load raises, where JAX falls back to the heuristic
matte. Without it they come from the heuristic matte, reported as a
degraded weight as in JAX. ``DSU_ISNET_ONNX`` raises: onnxruntime is not a
dependency of the port.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import itertools
import math
import os
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from drawingspinup_torch.core import profiling, weights_policy
from drawingspinup_torch.core.contract import VIEWS, UidPaths
from drawingspinup_torch.core.io import read_image, write_image
from drawingspinup_torch.models.attention_mv import (
    Attention, Conv1x1Tokens, RowSplit,
)
from drawingspinup_torch.models.clip_vision import (
    CLIPEmbeddings, CLIPVisionConfig, CLIPVisionModelWithProjection,
    preprocess as clip_preprocess,
)
from drawingspinup_torch.models.unet_mv2d import UNetMV2D, UNetMVConfig
from drawingspinup_torch.models.vae import AutoencoderKL, VAEConfig
from drawingspinup_torch.ops import diffusion as D
from drawingspinup_torch.ops.image import resize
from drawingspinup_torch.parallel import mesh

# Wonder3D's training-camera positions (x, y, z) per view, from the
# reference's fixed_poses (part of the model contract).
WONDER3D_CAMERAS: Dict[str, Tuple[float, float, float]] = {
    "front": (-1.1051002, -0.5968285, 0.3354838),
    "front_right": (-0.4204443, -1.5601668, 0.8769869),
    "right": (0.6846559, -0.9633385, 0.5415031),
    "back": (1.1051002, 0.5968286, -0.3354838),
    "left": (-0.6846559, 0.9633384, -0.5415032),
    "front_left": (-1.7897565, 0.3665098, -0.2060194),
    "back_left": (0.4204443, 1.5601668, -0.8769868),
    "back_right": (1.7897564, -0.3665100, 0.2060193),
    "top": (-0.0000000, 0.6370046, 1.1332367),
}

# the reference's four uids whose side-view masks come from the normal map
# instead of the colour image (mv.py:115-122)
NORMAL_MASK_UIDS = {"5269932f55b5456c9b76cacfe0477c36",
                    "ff97c4c2e4d34790ad4d9cfae2c9b37b",
                    "8cb0a6123ffb4ea5b2dd7ba0cb98ac61",
                    "1b39b2d2a6cb4a72a452b2bdcd7c0590"}


def camera_task_embeddings(views: List[str]) -> np.ndarray:
    """(2·Nv, 5): [0, Δelevation, Δazimuth, normal one-hot, colour one-hot]
    relative to the front view; normals first, then colours."""
    def sph(c):
        x, y, z = c
        return np.arctan2(np.hypot(x, y), z), np.arctan2(y, x)

    t0, a0 = sph(WONDER3D_CAMERAS["front"])
    rows = []
    for v in views:
        t, a = sph(WONDER3D_CAMERAS[v])
        rows.append([0.0, t - t0, (a - a0) % (2 * np.pi)])
    cam = np.asarray(rows, np.float32)
    normal_task = np.concatenate(
        [cam, np.tile([[1.0, 0.0]], (len(views), 1))], axis=1)
    color_task = np.concatenate(
        [cam, np.tile([[0.0, 1.0]], (len(views), 1))], axis=1)
    return np.concatenate([normal_task, color_task], axis=0).astype(np.float32)


def sincos(emb: np.ndarray) -> np.ndarray:
    """'e_de_da_sincos': concat(sin, cos)."""
    return np.concatenate([np.sin(emb), np.cos(emb)], axis=-1)


@dataclasses.dataclass(frozen=True)
class MVPipelineConfig:
    unet: UNetMVConfig = UNetMVConfig()
    ddim: D.DDIMConfig = D.DDIMConfig()
    vae: Optional[VAEConfig] = None          # default: the full SD VAE
    image_size: int = 256
    num_inference_steps: int = 75
    guidance_scale: float = 1.0
    eta: float = 1.0
    out_size: int = 1024
    # the UNet's compute dtype in the denoise loop (the reference samples in
    # fp16); DDIM, CLIP and the VAE stay f32
    compute_dtype: str = "bfloat16"

    def vae_config(self) -> VAEConfig:
        return self.vae if self.vae is not None else VAEConfig()

    def clip_config(self) -> CLIPVisionConfig:
        """ViT-L/14 for the 768-wide cross-attention, else a small encoder
        of the UNet's width."""
        if self.unet.cross_attention_dim == 768:
            return CLIPVisionConfig()
        # a small encoder for narrow test configs
        return CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64,
                                num_layers=2, num_heads=4,
                                projection_dim=self.unet.cross_attention_dim)


@torch.no_grad()
def seeded_init(module: nn.Module, generator: torch.Generator) -> None:
    """Weights drawn from ``generator`` on its device, in module order:
    dense and conv weights normal with std 1/sqrt(fan-in) (flax's LeCun
    scale), zero biases, identity norms, CLIP's class and position
    embeddings normal with std 0.02, and the joint attentions' output
    projections zero, as Wonder3D initialises them."""
    dev = generator.device

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=dev) * std)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, Conv1x1Tokens)):
            normal(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, CLIPEmbeddings):
            normal(m.class_embedding, 0.02)
            normal(m.position_embedding.weight, 0.02)
    for m in module.modules():
        if isinstance(m, Attention) and m.zero_out:
            m.to_out[0].weight.zero_()
            m.to_out[0].bias.zero_()


def batch_split(nv2: int, guidance: bool
                ) -> Tuple[bool, Optional[RowSplit]]:
    """(whether this rank denoises, its rows when the batch is split):
    ``dp = mesh.mv_split(nv2, world)``; at dp 1 rank 0 runs the whole
    batch. Otherwise rank r < dp holds the latent rows
    ``[r·nv2/dp, (r+1)·nv2/dp)`` and, under guidance, the same rows of the
    cond half (global rows + nv2) after them; ranks past dp wait. Every
    rank of the process group calls this alike: the first call for a dp
    makes its group."""
    dp = mesh.mv_split(nv2, mesh.world_size())
    group = mesh.dp_group(dp) if dp > 1 else None
    if mesh.rank() >= dp:
        return False, None
    if group is None:
        return True, None
    n = nv2 // dp

    def rows(r: int) -> List[int]:
        lat = list(range(r * n, (r + 1) * n))
        return lat + [nv2 + i for i in lat] if guidance else lat

    return True, RowSplit(group, rows(mesh.rank()),
                          [g for r in range(dp) for g in rows(r)],
                          nv2 * (2 if guidance else 1))


# Graphs kept per UNet, the least recently used key dropped first: each
# holds a call's activations in a private pool of the caching allocator.
GRAPHS_PER_UNET = 2
# Calls of a key made eagerly before its graph is captured. They build what
# must live outside a graph's pool: the attention kernel's extension, the
# cuDNN and cuBLAS handles and their workspaces.
EAGER_CALLS = 2


class _UNetGraph:
    """One key's UNet call as a CUDA graph: static inputs (the latents ⊕
    condition latents in the compute dtype, the timestep as a device
    tensor, the CLIP tokens, the camera/task embeddings), the captured call
    and its static noise. ``launched``: the counters the capture moved
    (calls, attention folds, kernel launches), which each replay adds
    again; ``spans``: the device-timed spans the capture recorded into the
    graph (``profiling.capturing``), recorded per replay under a
    profiler."""

    def __init__(self) -> None:
        self.eager = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self.out: Optional[torch.Tensor] = None
        self.launched: collections.Counter = collections.Counter()
        self.spans: List[tuple] = []

    def capture(self, unet: UNetMV2D, args: Tuple[torch.Tensor, ...]
                ) -> None:
        self.inputs = tuple(a.clone() for a in args)
        before = profiling.counters()
        graph = torch.cuda.CUDAGraph()
        with profiling.capturing() as spans, torch.cuda.graph(graph):
            out = unet(*self.inputs)
        # a capture launches nothing: its counts move to the replays
        self.launched = profiling.counters() - before
        for name, n in self.launched.items():
            profiling.count(name, -n)
        self.graph, self.out, self.spans = graph, out, spans
        profiling.count("mv.unet.graph.capture")

    def replay(self, args: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """The static noise of the call on ``args``, copied in first."""
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        start = time.time_ns()
        self.graph.replay()
        profiling.replayed(self.spans, start)
        for name, n in self.launched.items():
            profiling.count(name, n)
        profiling.count("mv.unet.graph.replay")
        return self.out


_GRAPHS: "weakref.WeakKeyDictionary[UNetMV2D, collections.OrderedDict]" = \
    weakref.WeakKeyDictionary()


def weights_key(unet: UNetMV2D) -> Tuple[int, ...]:
    """Every parameter's and buffer's address: the weights' part of a
    graph's key (a replaced tensor needs a new capture; one changed in
    place is read by the replay). Walking the UNet's ~800 tensors takes
    milliseconds of host, so ``denoise`` reads it once a call."""
    return tuple(t.data_ptr() for t in itertools.chain(unet.parameters(),
                                                       unet.buffers()))


def _unet_graph(unet: UNetMV2D, args: Tuple[torch.Tensor, ...],
                device: torch.device, split: Optional[RowSplit],
                weights: Tuple[int, ...]) -> Optional[_UNetGraph]:
    """The call's graph, None where it runs eagerly: off CUDA, on a split
    batch (its folds gather across ranks), in grad mode, and a key's first
    ``EAGER_CALLS`` calls. The key: ``weights`` (``weights_key``), the
    inputs' shapes and dtypes and the device; the UNet itself is held
    weakly."""
    if device.type != "cuda" or split is not None \
            or torch.is_grad_enabled():
        return None
    key = (weights, tuple((tuple(a.shape), a.dtype) for a in args), device)
    graphs = _GRAPHS.setdefault(unet, collections.OrderedDict())
    ug = graphs.get(key)
    if ug is None:
        ug = graphs[key] = _UNetGraph()
        if len(graphs) > GRAPHS_PER_UNET:
            graphs.popitem(last=False)
    graphs.move_to_end(key)
    if ug.eager < EAGER_CALLS:
        ug.eager += 1
        return None
    return ug


def unet_noise(unet: UNetMV2D, args: Tuple[torch.Tensor, ...],
               device: torch.device, split: Optional[RowSplit],
               weights: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """The UNet's noise on ``args`` = (latents ⊕ condition latents,
    timestep, CLIP tokens, camera/task embeddings), cast to ``dtype``: the
    replay of the key's CUDA graph (``_unet_graph``; captured before its
    first replay, a failed capture raises), else the eager call. The result is never a
    graph's static buffer. A replay runs the code as it was at the
    capture: a Python attribute, hook or function changed later is not
    seen. Counted ``mv.unet.eager``, ``mv.unet.graph.capture`` and
    ``mv.unet.graph.replay``; a replay also adds the counts its capture
    saw (``mv.unet.call``, ``mv.attn.*``, ``mv.attn.launch``)."""
    ug = _unet_graph(unet, args, device, split, weights)
    if ug is None:
        profiling.count("mv.unet.eager")
        return unet(*args, split=split).to(dtype)
    if ug.graph is None:
        ug.capture(unet, args)
    return ug.replay(args).to(dtype, copy=True)


def build_modules(cfg: MVPipelineConfig, device
                  ) -> Tuple[UNetMV2D, AutoencoderKL,
                             CLIPVisionModelWithProjection]:
    """The three modules with uninitialised storage on ``device`` (built on
    the meta device, so the full-width UNet never touches the host)."""
    with torch.device("meta"):
        mods = (UNetMV2D(cfg.unet), AutoencoderKL(cfg.vae_config()),
                CLIPVisionModelWithProjection(cfg.clip_config()))
    return tuple(m.to_empty(device=device).eval() for m in mods)


class MVPipeline:
    """The three models and the generation loop."""

    def __init__(self, cfg: MVPipelineConfig, unet: UNetMV2D,
                 vae: AutoencoderKL, clip: CLIPVisionModelWithProjection):
        self.cfg = cfg
        self.unet, self.vae, self.clip = unet, vae, clip
        self.device = next(unet.parameters()).device
        # the latents, DDIM, CLIP and the VAE run in the VAE's dtype: f32,
        # or float64 when the modules are cast (the float64 parity tests)
        self.dtype = next(vae.parameters()).dtype
        self.acp = D.alphas_cumprod(cfg.ddim)
        self._cast: Dict[torch.dtype, UNetMV2D] = {}

    @staticmethod
    def init_random(cfg: MVPipelineConfig, seed: int = 0,
                    device="cuda") -> "MVPipeline":
        """Weights drawn on ``device`` from ``seed``: the UNet, then the
        VAE, then CLIP, from one generator."""
        mods = build_modules(cfg, torch.device(device))
        g = torch.Generator(device=device).manual_seed(int(seed))
        for m in mods:
            seeded_init(m, g)
        return MVPipeline(cfg, *mods)

    def unet_in(self, dtype: torch.dtype) -> UNetMV2D:
        """The UNet with its params in ``dtype`` (a cached cast copy)."""
        if dtype == next(self.unet.parameters()).dtype:
            return self.unet
        if dtype not in self._cast:
            self._cast[dtype] = copy.deepcopy(self.unet).to(dtype)
        return self._cast[dtype]

    # -- conditioning -------------------------------------------------------
    @torch.inference_mode()
    def encode_image(self, image) -> Tuple[torch.Tensor, torch.Tensor]:
        """image (H, W, 3) in [0, 1] on white → (CLIP tokens (1, 1, D),
        condition latents (1, 4, H/8, W/8)), f32."""
        x = image if torch.is_tensor(image) else torch.from_numpy(
            np.asarray(image, np.float32))
        x = x.to(self.device, self.dtype)[None]
        embeds = self.clip(clip_preprocess(x,
                                           self.cfg.clip_config().image_size))
        latents = self.vae.encode_mode((x * 2.0 - 1.0).permute(0, 3, 1, 2))
        return embeds[:, None, :], latents

    # -- sampling -----------------------------------------------------------
    @torch.inference_mode()
    def denoise(self, embeds: torch.Tensor, cond: torch.Tensor,
                views: Optional[List[str]] = None,
                generator: Optional[torch.Generator] = None,
                noises: Optional[Sequence[torch.Tensor]] = None
                ) -> Optional[torch.Tensor]:
        """The denoised latents (2·Nv, 4, h, w), f32, normals first, from
        ``encode_image``'s CLIP tokens and condition latents.

        ``noises``: the initial latents and one noise per step (NCHW, f32);
        without them both are drawn from ``generator`` in that order.
        Classifier-free guidance (guidance ≠ 1) runs the UNet once a step on
        the doubled batch [uncond | cond] (a zero CLIP embedding and zero
        condition latents, the camera rows repeated), whose view and domain
        folds pair its halves as the reference's (and JAX's) do.

        In a process group of more than one rank the rows are split
        (``batch_split``): every rank of the split returns the gathered
        latents, a rank past it returns None at once."""
        cfg = self.cfg
        views = list(views or VIEWS)
        nv2 = 2 * len(views)
        dev = self.device
        h, w = cond.shape[2:]
        shape = (nv2, cond.shape[1], h, w)
        ts = D.timesteps_for(cfg.ddim, cfg.num_inference_steps)
        ts_prev = np.concatenate([ts[1:], [-1]])
        if noises is not None and len(noises) != len(ts) + 1:
            raise ValueError(f"noises: {len(noises)} tensors for "
                             f"{len(ts)} steps; expected {len(ts) + 1}")
        guidance = float(cfg.guidance_scale)
        do_cfg = guidance != 1.0
        active, split = batch_split(nv2, do_cfg)
        if not active:
            return None
        # this rank's latent rows: all of them, or its slice of the split
        n = nv2 if split is None else len(split.rows) // (1 + do_cfg)
        lo = 0 if split is None else split.rows[0]

        def draw(i: int) -> torch.Tensor:
            # the full batch's draw, then this rank's rows
            if noises is not None:
                full = torch.as_tensor(noises[i], device=dev)
            else:
                full = torch.randn(shape, generator=generator, device=dev)
            full = full.to(self.dtype)
            return full[lo:lo + n]

        cdt = getattr(torch, cfg.compute_dtype)
        unet = self.unet_in(cdt)
        weights = weights_key(unet)
        # dense, as a graph's static copy of it is: both paths read one
        # layout
        embeds_c = embeds.expand(n, -1, -1).to(cdt).contiguous()
        cond_c = cond.expand(n, -1, -1, -1).to(cdt)
        cam_c = torch.as_tensor(sincos(camera_task_embeddings(views)),
                                device=dev)[lo:lo + n].to(cdt)
        if do_cfg:
            embeds_c = torch.cat([torch.zeros_like(embeds_c), embeds_c])
            cond_c = torch.cat([torch.zeros_like(cond_c), cond_c])
            cam_c = torch.cat([cam_c, cam_c])
        t_dev = torch.as_tensor(ts.astype(np.int64), device=dev)

        latents = draw(0)
        for i in range(len(ts)):
            with profiling.span("mv.step"):
                lat_in = latents.to(cdt)
                if do_cfg:
                    lat_in = torch.cat([lat_in, lat_in])
                eps = unet_noise(unet, (torch.cat([lat_in, cond_c], dim=1),
                                        t_dev[i], embeds_c, cam_c), dev,
                                 split, weights, self.dtype)
                if do_cfg:
                    uncond, cond_eps = eps.chunk(2)
                    eps = uncond + guidance * (cond_eps - uncond)
                latents = D.ddim_step(cfg.ddim, self.acp, eps, int(ts[i]),
                                      int(ts_prev[i]), latents, eta=cfg.eta,
                                      noise=draw(i + 1))
        if split is not None:
            latents = mesh.all_gather_rows(latents, split.group)
        return latents

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(N, 4, h, w) → (N, H, W, 3) images in [0, 1], f32."""
        img = self.vae.decode(latents).permute(0, 2, 3, 1)
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)

    @torch.inference_mode()
    def decode_u8(self, latents: torch.Tensor) -> torch.Tensor:
        """decode → bicubic to out_size → u8 as ``core/io.py::write_image``
        quantises, floor(clip(x·255 + 0.5)), on the device."""
        out = self.cfg.out_size
        img = torch.clamp(resize(self.decode(latents), (out, out)), 0.0, 1.0)
        return torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)

    def images_u8(self, image, views: Optional[List[str]] = None,
                  generator: Optional[torch.Generator] = None,
                  noises: Optional[Sequence[torch.Tensor]] = None
                  ) -> Optional[torch.Tensor]:
        """A drawing (H, W, 3) in [0, 1] on white → its (2·Nv, out_size,
        out_size, 3) u8 images on the host, normals first: ``encode_image``
        → ``denoise`` → ``decode_u8`` → ``.cpu()``, in the span ``mv.uid``
        ⊃ ``mv.encode``, ``mv.step`` a DDIM step, ``mv.decode`` (encode and
        decode wait for the card at both ends, so their spans time it).

        In a process group the ranks of the split encode and denoise their
        rows and rank 0 decodes; the other ranks return None."""
        nv2 = 2 * len(views or VIEWS)
        with profiling.span("mv.uid", unit=True):
            latents = None
            if batch_split(nv2, self.cfg.guidance_scale != 1.0)[0]:
                with profiling.span("mv.encode", sync=True):
                    embeds, cond = self.encode_image(image)
                latents = self.denoise(embeds, cond, views, generator,
                                       noises)
            if not mesh.is_main():
                return None
            with profiling.span("mv.decode", sync=True):
                return self.decode_u8(latents).cpu()

    def __call__(self, image, views: Optional[List[str]] = None,
                 generator: Optional[torch.Generator] = None,
                 noises: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(normals (Nv, H, W, 3), colours (Nv, H, W, 3)) in [0, 1] on the
        host. Without ``generator`` or ``noises`` the draws come from seed
        0. In a process group the batch is split over the ranks; rank 0
        decodes, and every rank returns its images."""
        nv = len(views or VIEWS)
        latents = None
        if batch_split(2 * nv, self.cfg.guidance_scale != 1.0)[0]:
            if generator is None and noises is None:
                generator = torch.Generator(device=self.device).manual_seed(
                    0)
            embeds, cond = self.encode_image(image)
            latents = self.denoise(embeds, cond, views, generator, noises)
        images = mesh.on_main(lambda: self.decode(latents).cpu().numpy())
        return images[:nv], images[nv:]


# ---------------------------------------------------------------------------
# masks (mv.py:105-126)
# ---------------------------------------------------------------------------

ONNX_ITEM = "ROADMAP.md queue 3 (the ISNet onnx route)"
_ISNET_CACHE: Dict[Tuple[str, str], nn.Module] = {}


def isnet_model(device) -> Optional[nn.Module]:
    """ISNet with the weights ``DSU_ISNET_CKPT`` names, in eval mode on
    ``device`` (loaded once per path and device), or None when the
    variable is unset. A path that does not load raises."""
    path = os.environ.get("DSU_ISNET_CKPT")
    if not path:
        return None
    key = (path, str(device))
    if key not in _ISNET_CACHE:
        from drawingspinup_torch.models.isnet import (
            ISNetDIS, load_isnet_state,
        )
        if not os.path.isfile(path):
            raise FileNotFoundError(f"DSU_ISNET_CKPT={path}: no such file")
        if path.endswith(".npz"):
            with np.load(path) as z:
                state = {k: z[k] for k in z.files}
        else:
            state = torch.load(path, map_location="cpu")
        model = load_isnet_state(ISNetDIS(), state)
        _ISNET_CACHE[key] = model.to(device).eval()
    return _ISNET_CACHE[key]


def background_removal(img: np.ndarray, bg_color: float = 1.0,
                       threshold: float = 0.1, device="cuda") -> np.ndarray:
    """Foreground mask of a side view (H, W) float in [0, 1]: ISNet DIS on
    ``device`` when ``DSU_ISNET_CKPT`` is set (JAX's ``isnet_predict``:
    /255, mean 0.5, std 1, the finest side output, clipped); otherwise the
    heuristic background-distance matte (pixels farther than ``threshold``
    from the background, closed twice, opened once, the largest component
    kept). ``DSU_ISNET_ONNX`` raises."""
    model = isnet_model(device)
    if model is not None:
        from drawingspinup_torch.models.isnet import isnet_predict
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        return isnet_predict(model, x.to(device)).cpu().numpy()
    if os.environ.get("DSU_ISNET_ONNX"):
        raise NotImplementedError(
            f"DSU_ISNET_ONNX is set, but the port runs ISNet from a torch or "
            f"npz state_dict (DSU_ISNET_CKPT), not through onnxruntime "
            f"({ONNX_ITEM}); unset it")
    weights_policy.report_degraded(
        "isnet",
        "side-view background removal using the heuristic "
        "background-distance matte (no ISNet weights: set DSU_ISNET_CKPT "
        "to the torch/npz DIS checkpoint for reference-grade masks)")
    from scipy import ndimage
    dist = np.abs(img - bg_color).max(axis=-1)
    mask = dist > threshold
    mask = ndimage.binary_closing(mask, iterations=2)
    mask = ndimage.binary_opening(mask, iterations=1)
    lab, n = ndimage.label(mask)
    if n > 1:
        sizes = ndimage.sum(mask, lab, range(1, n + 1))
        mask = lab == (1 + np.argmax(sizes))
    return mask.astype(np.float32)


def derive_masks(uid: str, colors: np.ndarray, normals: np.ndarray,
                 drawing_mask: np.ndarray, views: List[str],
                 device="cuda") -> np.ndarray:
    """Per-view masks: front = the drawing mask; back = mirrored; sides =
    background removal on the colour (the normal for 4 reference uids), on
    ``device`` where ISNet runs."""
    out = []
    size = colors.shape[1]
    if drawing_mask.shape[0] != size:
        drawing_mask = resize(torch.from_numpy(
            np.asarray(drawing_mask, np.float32)[..., None]), (size, size),
            "nearest").numpy()[..., 0]
    for i, v in enumerate(views):
        if v == "front":
            out.append((drawing_mask > 0.5).astype(np.float32))
        elif v == "back":
            out.append((drawing_mask[:, ::-1] > 0.5).astype(np.float32))
        else:
            src = normals[i] if uid in NORMAL_MASK_UIDS else colors[i]
            out.append(background_removal(src, device=device))
    return np.stack(out)


def load_input(paths: UidPaths, size: int, device,
               save_name: str = "ffc_resnet"
               ) -> Tuple[torch.Tensor, np.ndarray]:
    """(the model's input (size, size, 3) on ``device``, the drawing mask
    (H, W) on the host): stage 1's inpainted RGBA (the texture when there
    is none), darkened ×0.8 and composited on white (the reference's
    add_gray), bicubic to ``size``."""
    inp_path = os.path.join(paths.char_dir, f"{save_name}_inpainted.png")
    if not os.path.exists(inp_path):
        inp_path = paths.texture               # the reference's fallback
    rgba = read_image(inp_path)
    if rgba.shape[-1] == 4:
        alpha = rgba[..., 3:4]
        image = rgba[..., :3] * 0.8 * alpha + (1.0 - alpha)
        drawing_mask = rgba[..., 3]
    else:
        image = rgba[..., :3] * 0.8
        drawing_mask = read_image(paths.mask)[..., 0]
    image = resize(torch.from_numpy(np.ascontiguousarray(image)).to(device),
                   (size, size))
    return image, drawing_mask


def generate_uid(root: str, uid: str, pipe: MVPipeline,
                 views: Optional[List[str]] = None, seed: int = 0,
                 save_name: str = "ffc_resnet",
                 noises: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[str]:
    """The mv.py flow for one uid: read stage 1's output, sample with the
    draws of ``seed`` (or ``noises``) through ``MVPipeline.images_u8``,
    write ``mv/{normal,color,mask}/<view>.png`` at ``out_size``. Spans
    ``mv.read`` (the card waited for at its end), ``images_u8``'s
    ``mv.uid``, ``mv.masks`` and ``mv.write``.

    In a process group every rank calls this alike: the ranks of the split
    read, encode and denoise their rows, rank 0 decodes and writes, the
    other ranks wait and return its paths."""
    paths = UidPaths(root, uid)
    views = list(views or VIEWS)
    nv = len(views)
    dev = pipe.device
    image = drawing_mask = None
    if batch_split(2 * nv, pipe.cfg.guidance_scale != 1.0)[0]:
        with profiling.span("mv.read", sync=True):
            image, drawing_mask = load_input(paths, pipe.cfg.image_size, dev,
                                             save_name)
    generator = torch.Generator(device=dev).manual_seed(int(seed))
    u8 = pipe.images_u8(image, views, generator, noises)

    def masks_and_write() -> List[str]:
        with profiling.span("mv.masks"):
            u8_np = u8.numpy()
            normals_u8, colors_u8 = u8_np[:nv], u8_np[nv:]
            masks = derive_masks(uid, colors_u8.astype(np.float32) / 255.0,
                                 normals_u8.astype(np.float32) / 255.0,
                                 drawing_mask, views, device=dev)
        written = []
        with profiling.span("mv.write"):
            for i, v in enumerate(views):
                for kind, img in (("normal", normals_u8[i]),
                                  ("color", colors_u8[i]),
                                  ("mask", masks[i][..., None])):
                    p = paths.mv(kind, v)
                    write_image(p, img)
                    written.append(p)
        return written

    return mesh.on_main(masks_and_write)


def load_pretrained(cfg: MVPipelineConfig, ckpt_dir: str,
                    device="cuda", seed: int = 0) -> MVPipeline:
    """The pipeline with a local diffusers-layout Wonder3D checkpoint
    (``unet/``, ``vae/``, ``image_encoder/``) loaded strictly over the
    weights ``init_random`` draws from ``seed``: what the checkpoint
    lacks (a part directory, SD's half-width ``conv_out.bias``) keeps
    that seeded init."""
    from drawingspinup_torch.utils.diffusers_port import load_wonder3d

    pipe = MVPipeline.init_random(cfg, seed, device)
    load_wonder3d(ckpt_dir, pipe.unet, pipe.vae, pipe.clip)
    return pipe

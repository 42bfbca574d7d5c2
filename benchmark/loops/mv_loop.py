"""The loop of the stage-2a mix: the multi-view images of one drawing after
another, as ``pipelines/stage2_mv.py::generate_uid`` makes them, without
its PNG reads, masks and writes: ``MVPipeline.images_u8`` is the unit.

Set-up draws ``distinct_drawings`` drawings of the seed's character and
the weights of the UNet, the VAE and CLIP (``benchmark/mv_inputs.py``);
scales the UNet's ``conv_out`` so that its noise has unit spread (the plain
reference's, on the first drawing at the first step); loads the weights
into the port's pipeline; then runs ``warmup_uids`` uids, and scales the
VAE decoder's ``conv_out`` on the reference's decode of the last one's
final latents so that the images are not saturated (spread 0.25 about 0
before they are mapped to [0, 1]). The window is a closed loop over the
drawings in order, one uid at a time, each uid's 12 u8 images on the host
before the next starts; ``images_per_s`` is the images returned over the
window.

The comparison, teacher-forced on what the timed path produced:
- ``embed_rel_l2``: the CLIP embedding and the condition latents of each
  drawing of the window, against the reference's of the same drawing
  (relative L2, the larger of the two, worst drawing);
- ``eps_rel_l2`` and ``step_rel_l2``: at a reservoir of
  ``checked_steps`` (uid, step) pairs of the window, drawn from the seed,
  the step's input latents, its noise draw, the UNet's output and the
  latents after the update were recorded; the reference recomputes the
  noise from the same input and conditioning at its own timestep
  (relative L2), and the update from the same input and noise draw with
  its own noise (the error over the reference's change of the latents, so
  that late steps, which move the latents little, weigh as much);
- ``image_max_lsb`` and ``image_off_share``: the u8 images of a uid of
  the window (a reservoir of one), against the reference's decode,
  resize and quantisation of the program's final latents of that uid.

``control`` runs the program with every activation that enters a linear
map or a convolution rounded to the precision below the configuration's:
through ``float8_e4m3fn`` in the UNet (bf16), to TF32's 10-bit mantissa in
CLIP and the VAE (f32). The mix's ``fault`` plants one of ``FAULTS`` in
the program for the session's units: ``views_alone`` (the multi-view
attention over each view alone), ``no_joint`` (the joint attention
skipped) or ``no_eta_noise`` (the eta noise term dropped from the update).
"""
from __future__ import annotations

import contextlib
import random
import time
from typing import Dict, List, Optional

import torch

from benchmark import inputs, mv_inputs
from benchmark.loops.train_loop import phase, sync
from benchmark.reference import mv as ref

UNIT = "uid"
FAULTS = ("views_alone", "no_joint", "no_eta_noise")
FP8_MAX = 448.0


def pipeline_config(cfg: Dict):
    """The port's ``MVPipelineConfig`` of a benchmark configuration; raises
    where the port cannot run it as the configuration states it."""
    from drawingspinup_torch.models import vae as port_vae
    from drawingspinup_torch.models.unet_mv2d import UNetMVConfig
    from drawingspinup_torch.ops.diffusion import DDIMConfig
    from drawingspinup_torch.pipelines import stage2_mv

    if not hasattr(stage2_mv.MVPipeline, "images_u8"):
        raise RuntimeError("this program has no MVPipeline.images_u8, the "
                           "cell's unit")
    u, v = cfg["unet"], cfg["vae"]
    if not u["multiview_attention"] or u["sparse_mv_attention"]:
        raise ValueError("the reference folds all views of a domain")
    out = stage2_mv.MVPipelineConfig(
        unet=UNetMVConfig(**{k: tuple(x) if isinstance(x, list) else x
                             for k, x in u.items()
                             if k != "multiview_attention"}),
        ddim=DDIMConfig(**cfg["ddim"]),
        vae=port_vae.VAEConfig(
            block_out_channels=tuple(v["block_out_channels"]),
            layers_per_block=v["layers_per_block"],
            latent_channels=v["latent_channels"]),
        image_size=cfg["image_size"], out_size=cfg["out_size"],
        num_inference_steps=cfg["num_inference_steps"],
        guidance_scale=cfg["guidance_scale"], eta=cfg["eta"],
        compute_dtype=cfg["compute_dtype"])
    clip = out.clip_config()
    if {k: getattr(clip, k) for k in cfg["clip"]} != cfg["clip"] \
            or v["scaling_factor"] != port_vae.SCALING_FACTOR \
            or cfg["guidance_scale"] != 1.0 \
            or cfg["batch"] != 2 * len(cfg["views"]):
        raise ValueError("the port's pipeline does not build this "
                         "configuration")
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → its nearest value with TF32's 10-bit mantissa (ties away from
    zero): the 13 low bits of the significand rounded off."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x → float8_e4m3fn (clamped to its ±448) → x's dtype."""
    return x.float().clamp(-FP8_MAX, FP8_MAX).to(
        torch.float8_e4m3fn).to(x.dtype)


def _round_inputs(module: torch.nn.Module, fn) -> None:
    """Round what enters each linear map and convolution of ``module``."""
    from drawingspinup_torch.models.attention_mv import Conv1x1Tokens

    def hook(_m, args):
        return (fn(args[0]),) + tuple(args[1:])

    for m in module.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, Conv1x1Tokens)):
            m.register_forward_pre_hook(hook)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp_min(1e-30))


class Session:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: str,
                 workdir: str, control: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.workdir, self.control = device, workdir, control
        self.fault: Optional[str] = mix.get("fault")
        if self.fault is not None and self.fault not in FAULTS:
            raise ValueError(f"no fault named {self.fault!r}")
        self.pick = random.Random(inputs.stream(seed, 10))

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from drawingspinup_torch.core import device as device_setup
        from drawingspinup_torch.pipelines import stage2_mv

        cfg, self.phases = self.cfg, {}
        self.views = list(cfg["views"])
        with phase(self.phases, "inputs"):
            dev = self.dev = device_setup.setup(self.device)
            pcfg = pipeline_config(cfg)
            self.drawings = mv_inputs.drawings(
                cfg, self.mix["distinct_drawings"], self.seed, dev)
            w = self.weights = mv_inputs.weights(cfg, self.seed, dev)
            self._scale_unet_head()
        with phase(self.phases, "model"):
            mods = stage2_mv.build_modules(pcfg, dev)
            for part, m in zip(("unet", "vae", "clip"), mods):
                m.load_state_dict(w[part], strict=True)
            self.pipe = stage2_mv.MVPipeline(pcfg, *mods)
            unet = self.pipe.unet_in(getattr(torch, cfg["compute_dtype"]))
            if self.control:
                _round_inputs(unet, round_fp8)
                _round_inputs(self.pipe.clip, round_tf32)
                _round_inputs(self.pipe.vae, round_tf32)
        self.generator = torch.Generator(device=dev).manual_seed(
            inputs.stream(self.seed, 11))
        self.next = self.uids = self.pairs = self.bad = 0
        self.encoded: Dict[int, tuple] = {}
        self.kept_steps: List[Dict] = []
        self.kept_uid: Optional[Dict] = None
        with phase(self.phases, "warmup"):
            self.run_units(self.mix["warmup_uids"])
            self._scale_decoder_head()
            sync(dev)

    @torch.no_grad()
    def _scale_unet_head(self) -> None:
        """The UNet's noise at unit spread: the reference's on the first
        drawing, unit-normal latents, the first timestep."""
        cfg, w = self.cfg, self.weights
        embeds, cond = ref.encode(w["clip"], w["vae"], self.drawings[0], cfg)
        g = inputs.rng(self.seed, 12, self.dev)
        lat = torch.randn((cfg["batch"],) + tuple(cond.shape[1:]),
                          generator=g, device=self.dev)
        head = ref.predict_noise(w["unet"], lat, ref.timesteps(cfg)[0],
                                 embeds, cond, cfg)
        mv_inputs.scale_head(w["unet"], "conv_out", head, 1.0)

    @torch.no_grad()
    def _scale_decoder_head(self) -> None:
        """The decoder's output at spread 0.25 about 0 on the reference's
        decode of the last warm-up uid's final latents (two images), loaded
        into the program's VAE."""
        w = self.weights["vae"]
        out = ref.vae_decode(w, self.last_latents[::6], self.cfg)
        mv_inputs.scale_head(w, "decoder.conv_out", out, 0.25)
        head = self.pipe.vae.decoder.conv_out
        head.weight.copy_(w["decoder.conv_out.weight"])
        head.bias.copy_(w["decoder.conv_out.bias"])

    # -- the unit ----------------------------------------------------------
    @contextlib.contextmanager
    def _planted(self):
        """While open: the recorder of the DDIM updates and of the
        encodings, and the fault, if any."""
        from drawingspinup_torch.models import attention_mv
        from drawingspinup_torch.ops import diffusion

        step, forward = diffusion.ddim_step, attention_mv.Attention.forward
        encode = self.pipe.encode_image
        fault = self.fault

        def recorded_step(dcfg, acp, eps, t, t_prev, sample, eta=0.0,
                          noise=None):
            out = step(dcfg, acp, eps, t, t_prev, sample, eta=eta,
                       noise=None if fault == "no_eta_noise" else noise)
            self._keep_step({"drawing": self.drawing, "uid": self.uids,
                             "step": self.step_no, "x": sample,
                             "noise": noise, "eps": eps, "next": out})
            self.step_no += 1
            self.last_latents = out
            return out

        def recorded_encode(image):
            embeds, cond = encode(image)
            self.encoded[self.drawing] = (embeds, cond)
            return embeds, cond

        def faulty_forward(module, x, context=None, kv_fold=None,
                           num_views=1, split=None):
            if fault == "no_joint" and kv_fold == "domains":
                return torch.zeros_like(x)
            if fault == "views_alone" and kv_fold == "views":
                kv_fold = None
            return forward(module, x, context, kv_fold, num_views, split)

        diffusion.ddim_step = recorded_step
        self.pipe.encode_image = recorded_encode
        if fault in ("views_alone", "no_joint"):
            attention_mv.Attention.forward = faulty_forward
        try:
            yield
        finally:
            diffusion.ddim_step = step
            attention_mv.Attention.forward = forward
            del self.pipe.encode_image

    def _keep_step(self, rec: Dict) -> None:
        """A reservoir of the window's (uid, step) pairs, drawn from the
        seed."""
        k = self.mix["checked_steps"]
        self.pairs += 1
        if len(self.kept_steps) < k:
            self.kept_steps.append(rec)
        else:
            j = self.pick.randrange(self.pairs)
            if j < k:
                self.kept_steps[j] = rec

    def run_units(self, n: int) -> None:
        shape = (self.cfg["batch"], self.cfg["out_size"],
                 self.cfg["out_size"], 3)
        with self._planted():
            for _ in range(n):
                self.drawing, self.step_no = self.next, 0
                out = self.pipe.images_u8(self.drawings[self.drawing],
                                          self.views, self.generator)
                self.next = (self.next + 1) % len(self.drawings)
                self.bad += tuple(out.shape) != shape \
                    or out.dtype != torch.uint8
                self.uids += 1
                # a reservoir of one uid, drawn from the seed
                if self.pick.randrange(self.uids) == 0:
                    self.kept_uid = {"drawing": self.drawing,
                                     "latents": self.last_latents,
                                     "images": out}

    def window(self, seconds: float) -> Dict:
        sync(self.dev)
        self.uids = self.pairs = self.bad = 0
        self.kept_steps, self.kept_uid, self.encoded = [], None, {}
        t0 = time.perf_counter()
        self.window_start = t0
        uids = 0
        while time.perf_counter() - t0 < seconds:
            self.run_units(1)
            uids += 1
        sync(self.dev)
        elapsed = time.perf_counter() - t0
        self.window_kept = (list(self.kept_steps), self.kept_uid,
                            dict(self.encoded))
        images = uids * self.cfg["batch"]
        return {"units": uids, "seconds": elapsed, "attempted": uids,
                "failed": self.bad, "e2e": {"images_per_s": images / elapsed}}

    def free(self) -> None:
        del self.pipe
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        cfg, w = self.cfg, self.weights
        steps, uid, encoded = self.window_kept
        embed = 0.0
        for i, (embeds, cond) in encoded.items():
            r_embeds, r_cond = ref.encode(w["clip"], w["vae"],
                                          self.drawings[i], cfg)
            embed = max(embed, _rel(embeds, r_embeds), _rel(cond, r_cond))
        acp = ref.alphas_cumprod(cfg).to(self.dev)
        ts = ref.timesteps(cfg)
        eps_gap = step_gap = 0.0
        for rec in steps:
            embeds, cond = encoded[rec["drawing"]]
            t = ts[rec["step"]]
            eps = ref.predict_noise(w["unet"], rec["x"], t, embeds, cond,
                                    cfg)
            nxt = ref.ddim_step(cfg, acp, eps, t, rec["x"], rec["noise"])
            eps_gap = max(eps_gap, _rel(rec["eps"], eps))
            step_gap = max(step_gap, float(
                (rec["next"].double() - nxt.double()).norm()
                / (nxt.double() - rec["x"].double()).norm()))
        want = ref.images_u8(w["vae"], uid["latents"], cfg).cpu()
        d = (uid["images"].short() - want.short()).abs()
        self.detail = {
            "steps": sorted((r["uid"], r["step"]) for r in steps),
            "image_uid": uid["drawing"], "drawings": sorted(encoded),
            "saturated_share": float(((want == 0) | (want == 255)).float()
                                     .mean()),
            "final_latent_std": float(uid["latents"].std())}
        return {"embed_rel_l2": embed, "eps_rel_l2": eps_gap,
                "step_rel_l2": step_gap, "image_max_lsb": int(d.max()),
                "image_off_share": float((d > 0).float().mean())}

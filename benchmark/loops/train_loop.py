"""The loop of the training mixes: one character's style-translator training,
as ``pipelines/stage3_translate.py::train_stage`` runs it at world 1.

Set-up writes the rest-pose keyframe's PNGs under the run's directory in
the per-uid layout, loads the pair through ``stage3_data`` onto the card,
builds the port's models from the benchmark's weights and makes the
optimizers, then drives the state from the seed through its first steps
(``checked_steps``, read for the comparison) and ``warmup_steps`` more,
through the window's own call. The window is a closed loop of
``gan.train_step`` on the seeded patch generator, the losses kept on the
card as the loop keeps them, the card synchronised at both ends.
``train_step_ms`` is the window over the steps completed in it.

The comparison: the plain reference follows the checked steps from the
same weights, the same keyframe images and the same patch seed. Numbers:
``loss_gap`` (the first step's five losses, relative), ``grad_gap`` (the
first step's gradient of each G and D leaf, read from the optimizer's
first moment, as the gap between the two norms over the larger of the
leaf's and the median leaf's reference norm; worst leaf) and
``change_gap`` (the same for each leaf's change over the checked steps,
leaves whose reference gradient is under a thousandth of the median
leaf's left out: Adam moves them by round-off alone).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import train as ref_train

UNIT = "step"
LOSS_NAMES = ref_train.LOSS_NAMES
ACTION = "rest_pose"
FRAME = "0001.png"
ZERO_GRAD_SHARE = 1e-3


def gan_config(cfg: Dict, control: bool):
    """The port's ``GANConfig`` of a benchmark configuration; the control
    computes in the port's own bf16 ``compute_dtype``."""
    from drawingspinup_torch.train import gan

    return gan.GANConfig(
        generator=cfg["generator"], filters=tuple(cfg["filters"]),
        resnet_blocks=cfg["resnet_blocks"], tanh=cfg["tanh"],
        append_smoothers=cfg["append_smoothers"],
        input_channels=cfg["input_channels"],
        disc_filters=cfg["disc_filters"], disc_layers=cfg["disc_layers"],
        lr=cfg["lr"], weight_decay=cfg["weight_decay"],
        batch_size=cfg["batch_size"], patch_size=cfg["patch_size"],
        reconstruction_weight=cfg["reconstruction_weight"],
        perception_weight=cfg["perception_weight"],
        adversarial_weight=cfg["adversarial_weight"],
        epochs=cfg["epochs"], log_interval=cfg["log_interval"],
        compute_dtype="bfloat16" if control else cfg["dtype"])


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: List[str]) -> Tuple[float, str]:
    """The worst leaf's |‖prog‖ − ‖ref‖| over max(‖ref leaf‖, median
    ‖ref‖), and the leaf."""
    if not keys:
        return 0.0, ""
    med = float(np.median([ref[k] for k in keys]))
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k)
               for k in keys)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase(phases: Dict[str, float], name: str):
    """Record the seconds a set-up phase takes under ``name``."""
    t = time.perf_counter()
    yield
    phases[name] = time.perf_counter() - t


def _norm(t: torch.Tensor) -> float:
    return float(t.detach().double().norm())


class Session:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: str,
                 workdir: str, control: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.workdir, self.control = device, workdir, control
        self.patch_seed = inputs.stream(seed, 7)

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from drawingspinup_torch.core import device as device_setup
        from drawingspinup_torch.core.contract import UidPaths
        from drawingspinup_torch.pipelines import stage3_data
        from drawingspinup_torch.train import gan

        cfg, self.phases = self.cfg, {}
        paths = UidPaths(self.workdir, "bench")
        action_dir = paths.action_dir(ACTION)
        with phase(self.phases, "inputs"):
            dev = self.dev = device_setup.setup(self.device)
            self.images = inputs.keyframe_images(cfg["frame_size"], self.seed,
                                                 dev)
            for kind in ("color", "pos", "edge"):
                inputs.write_png(os.path.join(action_dir, kind, FRAME),
                                 self.images[kind])
            inputs.write_png(paths.inpainted, self.images["post"])
            self.weights = {
                "gen": inputs.generator_weights(cfg, self.seed, dev,
                                                trained=False),
                "disc": inputs.discriminator_weights(cfg, self.seed, dev),
                "vgg": inputs.vgg_weights(self.seed, dev)}
        with phase(self.phases, "models"):
            self.gcfg = gan_config(cfg, self.control)
            gen, disc, vgg = gan.build_models(self.gcfg, dev)
            gen.load_state_dict(self.weights["gen"])
            disc.load_state_dict(self.weights["disc"])
            vgg.load_state_dict(self.weights["vgg"])
            self.state = gan.TrainState(
                gen, disc, vgg, *gan.make_optimizers(self.gcfg, gen, disc))
        with phase(self.phases, "keyframe"):
            self.data = stage3_data.keyframe_data(
                stage3_data.load_keyframe_pair(
                    action_dir, "color", paths.inpainted,
                    use_mask=cfg["use_mask"], use_pos=cfg["use_pos"],
                    use_edge=cfg["use_edge"], frame=FRAME), dev)
        self.rng = torch.Generator(device=dev).manual_seed(self.patch_seed)
        self.losses: List[torch.Tensor] = []
        self.checked_losses: List[Dict[str, float]] = []
        leaves = {**{f"gen.{k}": p for k, p in gen.named_parameters()},
                  **{f"disc.{k}": p for k, p in disc.named_parameters()}}
        start = {k: p.detach().clone() for k, p in leaves.items()}
        with phase(self.phases, "checked_steps"):
            for s in range(self.mix["checked_steps"]):
                logs = gan.train_step(self.gcfg, self.state, self.data,
                                      self.rng)
                self.checked_losses.append({k: float(logs[k])
                                            for k in LOSS_NAMES})
                if s == 0:
                    self.first_grads = self._first_grads(leaves)
            self.changes = {k: _norm(p.detach() - start[k])
                            for k, p in leaves.items()}
        with phase(self.phases, "warmup"):
            self.run_units(self.mix["warmup_steps"])
            sync(dev)

    def _first_grads(self, leaves: Dict[str, torch.Tensor]
                     ) -> Dict[str, float]:
        """Each leaf's gradient norm as the optimizer got it: Adam's first
        moment after one step is (1 − β1)·g."""
        b1 = self.cfg["betas"][0]
        opts = (self.state.g_opt, self.state.d_opt)
        out = {}
        for k, p in leaves.items():
            st = next((o.state[p] for o in opts if p in o.state), None)
            out[k] = _norm(st["exp_avg"]) / (1 - b1) if st else 0.0
        return out

    # -- the timed path ----------------------------------------------------
    def run_units(self, n: int) -> None:
        from drawingspinup_torch.train import gan

        for _ in range(n):
            logs = gan.train_step(self.gcfg, self.state, self.data, self.rng)
            self.losses.append(torch.stack([logs[k] for k in LOSS_NAMES]))

    def window(self, seconds: float) -> Dict:
        self.losses = []
        sync(self.dev)
        t0 = time.perf_counter()
        self.window_start = t0
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.run_units(1)
            steps += 1
        sync(self.dev)
        elapsed = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(self.losses))).any(1).sum())
        return {"units": steps, "seconds": elapsed, "attempted": steps,
                "failed": bad,
                "e2e": {"train_step_ms": 1e3 * elapsed / steps}}

    def free(self) -> None:
        del self.state, self.data, self.losses
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def check(self) -> Dict[str, float]:
        images = {k: torch.from_numpy(v).to(self.dev)
                  for k, v in self.images.items()}
        data = ref_train.keyframe(images, self.cfg)
        losses, grads, after = ref_train.train_steps(
            self.weights, data, self.cfg, self.patch_seed,
            self.mix["checked_steps"])
        start = {**{f"gen.{k}": v for k, v in self.weights["gen"].items()},
                 **{f"disc.{k}": v for k, v in self.weights["disc"].items()}}
        ref_grad = {k: _norm(v) for k, v in grads.items()}
        ref_change = {k: _norm(v - start[k]) for k, v in after.items()}
        keys = sorted(ref_grad)
        moved = []
        for model in ("gen.", "disc."):
            mine = [k for k in keys if k.startswith(model)]
            med = float(np.median([ref_grad[k] for k in mine]))
            moved += [k for k in mine if ref_grad[k] >= ZERO_GRAD_SHARE * med]
        gaps = [(abs(p[k] - r[k]) / max(abs(r[k]), 1e-12), f"step {s + 1} {k}")
                for s, (p, r) in enumerate(zip(self.checked_losses, losses))
                for k in LOSS_NAMES]
        # the first step's losses: the later steps' swing with Adam's
        # first updates of leaves whose gradient sits at round-off
        loss_gap, worst_loss = max(gaps[:len(LOSS_NAMES)])
        grad_gap, worst_grad = max(
            norm_gap(self.first_grads, ref_grad,
                     [k for k in keys if k.startswith(m)])
            for m in ("gen.", "disc."))
        change_gap, worst_change = max(
            norm_gap(self.changes, ref_change,
                     [k for k in moved if k.startswith(m)])
            for m in ("gen.", "disc."))
        self.detail = {"loss": worst_loss, "grad": worst_grad,
                       "loss_all_steps": max(gaps),
                       "change": worst_change,
                       "left_out": sorted(set(keys) - set(moved))}
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap}

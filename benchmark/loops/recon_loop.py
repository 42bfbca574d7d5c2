"""The loop of the stage-2b mix: one character's NeuS reconstruction, as
``pipelines/stage2_recon.py::recon_uid`` trains it at world 1, without its
checkpoint and export: ``nsr.train_step`` is the unit.

Set-up renders the seed's character from the six DrawingSpinUp poses at
the configuration's view size (``benchmark/recon_inputs.py``), writes the
views in the per-uid ``mv/`` layout, loads them through the normal path's
``stage2_data.load_ortho_data`` (the visual hull and the packed pixel
table included), runs ``nsr.init_state`` with the seed, and then
``warmup_steps`` steps of the schedule below.

The window is a closed loop of ``nsr.train_step`` on that uid, each step's
rays drawn by ``nsr.make_draws`` from the seed's generator. The k-th step
of the run is schedule step s_k = U·(k mod P) + ⌊k / P⌋ mod U, U the
band's ``update_steps`` and P the number of band phases in ``max_steps``
(1000 and 3): the three phases, 4, 5 and 6 active levels, in their
published 1:1:1 ratio whatever the window's length. s_k is set on the
state's step and on Adam's count before the call (the progressive mask,
``n_active = current_level(s_k)``, the learning rate, the bias corrections
and the cos-anneal read them, as at step s_k of ``recon_uid``, where the
two are equal); the call advances both by one. The loss, the mask term and
inv_s are read on the host every ``log_every_n_steps`` steps, as
``recon_uid`` reads them; the card is synchronised at the window's ends
only. ``images_per_s`` is a uid's 12 images over its ``max_steps`` steps:
12 · steps / (max_steps · window seconds). After the window, one step of
each band phase runs under ``torch.profiler`` for the hash-grid kernels'
device times and bytes (``hashgrid_roofline.recon``).

The comparison, teacher-forced: at ``checked_steps`` steps of the window
drawn from the seed among its first ``checked_within`` (as many of each
band phase), the program's state before the step (parameters, moments,
count, step) and the step's draws are kept, then its logged loss terms,
its gradients and its parameters after the update. The plain reference
(``benchmark/reference/nsr.py``) computes the same step from the same
state and draws on the program's views. Numbers:
- ``loss_gap``: the weighted loss terms, the worst relative gap;
- ``grad_gap``: 1 − the cosine between the program's and the reference's
  gradients, every leaf as one vector (a locked level's as zeros), the
  mean over the checked steps. A leaf's own norm is no measure here: in
  bf16 the signed per-sample terms behind a small leaf (the SDF head's
  bias) cancel to well under their rounding, and its norm reads up to
  6× off. The bf16 step's direction error spikes on single steps (to
  ~0.08 against a typical 0.001-0.01), while the control or a fault
  moves every step, so the mean and not the worst step separates them;
- ``change_gap``: the update each leaf received, as stage 3 measures it
  (``train_loop.norm_gap``): the gap between the program's and the
  reference's norms over the larger of the leaf's and the median leaf's
  reference norm, worst leaf, the reference's new value rounded to the
  leaf's stored dtype.

``control`` runs the program with what enters each MLP layer (the hash
features, the tangents and the hidden activations) rounded through
``float8_e4m3fn``, the precision below the configuration's bf16. The mix's
``fault`` plants one of ``FAULTS`` for the session's steps: ``no_eikonal``
(the eikonal term dropped) or ``fine_no_grad`` (the fine samples left out
of the gradient: their field outputs detached in the full evaluation).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import inputs, nsr_work, recon_inputs
from benchmark.loops.train_loop import norm_gap, phase, sync
from benchmark.reference import nsr as ref

UNIT = "step"
UID = "bench"
FAULTS = ("no_eikonal", "fine_no_grad")
FP8_MAX = 448.0


def nsr_config(cfg: Dict):
    """The port's ``NSRConfig`` of a benchmark configuration; raises where
    the port cannot run it as the configuration states it."""
    from drawingspinup_torch.models.fields import (
        MLPConfig, RadianceConfig, SDFFieldConfig,
    )
    from drawingspinup_torch.models.hashgrid import HashGridConfig
    from drawingspinup_torch.train import nsr

    opt = cfg["optimizer"]
    if (opt["b1"], opt["b2"], opt["eps"]) != (
            nsr.NSROptimizer.b1, nsr.NSROptimizer.b2, nsr.NSROptimizer.eps) \
            or not cfg["loss"]["geo_aware"]:
        raise ValueError("the port's NSR step does not run this "
                         "configuration")
    grid = HashGridConfig(**cfg["grid"], table_dtype=cfg["table_dtype"],
                          compute_dtype=cfg["compute_dtype"])
    return nsr.NSRConfig(
        radius=cfg["radius"],
        sdf=SDFFieldConfig(radius=cfg["radius"],
                           feature_dim=cfg["feature_dim"], grid=grid,
                           mlp=MLPConfig(**cfg["sdf_mlp"])),
        radiance=RadianceConfig(input_feature_dim=cfg["feature_dim"] + 3,
                                mlp=MLPConfig(**cfg["radiance_mlp"])),
        variance_init=cfg["variance_init"],
        cos_anneal_end=cfg["cos_anneal_end"],
        train_num_rays=cfg["train_num_rays"], n_coarse=cfg["n_coarse"],
        n_fine=cfg["n_fine"], n_random_pts=cfg["n_random_pts"],
        randomized=True, hull_trange=True, loss=nsr.LossWeights(**cfg["loss"]),
        max_steps=cfg["max_steps"], constant_steps=opt["constant_steps"],
        lr_geometry=opt["lr_geometry"], lr_texture=opt["lr_texture"],
        lr_variance=opt["lr_variance"],
        lr_decay_target=opt["lr_decay_target"])


def band_phases(cfg: Dict) -> int:
    g = cfg["grid"]
    return -(-(cfg["max_steps"] - g["start_step"]) // g["update_steps"])


def schedule_step(cfg: Dict, k: int) -> int:
    """The schedule step of the run's k-th step."""
    g, p = cfg["grid"], band_phases(cfg)
    u = g["update_steps"]
    return g["start_step"] + u * (k % p) + (k // p) % u


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x → float8_e4m3fn (clamped to its ±448) → x's dtype."""
    return x.float().clamp(-FP8_MAX, FP8_MAX).to(
        torch.float8_e4m3fn).to(x.dtype)


def _patched(module, name: str, new, undo: List) -> None:
    undo.append((module, name, getattr(module, name)))
    setattr(module, name, new)


def _norm(t: Optional[torch.Tensor]) -> float:
    return 0.0 if t is None else float(t.detach().double().norm())


class Session:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: str,
                 workdir: str, control: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.workdir, self.control = device, workdir, control
        self.fault: Optional[str] = mix.get("fault")
        if self.fault is not None and self.fault not in FAULTS:
            raise ValueError(f"no fault named {self.fault!r}")

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from drawingspinup_torch.core import device as device_setup
        from drawingspinup_torch.core.contract import VIEWS, UidPaths
        from drawingspinup_torch.pipelines import stage2_data
        from drawingspinup_torch.render import cameras
        from drawingspinup_torch.train import nsr

        cfg, self.phases = self.cfg, {}
        if list(cfg["views"]) != list(VIEWS):
            raise ValueError("the port trains on its six views")
        paths = UidPaths(self.workdir, UID)
        with phase(self.phases, "inputs"):
            dev = self.dev = device_setup.setup(self.device)
            self.ncfg = nsr_config(cfg)
            c2ws, _ = cameras.view_matrices(list(VIEWS))
            front = cameras.opengl_to_opencv(cameras.w2c_opengl("front"))
            to_stored = np.diag([1.0, -1.0, -1.0]) @ front[:3, :3]
            views = recon_inputs.render(self.seed, c2ws, to_stored,
                                        cfg["image_size"], dev)
            recon_inputs.write_views(paths, list(VIEWS), views)
        with phase(self.phases, "data"):
            self.data = stage2_data.load_ortho_data(
                paths, im_size=cfg["image_size"], hull_trange=True,
                radius=cfg["radius"], device=dev)
        with phase(self.phases, "model"):
            self.state = nsr.init_state(self.ncfg, inputs.stream(self.seed,
                                                                 31), dev)
            self.opt = nsr.make_optimizer(self.ncfg)
            self.rng = torch.Generator(device=dev).manual_seed(
                inputs.stream(self.seed, 32))
        self.k = self.bad = 0
        self.check_at: set = set()
        self.kept: List[Dict] = []
        p = band_phases(cfg)
        pick = random.Random(inputs.stream(self.seed, 33))
        within = range(self.mix["checked_within"])
        self.offsets = sorted(
            k for ph in range(p) for k in pick.sample(
                [k for k in within if k % p == ph],
                self.mix["checked_steps"] // p))
        with phase(self.phases, "warmup"):
            self.run_units(self.mix["warmup_steps"])
            sync(dev)

    def _hashgrid_profile(self) -> Dict[str, Dict[str, float]]:
        """The next step of each band phase under ``torch.profiler`` (the
        traced window's reduction keeps only its ten longest operations):
        each hash-grid kernel's device seconds, by the kernel's name in the
        trace, and least bytes (``benchmark/nsr_work.py``, on the points the
        steps encode). Empty off the card."""
        from torch.profiler import ProfilerActivity, profile

        from drawingspinup_torch.kernels import hashgrid as hk

        if self.dev.type != "cuda":
            return {}
        p = band_phases(self.cfg)
        seen: List[tuple] = []
        apply = hk.HashGridFunction.apply

        def record(x, spec, n_active, with_jac, *tables):
            seen.append((x.detach().clone(), spec, n_active, with_jac,
                         tables[0].element_size()))
            return apply(x, spec, n_active, with_jac, *tables)

        hk.HashGridFunction.apply = record
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                self.run_units(p)
                sync(self.dev)
        finally:
            del hk.HashGridFunction.apply
        path = os.path.join(self.workdir, "hashgrid_trace.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        work: Dict[str, float] = {}
        for (xc, spec, na, jc, ts), (xf, _, _, jf, _) in zip(seen[::2],
                                                            seen[1::2]):
            if jc or not jf:
                raise RuntimeError("a step's encodes are not the coarse and "
                                   "the full evaluation's")
            cs = torch.empty((), dtype=spec.cdt).element_size()
            for k, v in nsr_work.step_kernel_bytes(
                    xc, xf, list(zip(spec.res, spec.dense)), spec.n_features,
                    na, spec.cell_rows, spec.table_size, ts, cs).items():
                work[k] = work.get(k, 0.0) + v
        return {"bytes": work, "seconds": nsr_work.kernel_seconds(events)}

    # -- the unit ----------------------------------------------------------
    @contextlib.contextmanager
    def _planted(self):
        """While open: the control's rounding, or the fault, if any."""
        from drawingspinup_torch.models import fields
        from drawingspinup_torch.render import neus
        from drawingspinup_torch.train import losses, nsr

        undo: List = []
        if self.control:
            dot = fields._dot
            _patched(fields, "_dot", lambda h, w: dot(round_fp8(h), w), undo)
        if self.fault == "no_eikonal":
            _patched(losses, "eikonal_loss",
                     lambda grad, mask=None: grad.sum() * 0.0, undo)
        if self.fault == "fine_no_grad":
            ts: Dict[str, torch.Tensor] = {}
            strat, pdf = neus.stratified_samples, neus.sample_pdf
            field = nsr.sdf_with_grad_analytic

            def kept_strat(*a):
                ts["coarse"] = strat(*a)
                return ts["coarse"]

            def kept_pdf(*a):
                ts["fine"] = pdf(*a)
                return ts["fine"]

            def detached_fine(*a):
                outs = field(*a)
                t_c = ts["coarse"]
                order = torch.sort(torch.cat([t_c, ts["fine"]], -1),
                                   -1).indices
                fine = (order >= t_c.shape[-1]).reshape(-1)
                n = fine.shape[0]
                return tuple(torch.cat([torch.where(
                    fine.reshape((n,) + (1,) * (o.dim() - 1)), o[:n].detach(),
                    o[:n]), o[n:]]) for o in outs)

            _patched(neus, "stratified_samples", kept_strat, undo)
            _patched(neus, "sample_pdf", kept_pdf, undo)
            _patched(nsr, "sdf_with_grad_analytic", detached_fine, undo)
        try:
            yield
        finally:
            for module, name, orig in reversed(undo):
                setattr(module, name, orig)

    def _snapshot(self, s: int, n_active: int, draws) -> Dict:
        from drawingspinup_torch.train import nsr

        st = self.state.opt_state
        return {"k": self.k, "step": s, "n_active": n_active,
                "count": st.count, "draws": draws._asdict(),
                "params": {n: p.detach().clone()
                           for n, p in nsr.named_leaves(self.state.params)},
                "mu": {n: v.clone() for n, v in st.mu.items()},
                "nu": {n: v.clone() for n, v in st.nu.items()}}

    def run_units(self, n: int) -> None:
        from drawingspinup_torch.train import nsr

        cfg, ncfg, data = self.cfg, self.ncfg, self.data
        v, h, w = data["masks"].shape
        log_every = self.mix["log_every_n_steps"]
        with self._planted():
            for _ in range(n):
                s = schedule_step(cfg, self.k)
                n_active = ncfg.sdf.grid.current_level(s)
                self.state.step = self.state.opt_state.count = s
                draws = nsr.make_draws(ncfg, v, h, w, self.rng, self.dev)
                snap = self._snapshot(s, n_active, draws) \
                    if self.k in self.check_at else None
                logs = nsr.train_step(ncfg, self.opt, self.state, data,
                                      draws, n_active=n_active)
                if snap is not None:
                    self.check_at.discard(self.k)
                    snap["logs"] = logs
                    snap["grads"] = {
                        name: p.grad for name, p
                        in nsr.named_leaves(self.state.params)
                        if p.grad is not None}
                    snap["after"] = {
                        name: p.detach().clone() for name, p
                        in nsr.named_leaves(self.state.params)}
                    self.kept.append(snap)
                if log_every and self.k % log_every == 0:
                    read = [float(logs[k]) for k in ("loss", "loss_mask",
                                                     "inv_s")]
                    self.bad += not all(math.isfinite(x) for x in read)
                self.k += 1

    def window(self, seconds: float) -> Dict:
        sync(self.dev)
        self.kept, self.bad = [], 0
        self.check_at = {self.k + o for o in self.offsets}
        t0 = time.perf_counter()
        self.window_start = t0
        steps = 0
        # every checked step is taken, however short the window
        while time.perf_counter() - t0 < seconds or self.check_at:
            self.run_units(1)
            steps += 1
        sync(self.dev)
        elapsed = time.perf_counter() - t0
        self.window_kept = list(self.kept)
        images = self.cfg["images_per_uid"] * steps / self.cfg["max_steps"]
        return {"units": steps, "seconds": elapsed, "attempted": steps,
                "failed": self.bad, "e2e": {"images_per_s": images / elapsed},
                "hashgrid": self._hashgrid_profile()}

    def free(self) -> None:
        del self.state, self.opt
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def check(self) -> Dict[str, float]:
        cfg = self.cfg
        data = {k: self.data[k] for k in ("images", "normals", "masks",
                                          "t_range", "view_weights", "c2w")}
        loss_gap = change_gap = 0.0
        worst = {"loss": "", "change": ""}
        grad_gaps: List[float] = []
        for snap in self.window_kept:
            r = ref.train_step(cfg, snap["params"], snap["mu"], snap["nu"],
                               snap["count"], snap["step"], snap["n_active"],
                               data, snap["draws"])
            for term, weight in ref.TERMS:
                got = float(snap["logs"][term]) * cfg["loss"][weight]
                want = r["terms"][term]
                gap = abs(got - want) / max(abs(want), 1e-30)
                if gap > loss_gap:
                    loss_gap, worst["loss"] = gap, term
            names = sorted(r["grads"])
            got = torch.cat([snap["grads"].get(
                n, torch.zeros_like(r["grads"][n])).double().reshape(-1)
                for n in names])
            want = torch.cat([r["grads"][n].double().reshape(-1)
                              for n in names])
            gap = float(1.0 - got @ want
                        / (got.norm() * want.norm()).clamp(min=1e-300))
            grad_gaps.append(gap)
            before = snap["params"]
            got = {n: _norm(snap["after"][n].float() - before[n].float())
                   for n in names}
            want = {n: _norm(r["params"][n].to(before[n].dtype).float()
                             - before[n].float()) for n in names}
            gap, leaf = norm_gap(got, want, names)
            if gap > change_gap:
                change_gap, worst["change"] = gap, leaf
        self.detail = {
            "checked": [(s["k"], s["step"], s["n_active"])
                        for s in self.window_kept],
            "worst": worst, "grad_gaps": [round(g, 6) for g in grad_gaps],
            "loss": float(self.window_kept[-1]["logs"]["loss"])}
        return {"loss_gap": loss_gap,
                "grad_gap": sum(grad_gaps) / len(grad_gaps),
                "change_gap": change_gap}

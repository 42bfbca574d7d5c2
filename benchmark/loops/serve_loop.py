"""The loop of the serving mixes: stylising an animation with a trained
translator, one frame at a time, as
``pipelines/stage3_translate.py::test_on_full_images`` feeds
``gan.generate_full_rgba``.

Set-up makes ``distinct_frames`` u8 source stacks (RGBA, edge, position)
of the seed's character on the card and brings them to the host, as the
PNG decoder would hand them over; makes the translator's weights (batch
norms with spread statistics, the head scaled on the plain reference's
output over a centre crop of the first frame so that tanh is not
saturated) and loads them into the port's generator; then serves
``warmup_frames`` frames. The window is a closed loop over the stacks in
order, each frame back on the host before the next is sent;
``images_per_s`` is the frames returned over the window.

The comparison: a sample of the window's frames, drawn from the seed
(a reservoir of ``checked_frames``), against the plain reference's frame
of the same source stack. Numbers: ``rgb_max_lsb`` (the largest
difference of a u8 RGB value), ``rgb_off_share`` (the share of RGB values
that differ at all) and ``alpha_max_lsb`` (alpha is a copy of the
input's, exact).
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import inputs
from benchmark.loops.train_loop import gan_config, phase, sync
from benchmark.reference import serve as ref_serve

UNIT = "frame"
CROP = 128      # side of the centre crop the head is scaled on


class Session:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: str,
                 workdir: str, control: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.workdir, self.control = device, workdir, control
        self.pick = random.Random(inputs.stream(seed, 8))

    def setup(self) -> None:
        from drawingspinup_torch.core import device as device_setup
        from drawingspinup_torch.train import gan

        cfg, self.phases = self.cfg, {}
        with phase(self.phases, "inputs"):
            dev = self.dev = device_setup.setup(self.device)
            self.stacks = inputs.frame_stacks(cfg["frame_size"],
                                              self.mix["distinct_frames"],
                                              self.seed, dev)
            w = inputs.generator_weights(cfg, self.seed, dev, trained=True)
            lo = (cfg["frame_size"] - CROP) // 2
            crop = torch.from_numpy(np.ascontiguousarray(
                self.stacks[0, lo:lo + CROP, lo:lo + CROP])).to(dev)
            inputs.rescale_head(w, *ref_serve.pre_tanh_stats(w, crop, cfg))
            self.weights = w
        with phase(self.phases, "model"):
            self.model = gan.build_generator(gan_config(cfg, self.control),
                                             dev)
            self.model.load_state_dict(w)
        self.next = self.served = self.bad = 0
        self.kept: List[Tuple[int, np.ndarray]] = []
        with phase(self.phases, "warmup"):
            self.run_units(self.mix["warmup_frames"])
            sync(dev)

    def run_units(self, n: int) -> None:
        from drawingspinup_torch.train import gan

        cfg, k = self.cfg, self.mix["checked_frames"]
        shape = (cfg["frame_size"], cfg["frame_size"], 4)
        for _ in range(n):
            i = self.next
            out = gan.generate_full_rgba(self.model, self.stacks[i],
                                         cfg["use_mask"], cfg["use_pos"],
                                         cfg["use_edge"])
            self.next = (i + 1) % len(self.stacks)
            self.bad += out.shape != shape or out.dtype != np.uint8
            # reservoir sample of the served frames, drawn from the seed
            self.served += 1
            if len(self.kept) < k:
                self.kept.append((i, out))
            else:
                j = self.pick.randrange(self.served)
                if j < k:
                    self.kept[j] = (i, out)

    def window(self, seconds: float) -> Dict:
        sync(self.dev)
        self.served = self.bad = 0
        self.kept = []
        t0 = time.perf_counter()
        self.window_start = t0
        frames = 0
        while time.perf_counter() - t0 < seconds:
            self.run_units(1)
            frames += 1
        sync(self.dev)
        elapsed = time.perf_counter() - t0
        self.window_kept = list(self.kept)
        return {"units": frames, "seconds": elapsed, "attempted": frames,
                "failed": self.bad, "e2e": {"images_per_s": frames / elapsed}}

    def free(self) -> None:
        del self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        worst_rgb = worst_alpha = off = total = 0
        for i, out in self.window_kept:
            ref = ref_serve.frame(self.weights, torch.from_numpy(
                self.stacks[i]).to(self.dev), self.cfg).cpu().numpy()
            d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
            worst_rgb = max(worst_rgb, int(d[..., :3].max()))
            worst_alpha = max(worst_alpha, int(d[..., 3].max()))
            off += int((d[..., :3] > 0).sum())
            total += d[..., :3].size
        self.detail = {"frames": sorted(i for i, _ in self.window_kept)}
        return {"rgb_max_lsb": worst_rgb,
                "rgb_off_share": off / max(total, 1),
                "alpha_max_lsb": worst_alpha}

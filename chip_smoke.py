#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``drawingspinup_torch``) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the checkout's sources and drives the
stage-3 serving path (test_stage1 → test_stage2 → GIF) at the production
width on 512² frames, with weights drawn from a seed. Phases, one line
each:

  1. versions, and the card's name and power limit (nvidia-smi);
  2. build the RIC conv kernel, with the build time;
  3. kernel against its plain PyTorch twin at the 8 RIC layer shapes of a
     512² GeneratorJ_RIC forward: max |kernel − plain| ≤ 1e-4 · max |plain|,
     with the median CUDA-event time of each;
  4. the main path through the port's CLIs on a synthetic uid (2 actions ×
     4 frames): exactly 21 kernel launches per GeneratorJ_RIC frame, every
     frame and GIF written, ms per frame of each stage;
  5. one whole frame, kernel path against plain path on the card: u8 RGB
     within ±1 LSB on < 2 % of pixels, alpha exact, outputs finite.

Then a JSON line per the kernels it ran, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so it does without a CUDA device or
outside a checkout. It imports no JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FRAME = 512
ACTIONS = ("jump", "walk")
FRAMES_PER_ACTION = 4
UID = "smoke"
F32_TOL = 1e-3          # phase 5: tanh outputs of 21 reordered-sum layers
REL_TOL = 1e-4          # phase 3: f32 sums of up to 9·C products, reordered
RIC_SOURCE = "drawingspinup_torch/kernels/csrc/ric_conv_fwd.cu"
RIC_REPLACES = "drawingspinup_tpu/kernels/ric_conv.py:100"

# (H = W, C, O, launches per 512² GeneratorJ_RIC forward)
RIC_SHAPES = (
    (512, 6, 32, 1),        # conv0
    (256, 32, 64, 1),       # conv1
    (128, 64, 128, 1),      # conv2
    (128, 128, 128, 14),    # res{0..6}_conv{0,1}
    (256, 256, 128, 1),     # upconv2
    (512, 192, 128, 1),     # upconv1
    (512, 166, 64, 1),      # conv_11
    (512, 64, 64, 1),       # smooth1
)
RIC_PER_FRAME = sum(s[3] for s in RIC_SHAPES)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_versions() -> str:
    import torch

    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def phase_build() -> None:
    from drawingspinup_torch.kernels import _build

    t0 = time.time()
    _build.extension()
    print(f"[2] built the RIC conv kernel in {time.time() - t0:.1f} s "
          f"into {_build.BUILD_DIR}")


def phase_kernel_vs_plain(device, shapes=RIC_SHAPES, reps: int = 10):
    """Per shape: (max abs err, kernel ms, plain ms). Raises on a shape
    where the kernel disagrees with the twin."""
    import torch

    from drawingspinup_torch.kernels import ric_conv as rk
    from drawingspinup_torch.models.ric_tables import ric_shifted_weights

    results = []
    for k, (hw, c, o, _) in enumerate(shapes):
        g = torch.Generator(device=device).manual_seed(SEED + k)
        x = torch.randn((1, hw, hw, c), generator=g, device=device)
        wk = torch.randn((9, c, o), generator=g, device=device) \
            / math.sqrt(9 * c)
        swf = torch.from_numpy(ric_shifted_weights(hw, hw).copy()).to(device)
        want = rk.ric_conv_reference(x, wk, swf)
        got = rk.ric_conv_fwd(x, wk, swf)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(math.isfinite(err) and err <= REL_TOL * scale,
              f"kernel disagrees at (H,C,O)={(hw, c, o)}: max err {err:.3e}"
              f" > {REL_TOL:g} * {scale:.3e}")
        ms = cuda_ms(lambda: rk.ric_conv_fwd(x, wk, swf), reps)
        plain = cuda_ms(lambda: rk.ric_conv_reference(x, wk, swf), reps)
        print(f"[3] ric_conv_fwd (H,C,O)=({hw},{c},{o}): max err {err:.3e} "
              f"(max |plain| {scale:.3e}), kernel {ms:.3f} ms, "
              f"plain {plain:.3f} ms")
        results.append((err, ms, plain))
    return results


def write_uid(root: str, uid: str, size: int, frames: int, seed: int):
    """Synthetic per-uid render tree: a character-like disc with RGBA
    ``color``, ``pos`` and ``edge`` passes for each action and frame."""
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.core.io import write_image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    paths = UidPaths(root, uid)
    for action in ACTIONS:
        for k in range(1, frames + 1):
            cy, cx = size * rng.uniform(0.4, 0.6, 2)
            r = np.hypot(yy - cy, xx - cx)
            mask = r < size * rng.uniform(0.25, 0.4)
            color = np.empty((size, size, 4), np.float32)
            color[..., :3] = rng.uniform(0.2, 0.9, 3) * (
                0.75 + 0.25 * np.sin(xx / 7.0 + k)[..., None])
            color[..., :3] *= mask[..., None]
            color[..., 3] = mask
            pos = np.stack([xx / size, yy / size, np.zeros_like(r)], -1)
            edge = np.where(mask & (r > size * 0.22), 0.0, 1.0)
            name = f"{k:04d}.png"
            d = paths.action_dir(action)
            write_image(os.path.join(d, "color", name), color)
            write_image(os.path.join(d, "pos", name), pos * mask[..., None])
            write_image(os.path.join(d, "edge", name), edge)
    return paths


def seeded_generator(stage: int, device, x_u8: np.ndarray):
    """Full-width generator of ``stage`` with seeded weights, non-trivial
    batch-norm affine parameters and running statistics, and its 1×1 head
    rescaled so that the pre-tanh output on the frame ``x_u8`` has mean 0
    and std 0.5: a random He init otherwise drives most pixels into
    tanh's flat ends, where the u8 comparison of phase 5 checks little."""
    import torch

    from drawingspinup_torch.models.generator_j import BatchNorm
    from drawingspinup_torch.pipelines import stage3_translate as st
    from drawingspinup_torch.train import gan

    g = torch.Generator(device=device).manual_seed(SEED + stage)
    model = gan.build_generator(st.make_config(stage), device, g)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            n = m.weight.numel()
            m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g,
                                                 device=device))
            m.bias.copy_(0.1 * torch.randn(n, generator=g, device=device))
            m.running_mean.copy_(0.1 * torch.randn(n, generator=g,
                                                   device=device))
            m.running_var.copy_(0.5 + torch.rand(n, generator=g,
                                                 device=device))
    x, _ = gan.full_frame_features(x_u8, True, True, stage == 2, device)
    model.tanh = False
    with torch.no_grad():
        y = model(x)
    model.tanh = True
    k = 0.5 / y.std().item()
    model.head.weight.mul_(k)
    model.head.bias.copy_(k * (model.head.bias - y.mean()))
    return model


def stage_log_dir(paths, stage: int) -> str:
    from drawingspinup_torch.pipelines import stage3_translate as st

    return os.path.join(paths.mesh_dir, st.log_name_for(stage, True, True))


def phase_main_path(root: str, device) -> int:
    """test_stage1 → test_stage2 → GIF through the port's CLIs; returns
    the kernel launches of that run."""
    import torch
    from PIL import Image

    from drawingspinup_torch.cli import gif_writer
    from drawingspinup_torch.cli import test_stage1, test_stage2
    from drawingspinup_torch.kernels import ric_conv as rk
    from drawingspinup_torch.pipelines import stage3_translate as st
    from drawingspinup_torch.train import gan

    from drawingspinup_torch.pipelines import stage3_data

    uid = UID
    paths = write_uid(root, uid, FRAME, FRAMES_PER_ACTION, SEED)
    for stage in (1, 2):
        x_u8 = stage3_data.load_full_frame_u8(
            paths.action_dir(ACTIONS[0]), "0001.png", stage == 2)
        gan.save_checkpoint(stage_log_dir(paths, stage),
                            seeded_generator(stage, device, x_u8),
                            st.FINAL_STEP)
    n = len(ACTIONS) * FRAMES_PER_ACTION
    args = ["--uid", uid, "--root", root, "--device", str(device)]
    rk.LAUNCHES = 0
    t0 = time.time()
    test_stage1.main(args)
    torch.cuda.synchronize()
    t1 = time.time()
    test_stage2.main(args)
    torch.cuda.synchronize()
    t2 = time.time()
    gif_writer.main(args[:4])
    t3 = time.time()
    launches = rk.LAUNCHES
    check(launches == RIC_PER_FRAME * n,
          f"{launches} RIC kernel launches, expected {RIC_PER_FRAME} x {n}")
    for stage in (1, 2):
        for action in ACTIONS:
            d = os.path.join(paths.action_dir(action),
                             st.res_dir_name(stage, True, True))
            pngs = sorted(os.listdir(d))
            check(len(pngs) == FRAMES_PER_ACTION,
                  f"stage {stage} wrote {len(pngs)} frames in {d}")
            with Image.open(os.path.join(d, pngs[0])) as im:
                check(im.size == (FRAME, FRAME) and im.mode == "RGBA",
                      f"stage {stage} frame is {im.size} {im.mode}")
    for action in ACTIONS:
        with Image.open(paths.gif(action)) as im:
            check(im.n_frames == FRAMES_PER_ACTION,
                  f"{paths.gif(action)} has {im.n_frames} frames")
    print(f"[4] main path: {n} frames of {FRAME}^2 per stage, "
          f"{launches} RIC kernel launches ({launches // n} per frame); "
          f"test_stage1 {1e3 * (t1 - t0) / n:.1f} ms/frame, "
          f"test_stage2 {1e3 * (t2 - t1) / n:.1f} ms/frame, "
          f"gif_writer {1e3 * (t3 - t2) / n:.1f} ms/frame "
          f"(CLI wall time: model load, PNG IO and first-call set-up "
          f"included)")
    return launches


@contextlib.contextmanager
def plain_ric_convs():
    """Route every RIC conv of the generators through the plain twin."""
    from drawingspinup_torch.kernels import ric_conv as rk

    kernel = rk.ric_conv
    rk.ric_conv = rk.ric_conv_reference
    try:
        yield
    finally:
        rk.ric_conv = kernel


def phase_whole_frame(root: str, device) -> None:
    """One 512² frame through the stage-1 generator of the main path's
    checkpoint, kernel path against plain path, and the steady-state
    forward time of each stage's generator."""
    import torch

    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.pipelines import stage3_data
    from drawingspinup_torch.pipelines import stage3_translate as st
    from drawingspinup_torch.train import gan

    paths = UidPaths(root, UID)
    models = [gan.load_checkpoint(stage_log_dir(paths, stage),
                                  gan.build_generator(st.make_config(stage),
                                                      device))
              for stage in (1, 2)]
    x_u8 = stage3_data.load_full_frame_u8(paths.action_dir(ACTIONS[0]),
                                          "0001.png", False)
    x, _ = gan.full_frame_features(x_u8, True, True, False, device)
    with torch.no_grad():
        y_kernel = models[0](x)
        with plain_ric_convs():
            y_plain = models[0](x)
    check(bool(torch.isfinite(y_kernel).all()
               and torch.isfinite(y_plain).all()),
          "non-finite generator output")
    f32_err = (y_kernel - y_plain).abs().max().item()
    check(f32_err <= F32_TOL,
          f"f32 output: max |kernel - plain| {f32_err:.3e} > {F32_TOL:g}")
    got = gan.generate_full_rgba(models[0], x_u8, True, True, False)
    with plain_ric_convs():
        want = gan.generate_full_rgba(models[0], x_u8, True, True, False)
    check(np.array_equal(got[..., 3], want[..., 3]), "alpha differs")
    diff = np.abs(got[..., :3].astype(np.int16) - want[..., :3])
    frac = float((diff > 0).mean())
    check(diff.max() <= 1 and frac < 0.02,
          f"u8 RGB: max diff {diff.max()}, {frac:.2%} of pixels differ")
    rgb = got[..., :3]
    saturated = float(((rgb == 0) | (rgb == 255)).mean())
    with torch.no_grad():
        ms_kernel = cuda_ms(lambda: models[0](x), reps=5)
        with plain_ric_convs():
            ms_plain = cuda_ms(lambda: models[0](x), reps=5)
        ms_stage2 = cuda_ms(lambda: models[1](x), reps=5)
    print(f"[5] whole frame {FRAME}^2: max |kernel - plain| {f32_err:.3e} "
          f"(f32, after tanh), u8 RGB {frac:.3%} of values off by 1, alpha "
          f"exact, {saturated:.1%} of RGB values at 0 or 255; forward "
          f"GeneratorJ_RIC {ms_kernel:.2f} ms (kernel) vs {ms_plain:.2f} ms "
          f"(plain), GeneratorJ {ms_stage2:.2f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "drawingspinup_torch")):
        print(f"chip_smoke: no drawingspinup_torch package beside "
              f"{__file__}; run it from a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from drawingspinup_torch.core import device as device_setup
    from drawingspinup_torch.kernels import ric_conv as rk

    device = device_setup.setup("cuda")
    phase_versions()
    phase_build()
    per_shape = phase_kernel_vs_plain(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        launches = phase_main_path(root, device)
        phase_whole_frame(root, device)
    ms = sum(s[3] * r[1] for s, r in zip(RIC_SHAPES, per_shape))
    plain_ms = sum(s[3] * r[2] for s, r in zip(RIC_SHAPES, per_shape))
    print(json.dumps({"kernels": [{
        "name": "ric_conv_fwd", "route": "cuda", "source": RIC_SOURCE,
        "replaces": RIC_REPLACES, "launches": launches,
        "max_abs_err": max(r[0] for r in per_shape),
        "ms": ms, "plain_ms": plain_ms,
        "timed": f"sum over the {RIC_PER_FRAME} RIC convs of one "
                 f"{FRAME}^2 GeneratorJ_RIC forward (phase 3 medians)"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

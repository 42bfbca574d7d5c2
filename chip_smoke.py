#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``drawingspinup_torch``) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources and drives
stage 3 at the production width (configs/config_stage{1,2}.yaml), with
weights drawn from a seed: the serving path (test_stage1 → test_stage2 →
GIF) on 512² frames, then the training path (train_stage1 → test_stage1 →
train_stage2 → test_stage2 → GIF) on batches of 40 × 32² patches. Phases:

  1. versions, and the card's name and power limit (nvidia-smi);
  2. build the RIC conv kernels (forward and backward), with the build time;
  3. forward kernel against its plain PyTorch twin at the 8 RIC layer
     shapes of a 512² GeneratorJ_RIC forward: max |kernel − plain| ≤ 1e-4 ·
     max |plain|, with the median CUDA-event time of each;
  4. the serving path through the port's CLIs on a synthetic uid (2 actions
     × 4 frames): exactly 21 kernel launches per GeneratorJ_RIC frame,
     every frame and GIF written, ms per frame of each stage;
  5. one whole frame, kernel path against plain path on the card: u8 RGB
     within ±1 LSB on < 2 % of pixels, alpha exact, outputs finite;
  6. backward kernel against its plain twin at the 8 RIC layer shapes of a
     training step (N = 40): dx and dwk within 3e-4 · max |plain|, a second
     launch bit-identical, the median CUDA-event time of each (and of the
     forward kernel at the same shapes);
  7. the training path through the port's CLIs on a second synthetic uid
     (the same actions, a rest_pose keyframe and the character drawings):
     22 forward and 21 backward launches per stage-1 step and 21 forward
     launches per stage-1 frame, finite losses, stage 1's image loss
     falling, checkpoints, frames and GIFs written; ms per step of each
     stage with the host synchronised;
  8. one training step, kernel path against plain path, from one state and
     batch, the plain path run in float64 as the reference: losses within
     relative 1e-4, every generator gradient within relative L2 error 1e-2
     (the f32 plain path's figures printed beside); the kernel path
     bit-identical across two runs; ms per step of each path in f32, and a
     profile of where a step's device time goes. The gradient bound sits
     above the step's rounding floor: its ReLU and max-pool decisions flip
     under a random 1e-6 relative perturbation of the RIC outputs, which
     moves a gradient by up to ~3e-3, in either path.

Then a JSON line per the kernels it ran, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so it does without a CUDA device or
outside a checkout. It imports no JAX.
"""
from __future__ import annotations

import contextlib
import copy
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
BWD_REL_TOL = 3e-4      # phase 6: the Pallas VJP's bound (test_ric_pallas.py)
STEP_REL_TOL = 1e-4     # phase 8: losses
GRAD_REL_TOL = 1e-2     # phase 8: relative L2 error of each gradient vs f64
RIC_SOURCE = "drawingspinup_torch/kernels/csrc/ric_conv_fwd.cu"
RIC_REPLACES = "drawingspinup_tpu/kernels/ric_conv.py:100"
BWD_SOURCE = "drawingspinup_torch/kernels/csrc/ric_conv_bwd.cu"
BWD_REPLACES = "drawingspinup_tpu/kernels/ric_conv.py:128"
TRAIN_UID = "smoke_train"
TRAIN_BATCHES = (100, 20)   # --max-batches of stage 1 and stage 2
BATCH = 40

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

# (H = W, C, O, forward launches, backward launches) per training step on
# 40 × 32² patches: conv0 needs no dx; smooth0 runs forward only
TRAIN_SHAPES = (
    (32, 6, 32, 1, 1),      # conv0
    (16, 32, 64, 1, 1),     # conv1
    (8, 64, 128, 1, 1),     # conv2
    (8, 128, 128, 14, 14),  # res{0..6}_conv{0,1}
    (16, 256, 128, 1, 1),   # upconv2
    (32, 192, 128, 1, 1),   # upconv1
    (32, 166, 64, 1, 1),    # conv_11
    (32, 64, 64, 2, 1),     # smooth0, smooth1
)
FWD_PER_STEP = sum(s[3] for s in TRAIN_SHAPES)
BWD_PER_STEP = sum(s[4] for s in TRAIN_SHAPES)


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
    print(f"[2] built the RIC conv kernels in {time.time() - t0:.1f} s "
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


def write_uid(root: str, uid: str, size: int, frames: int, seed: int,
              training: bool = False):
    """Synthetic per-uid render tree: a character-like disc with RGBA
    ``color``, ``pos`` and ``edge`` passes for each action and frame. For
    ``training``, also a one-frame ``rest_pose`` action (the keyframe) and
    the two character drawings under ``char/``."""
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.core.io import write_image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    paths = UidPaths(root, uid)
    actions = [(a, frames) for a in ACTIONS]
    if training:
        actions.append(("rest_pose", 1))
    for action, n_frames in actions:
        for k in range(1, n_frames + 1):
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
    if training:
        # the drawings: the keyframe's disc in flat, banded colours on white
        ref = np.asarray(np.hypot(yy - size / 2, xx - size / 2) < size * 0.3)
        bands = (np.floor(yy / (size / 8)) % 2)[..., None]
        ink = np.where(bands > 0, [0.85, 0.35, 0.2], [0.2, 0.45, 0.8])
        drawing = np.where(ref[..., None], ink, 1.0).astype(np.float32)
        write_image(paths.inpainted, drawing)
        write_image(paths.texture_with_bg, drawing[..., ::-1].copy())
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


def phase_bwd_vs_plain(device, reps: int = 10):
    """Per training shape (N = 40): the backward kernel against its plain
    twin (dx and dwk, and a second launch bit-identical), and the forward
    kernel at the same shape; returns per shape (max abs err, bwd ms, bwd
    plain ms, fwd ms, fwd plain ms)."""
    import torch

    from drawingspinup_torch.kernels import ric_conv as rk
    from drawingspinup_torch.models.ric_tables import ric_shifted_weights

    results = []
    for k, (hw, c, o, _, _) in enumerate(TRAIN_SHAPES):
        g = torch.Generator(device=device).manual_seed(SEED + 100 + k)
        x = torch.randn((BATCH, hw, hw, c), generator=g, device=device)
        wk = torch.randn((9, c, o), generator=g, device=device) \
            / math.sqrt(9 * c)
        cot = torch.randn((BATCH, hw, hw, o), generator=g, device=device)
        swf = torch.from_numpy(ric_shifted_weights(hw, hw).copy()).to(device)
        need_dx = k > 0                       # conv0's input needs none
        want = rk.ric_conv_bwd_reference(x, wk, swf, cot, need_dx)
        got = rk.ric_conv_bwd(x, wk, swf, cot, need_dx)
        again = rk.ric_conv_bwd(x, wk, swf, cot, need_dx)
        fwd_want = rk.ric_conv_reference(x, wk, swf)
        fwd_got = rk.ric_conv_fwd(x, wk, swf)
        torch.cuda.synchronize()
        errs = []
        for name, a, b, tol in (("dx", got[0], want[0], BWD_REL_TOL),
                                ("dwk", got[1], want[1], BWD_REL_TOL),
                                ("fwd", fwd_got, fwd_want, REL_TOL)):
            if a is None:
                continue
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            check(math.isfinite(err) and err <= tol * scale,
                  f"{name} disagrees at (H,C,O)={(hw, c, o)}: max err "
                  f"{err:.3e} > {tol:g} * {scale:.3e}")
            errs.append(err)
        check(torch.equal(got[1], again[1]) and (
            not need_dx or torch.equal(got[0], again[0])),
              f"backward not bit-identical across launches at {(hw, c, o)}")
        ms = cuda_ms(lambda: rk.ric_conv_bwd(x, wk, swf, cot, need_dx), reps)
        plain = cuda_ms(lambda: rk.ric_conv_bwd_reference(
            x, wk, swf, cot, need_dx), reps)
        fwd_ms = cuda_ms(lambda: rk.ric_conv_fwd(x, wk, swf), reps)
        fwd_plain = cuda_ms(lambda: rk.ric_conv_reference(x, wk, swf), reps)
        dx_err = f"{errs[0]:.3e}" if need_dx else "(no dx)"
        print(f"[6] ric_conv_bwd N={BATCH} (H,C,O)=({hw},{c},{o}): max err "
              f"dx {dx_err} dwk {errs[-2]:.3e} (max |plain dwk| "
              f"{want[1].abs().max().item():.3e}), bit-identical; kernel "
              f"{ms:.3f} ms, plain {plain:.3f} ms; forward kernel "
              f"{fwd_ms:.3f} ms, plain {fwd_plain:.3f} ms")
        results.append((max(errs[:-1]), ms, plain, fwd_ms, fwd_plain,
                        errs[-1]))
    return results


def keyframe(paths, stage: int, device):
    """The stage's training keyframe pair of ``paths``, on ``device``."""
    from drawingspinup_torch.pipelines import stage3_data
    from drawingspinup_torch.pipelines import stage3_translate as st

    return stage3_data.keyframe_data(stage3_data.load_keyframe_pair(
        paths.action_dir("rest_pose"), st.pre_dir_for_stage(stage, True, True),
        st.post_path_for_stage(paths, stage),
        use_edge=st.stage_settings(stage)["use_edge"]), device)


def stage_config(stage: int):
    from drawingspinup_torch.pipelines import stage3_translate as st

    return st.gan_config_from_yaml(st.DEFAULT_STAGE_CFGS[stage])[0]


def steady_ms_per_step(paths, stage: int, device, steps: int = 20,
                       warmup: int = 3) -> float:
    """Host-clock ms per training step of ``stage`` after ``warmup`` steps,
    the host synchronised at both ends."""
    import torch

    from drawingspinup_torch.train import gan

    cfg = stage_config(stage)
    data = keyframe(paths, stage, device)
    state = gan.init_state(cfg, device, SEED)
    g = torch.Generator(device=device).manual_seed(SEED)
    for _ in range(warmup):
        gan.train_step(cfg, state, data, g)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        gan.train_step(cfg, state, data, g)
    torch.cuda.synchronize()
    return 1e3 * (time.time() - t0) / steps


def phase_training(root: str, device):
    """train_stage1 → test_stage1 → train_stage2 → test_stage2 → GIF
    through the port's CLIs; returns the (forward, backward) kernel
    launches of that run."""
    import torch
    from PIL import Image

    from drawingspinup_torch.cli import gif_writer
    from drawingspinup_torch.cli import test_stage1, test_stage2
    from drawingspinup_torch.cli import train_stage1, train_stage2
    from drawingspinup_torch.kernels import ric_conv as rk
    from drawingspinup_torch.pipelines import stage3_translate as st

    paths = write_uid(root, TRAIN_UID, FRAME, FRAMES_PER_ACTION, SEED + 7,
                      training=True)
    actions = ACTIONS + ("rest_pose",)
    n_frames = len(ACTIONS) * FRAMES_PER_ACTION + 1
    args = ["--uid", TRAIN_UID, "--root", root, "--device", str(device)]
    train_args = args + ["--allow-degraded-weights", "--seed", str(SEED)]
    runs = ((train_stage1.main,
             train_args + ["--max-batches", str(TRAIN_BATCHES[0])]),
            (test_stage1.main, args),
            (train_stage2.main,
             train_args + ["--max-batches", str(TRAIN_BATCHES[1])]),
            (test_stage2.main, args),
            (gif_writer.main, args[:4]))
    rk.LAUNCHES = rk.BWD_LAUNCHES = 0
    times = [time.time()]
    for main, argv in runs:
        main(argv)
        torch.cuda.synchronize()
        times.append(time.time())
    fwd, bwd = rk.LAUNCHES, rk.BWD_LAUNCHES
    want_fwd = FWD_PER_STEP * TRAIN_BATCHES[0] + RIC_PER_FRAME * 2 * n_frames
    want_bwd = BWD_PER_STEP * TRAIN_BATCHES[0]
    check(fwd == want_fwd and bwd == want_bwd,
          f"training path: {fwd} forward / {bwd} backward launches, expected "
          f"{want_fwd} / {want_bwd}")
    for stage, steps in zip((1, 2), TRAIN_BATCHES):
        log_dir = stage_log_dir(paths, stage)
        check(os.path.exists(os.path.join(log_dir, "model_99999.pt")),
              f"no final checkpoint in {log_dir}")
        with open(os.path.join(log_dir, "train_losses.json")) as f:
            losses = json.load(f)
        check(all(len(v) == steps and np.isfinite(v).all()
                  for v in losses.values()),
              f"stage {stage}: non-finite or missing losses")
        for action in actions:
            d = os.path.join(paths.action_dir(action),
                             st.res_dir_name(stage, True, True))
            want = FRAMES_PER_ACTION if action in ACTIONS else 1
            pngs = sorted(os.listdir(d))
            check(len(pngs) == want, f"stage {stage} wrote {len(pngs)} "
                                     f"frames in {d}")
        if stage == 1:
            img = np.asarray(losses["image_loss"])
            first, last = float(img[:10].mean()), float(img[-10:].mean())
            check(last < first, f"stage 1 image loss did not fall: first 10 "
                                f"steps {first:.4f}, last 10 {last:.4f}")
    for action in actions:
        with Image.open(paths.gif(action)) as im:
            want = FRAMES_PER_ACTION if action in ACTIONS else 1
            check(im.n_frames == want,
                  f"{paths.gif(action)} has {im.n_frames} frames")
    steady = [steady_ms_per_step(paths, stage, device) for stage in (1, 2)]
    print(f"[7] training path: {fwd} forward (= {FWD_PER_STEP} x "
          f"{TRAIN_BATCHES[0]} steps + {RIC_PER_FRAME} x {2 * n_frames} "
          f"frames) and {bwd} backward (= {BWD_PER_STEP} x "
          f"{TRAIN_BATCHES[0]}) RIC launches; stage 1 image loss "
          f"{first:.4f} (first 10 steps) -> {last:.4f} (last 10); CLI wall "
          f"train_stage1 {times[1] - times[0]:.1f} s, test_stage1 "
          f"{times[2] - times[1]:.1f} s, train_stage2 {times[3] - times[2]:.1f}"
          f" s, test_stage2 {times[4] - times[3]:.1f} s, gif_writer "
          f"{times[5] - times[4]:.1f} s; steady ms/step (host synchronised, "
          f"3 warm-up steps excluded) stage 1 {steady[0]:.2f}, stage 2 "
          f"{steady[1]:.2f}")
    return fwd, bwd


def profile_step(cfg, state, batch, steps: int = 5) -> None:
    """Where one training step's device time goes (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from drawingspinup_torch.train import gan

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            gan.train_step_on_batch(cfg, state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0) / steps
    # kernels only: a user annotation (the optimizer's step range) spans
    # kernels that are counted already
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if total <= 0:
        print("[8] profile: the profiler saw no device time (not measured)")
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3 / steps:.3f} ms "
        f"x{e.count // steps}" for e in kernels[:8])
    launches = sum(e.count for e in kernels) / steps
    print(f"[8] profile of {steps} kernel-path steps: device busy {total:.2f}"
          f" ms of {wall:.2f} ms wall per step ({total / wall:.1%}, the "
          f"profiler's overhead included), {launches:.0f} kernel launches per"
          f" step; by kernel, per step: {top}")


def phase_step_vs_plain(root: str, device) -> None:
    """One stage-1 training step at the production width from one state
    and one batch: the kernel path against the plain path (autograd through
    the plain twin) in float64, and in f32 for the record; the kernel path
    twice for determinism; ms per step of each path in f32 and a
    profile."""
    import torch

    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.pipelines import stage3_data
    from drawingspinup_torch.train import gan

    cfg = stage_config(1)
    data = keyframe(UidPaths(root, TRAIN_UID), 1, device)
    state = gan.init_state(cfg, device, SEED)
    batch = stage3_data.sample_patches(
        data, torch.Generator(device=device).manual_seed(SEED + 1),
        cfg.batch_size, cfg.patch_size)

    def step(plain: bool, dtype=torch.float32):
        st = copy.deepcopy(state)       # the step moves batch statistics
        b = batch
        if dtype != torch.float32:
            for m in (st.gen, st.disc, st.vgg):
                m.to(dtype)
            b = {k: v.to(dtype) for k, v in batch.items()}
        with plain_ric_convs() if plain else contextlib.nullcontext():
            logs = gan.train_step_on_batch(cfg, st, b)
        return ({k: v.item() for k, v in logs.items()},
                {n: p.grad.double() for n, p in st.gen.named_parameters()})

    (lk, gk), (lk2, gk2) = step(False), step(False)
    lp, gp = step(True)
    lref, gref = step(True, torch.float64)
    for k in gan.LOSS_NAMES:
        check(math.isfinite(lk[k]) and abs(lk[k] - lref[k])
              <= STEP_REL_TOL * abs(lref[k]),
              f"step loss {k}: kernel {lk[k]:.6g} vs plain {lref[k]:.6g}")

    def errors(grads):
        """Relative L2 error of each leaf against the float64 plain path
        (a zero-gradient leaf must be exactly zero)."""
        out = {}
        for n, want in gref.items():
            diff = (grads[n] - want).norm().item()
            norm = want.norm().item()
            check(norm or not diff, f"{n}: nonzero gradient")
            if norm:
                out[n] = diff / norm
        return out

    ek, ep = errors(gk), errors(gp)
    for n, err in ek.items():
        check(math.isfinite(err) and err <= GRAD_REL_TOL,
              f"gradient of {n}: relative L2 error {err:.3e} > "
              f"{GRAD_REL_TOL:g} (f32 plain path: {ep[n]:.3e})")

    def top(errs) -> str:
        return ", ".join(f"{n} {e:.2e}" for n, e in sorted(
            errs.items(), key=lambda kv: -kv[1])[:3])

    check(lk == lk2 and all(torch.equal(gk[n], gk2[n]) for n in gk),
          "the kernel path's step is not bit-identical across runs")
    ms = {}
    for plain in (False, True):
        st = copy.deepcopy(state)
        with plain_ric_convs() if plain else contextlib.nullcontext():
            ms[plain] = cuda_ms(
                lambda: gan.train_step_on_batch(cfg, st, batch), reps=10)
    print(f"[8] one training step against the plain path in float64: losses"
          f" within {max(abs(lk[k] - lref[k]) / abs(lref[k]) for k in lk):.2e}"
          f" relative; generator gradients' relative L2 error, worst "
          f"leaves: kernel path {top(ek)}; f32 plain path {top(ep)}; "
          f"kernel path bit-identical across runs;"
          f" median ms/step in f32: kernel {ms[False]:.2f}, plain "
          f"{ms[True]:.2f} (CUDA events)")
    profile_step(cfg, copy.deepcopy(state), batch)

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
        serving_launches = phase_main_path(root, device)
        phase_whole_frame(root, device)
        train_shapes = phase_bwd_vs_plain(device)
        fwd_launches, bwd_launches = phase_training(root, device)
        phase_step_vs_plain(root, device)

    def step_sum(col: int, count: int) -> float:
        return sum(s[count] * r[col] for s, r in zip(TRAIN_SHAPES,
                                                     train_shapes))

    print(json.dumps({"kernels": [{
        "name": "ric_conv_fwd", "route": "cuda", "source": RIC_SOURCE,
        "replaces": RIC_REPLACES, "launches": fwd_launches,
        "max_abs_err": max(max(r[0] for r in per_shape),
                           max(r[5] for r in train_shapes)),
        "ms": sum(s[3] * r[1] for s, r in zip(RIC_SHAPES, per_shape)),
        "plain_ms": sum(s[3] * r[2] for s, r in zip(RIC_SHAPES, per_shape)),
        "timed": f"sum over the {RIC_PER_FRAME} RIC convs of one "
                 f"{FRAME}^2 GeneratorJ_RIC forward (phase 3 medians)",
        "launches_serving_path": serving_launches,
        "ms_train_step": step_sum(3, 3), "plain_ms_train_step": step_sum(4, 3),
    }, {
        "name": "ric_conv_bwd", "route": "cuda", "source": BWD_SOURCE,
        "replaces": BWD_REPLACES, "launches": bwd_launches,
        "max_abs_err": max(r[0] for r in train_shapes),
        "ms": step_sum(1, 4), "plain_ms": step_sum(2, 4),
        "timed": f"sum over the {BWD_PER_STEP} RIC backward launches of one "
                 f"training step, N={BATCH} (phase 6 medians)",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

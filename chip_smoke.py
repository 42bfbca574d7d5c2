#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``drawingspinup_torch``) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels and the native mesh library from the
checkout's sources and drives stage 3 at the production width
(configs/config_stage{1,2}.yaml), with weights drawn from a seed: the
serving path (test_stage1 → test_stage2 → GIF) on 512² frames, then the
training path (train_stage1 → test_stage1 → train_stage2 → test_stage2 →
GIF) on batches of 40 × 32² patches. Then stage 2b at the production width
of configs/neus-ortho.yaml, trained from a seed: the recon CLI on six 1024²
views of a synthetic sphere, 600 steps, export at mc512. Phases:

  1. versions, and the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (RIC conv forward and backward, hash-grid encode
     and table gradient, row gather) and the native library, with the build
     times;
  3. forward kernel (3xTF32 implicit GEMM) against its plain PyTorch twin
     at the 8 RIC layer shapes of a 512² GeneratorJ_RIC forward: max
     |kernel − plain| ≤ 1e-4 · max |plain|, within relative L2 1e-5 of the
     twin run in float64, a limit that the same product on TF32-rounded
     operands (plain TF32) misses, a second launch bit-identical; the
     median CUDA-event time of each, the bound and the share of it reached,
     and the yardstick: torch.matmul in f32 of U · Wk, with U the sampled
     input (``ric_conv_sample_reference``) built outside the timed region
     (timed here only; the port never calls it);
  4. the serving path through the port's CLIs on a synthetic uid (2 actions
     × 4 frames): exactly 21 kernel launches per GeneratorJ_RIC frame,
     every frame and GIF written, ms per frame of each stage;
  5. one whole frame, kernel path against plain path on the card: u8 RGB
     within ±1 LSB on < 2 % of pixels, alpha exact, outputs finite;
  6. backward kernels against their plain twins at the 8 RIC layer shapes
     of a training step (N = 40): dx and dwk within 3e-4 · max |plain| and
     within relative L2 1e-5 of the twin run in float64, a limit that the
     same products on TF32-rounded operands (plain TF32) miss, the sampled
     cotangent within 1e-4, a second launch bit-identical; the median
     CUDA-event time of the whole backward and of its parts (dz, the dx
     GEMM, the dwk GEMM with its ordered sum), its bound and the share of
     it reached, and the yardstick: torch.matmul of the same two products
     in f32 on the same dz (timed here only; the port never calls it); and
     the forward kernel at the same shapes, with phase 3's checks and
     yardstick;
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
     moves a gradient by up to ~3e-3, in either path;
  9. the hash-grid encode (K1) and table-gradient (K2) kernels against their
     plain twins on the production table (10 levels, 2^19 rows), at a
     step's full eval (135 168 points, with the jacobian) and coarse pass
     (65 536 points), n_active 4, 5 and 6, in bf16 and f32: K1 within
     1e-5 · max |plain| (f32) or one bf16 ulp of the largest output, K2
     within relative L2 1e-5 (f32) or 1e-2 (bf16) of the twin's f32 sums
     and bit-identical from launch to launch; the median CUDA-event time of
     each;
 10. the row-gather kernel (K3) against tab[idx], bit-equal, at the Pallas
     gathers' shapes (T = 74³ and 129³ rows of 16 bf16, K = 262 144);
 11. the recon CLI (``python -m drawingspinup_torch.cli.recon``) on a
     synthetic sphere uid with the cuts trainer.max_steps=600,
     system.constant_steps=100, update_steps=200 (4 → 5 → 6 levels): per
     step exactly one K1 without the jacobian (coarse pass), one with, one
     K2 and one K3 (the pixel targets), plus one K1 per export evaluation;
     loss falling, inv_s rising, the OBJ under the reference name with the
     sphere's median radius within 35 %; ms per step of each band phase and
     the export's parts;
 12. one NSR step from the trained state and one set of draws, kernel path
     against plain path: f32 against the plain path in float64 (losses
     within relative 1e-4, every gradient within relative L2 1e-2, the f32
     plain path's errors printed beside); bf16 against the bf16 plain path
     (losses within 1e-5, gradients within relative L2 1e-2) and against
     the f32 plain path (each loss and gradient no farther from f32 than
     1.25 x the bf16 plain path's: bf16 rounding alone puts both paths'
     losses ~1e-2 and gradients 10-40 % from f32); ms per production step
     of each path, and a profile;
 13. the export's u8 field at mc512 from the trained params, kernel field
     against plain field: more than 1 apart on < 0.5 % of voxels, marched
     vertex and face counts within 10 %.

Kernel times (phases 3, 6, 9, 10) are medians of CUDA events around each
call, the host's enqueueing included (``ms``, and every plain and library
time), and for the kernels also of calls queued behind a sleep kernel, so
that the events span the device's work alone (``device_ms``); frame and
step times (phases 5, 8, 12) include the host's enqueueing. Every phase
line ends with the card's name and power limit. Then a JSON line per the
kernels it ran, each with its bound (the larger of its bytes over 3.35
TB/s and its operations over the card's fastest rate for their accuracy:
f32 products at 3xTF32, three TF32 products at 495 TFLOP/s per f32
product, with the bound at 67 TFLOP/s of f32 outside the tensor cores
beside it) and, where one PyTorch call computes the same function, that
call's time; and last
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
F64_REL_L2 = 1e-5       # phases 3, 6: RIC kernels vs float64 (plain TF32 misses)
STEP_REL_TOL = 1e-4     # phase 8: losses
GRAD_REL_TOL = 1e-2     # phase 8: relative L2 error of each gradient vs f64
RIC_SOURCE = "drawingspinup_torch/kernels/csrc/ric_conv_fwd_gemm.cu"
RIC_REPLACES = "drawingspinup_tpu/kernels/ric_conv.py:100"
BWD_SOURCE = "drawingspinup_torch/kernels/csrc/ric_conv_bwd_gemm.cu"
BWD_REPLACES = "drawingspinup_tpu/kernels/ric_conv.py:128"
TRAIN_UID = "smoke_train"
RECON_UID = "smoke_recon"
RECON_SIZE = 1024           # the six views' size, as in production
# the smoke configuration: production widths, 600 steps, the band's
# update every 200 steps so that all three band phases (4, 5, 6 levels) run
RECON_OVERRIDES = ("trainer.max_steps=600", "system.constant_steps=100",
                   "model.geometry.xyz_encoding_config.update_steps=200")
# (points, with the jacobian): a production step's full eval (2048 rays x
# 64 samples + 2 x 2048 probes) and its coarse pass (2048 x 32)
HG_POINTS = ((2048 * 64 + 4096, True), (2048 * 32, False))
HG_ACTIVE = (4, 5, 6)
GATHER_ROWS = (74 ** 3, 129 ** 3)   # scripts/bench_pallas_gather.py's tables
GATHER_K = 262144
RECON_MC, RECON_FACES = 512, 50000  # the export's grid and faces (the yaml's)
HG_SOURCE = "drawingspinup_torch/kernels/csrc/hashgrid_fwd.cu"
HG_REPLACES = "scripts/bench_pallas_gather.py:94"
HG_BWD_SOURCE = "drawingspinup_torch/kernels/csrc/hashgrid_bwd.cu"
HG_BWD_REPLACES = "drawingspinup_tpu/models/hashgrid.py:180"
GATHER_SOURCE = "drawingspinup_torch/kernels/csrc/row_gather.cu"
GATHER_REPLACES = "scripts/bench_pallas_gather.py:76"
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


CARD = ""                   # nvidia-smi's name and power limit (phase 1)
TIMED = ("ms, plain_ms, library_ms: CUDA events around each call, the host's "
         "enqueueing included; device_ms: the kernel's calls queued behind a "
         "sleep kernel, the device's work alone")

# an H100 SXM's published peaks (NVIDIA's data sheet, dense): the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12           # f32 outside the tensor cores
TF32_FLOPS = 495e12         # TF32 on the tensor cores


def bound_ms(nbytes: float, flops: float, peak: float):
    """(least ms for ``nbytes`` of device memory traffic and ``flops`` at
    ``peak`` FLOP/s, "bytes" or "operations": which of the two sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ric_fwd_work(n: int, hw: int, c: int, o: int):
    """(bytes, FLOPs) of one RIC conv forward: x, wk, swf read and the
    output written once; the channel products, 2·9·C·O per pixel (the
    tap sampling's ≤ 73·min(C, O) multiply-adds per pixel left out)."""
    px = n * hw * hw
    return 4 * (px * (c + o) + 9 * c * o + 81 * hw * hw), 2 * 9 * c * o * px


def ric_bwd_work(n: int, hw: int, c: int, o: int, need_dx: bool):
    """(bytes, FLOPs) of one RIC conv backward: x, g, wk, swf read and dx
    (if needed) and dwk written once; the two products, 2·9·C·O FLOPs per
    pixel each (the sampling of dz, 73·O multiply-adds, left out)."""
    px = n * hw * hw
    nbytes = 4 * (px * (c + o + (c if need_dx else 0)) + 2 * 9 * c * o
                  + 81 * hw * hw)
    return nbytes, 2 * 9 * c * o * px * (2 if need_dx else 1)


def report(msg: str) -> None:
    """Print a phase's line with the card it was measured on."""
    print(f"{msg} [{CARD}]")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms; the events
    span the host's enqueueing as well as the device's work."""
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


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms, each call
    enqueued behind a sleep kernel that outlasts twice its host time, so
    that the events span the device's work alone (launch gaps included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * max(host_s, 5e-5) * 2e9)       # at most ~2 GHz
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def ric_bounds(nbytes: float, flops: float):
    """(bound ms, what sets it, bound ms at f32 outside the tensor cores)
    of RIC conv work of ``nbytes`` and ``flops`` f32 FLOPs: the card's
    fastest f32-accurate products are 3xTF32, three TF32 products each."""
    ms, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS)
    return ms, by, bound_ms(nbytes, flops, F32_FLOPS)[0]


def rna_tf32(t):
    """cvt.rna.tf32.f32 of an f32 tensor: round to nearest, ties away from
    zero, to 10 mantissa bits (the low 13 bits cleared)."""
    import torch

    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def fwd_accuracy(x, wk, swf, got, where: str):
    """(relative L2 error of the forward's ``got``, and of plain TF32: the
    same product U · Wk on TF32-rounded operands) against the twin run in
    float64; raises unless the first is within F64_REL_L2 and the second is
    not."""
    from drawingspinup_torch.kernels import ric_conv as rk

    c, o = wk.shape[1], wk.shape[2]
    want = rk.ric_conv_reference(x.double(), wk.double(), swf.double())
    u = rk.ric_conv_sample_reference(x, swf).view(-1, 9 * c)
    tf32 = rna_tf32(u).double() @ rna_tf32(wk.view(9 * c, o)).double()
    norm = want.norm()
    f64 = ((got.double() - want).norm() / norm).item()
    plain = ((tf32.view(want.shape) - want).norm() / norm).item()
    check(math.isfinite(f64) and f64 <= F64_REL_L2,
          f"ric_conv_fwd at {where}: relative L2 error {f64:.3e} against "
          f"float64 > {F64_REL_L2:g}")
    check(plain > F64_REL_L2,
          f"ric_conv_fwd at {where}: plain TF32's relative L2 error "
          f"{plain:.3e} does not exceed {F64_REL_L2:g}, so the float64 check "
          f"cannot tell it from 3xTF32")
    return f64, plain


def fwd_times(x, wk, swf, reps: int) -> dict:
    """The forward's times, its plain twin's, and the cuBLAS yardstick's:
    torch.matmul in f32 of U (P × 9C) · Wk (9C × O), U built first."""
    import torch

    from drawingspinup_torch.kernels import ric_conv as rk

    c, o = wk.shape[1], wk.shape[2]
    u = rk.ric_conv_sample_reference(x, swf).view(-1, 9 * c)
    w2 = wk.view(9 * c, o)

    def fwd():
        rk.ric_conv_fwd(x, wk, swf)

    def library():
        torch.matmul(u, w2)

    return {"ms": cuda_ms(fwd, reps), "device_ms": device_ms(fwd, reps),
            "plain_ms": cuda_ms(lambda: rk.ric_conv_reference(x, wk, swf),
                                reps),
            "library_ms": cuda_ms(library, reps),
            "library_device_ms": device_ms(library, reps)}


def phase_versions() -> str:
    import torch

    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    return CARD


def phase_build() -> None:
    from drawingspinup_torch import native
    from drawingspinup_torch.kernels import _build

    t0 = time.time()
    _build.extension()
    t1 = time.time()
    native.build()
    report(f"[2] built the CUDA kernels (RIC conv forward and backward, "
           f"hash-grid encode and table gradient, row gather) in "
           f"{t1 - t0:.1f} s into {_build.BUILD_DIR}, the native mesh library "
           f"in {time.time() - t1:.1f} s into {native.BUILD_DIR}")


def phase_kernel_vs_plain(device, shapes=RIC_SHAPES, reps: int = 10):
    """Per shape: a dict of the errors (against the twin and float64, plain
    TF32's beside), the times and the bound. Raises on a shape where the
    kernel disagrees with the twin or float64, or differs between two
    launches."""
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
        again = rk.ric_conv_fwd(x, wk, swf)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(math.isfinite(err) and err <= REL_TOL * scale,
              f"kernel disagrees at (H,C,O)={(hw, c, o)}: max err {err:.3e}"
              f" > {REL_TOL:g} * {scale:.3e}")
        check(torch.equal(got, again),
              f"forward not bit-identical across launches at {(hw, c, o)}")
        del want, again
        f64, plain_tf32 = fwd_accuracy(x, wk, swf, got, f"{(hw, c, o)}")
        row = {"err": err, "f64_rel_l2": f64, "tf32_rel_l2": plain_tf32,
               **fwd_times(x, wk, swf, reps)}
        row["bound_ms"], by, bound_f32 = ric_bounds(*ric_fwd_work(1, hw, c,
                                                                  o))
        plan = rk.fwd_plan(1, hw, hw, c, o)
        report(f"[3] ric_conv_fwd (H,C,O)=({hw},{c},{o}): max err {err:.3e} "
               f"(max |plain| {scale:.3e}), relative L2 against float64 "
               f"{f64:.2e} (plain TF32 {plain_tf32:.2e}), bit-identical; "
               f"kernel {row['ms']:.3f} ms (device {row['device_ms']:.3f} "
               f"ms; {plan.blocks} blocks of {plan.bn} outputs, "
               f"{plan.slices} slices), plain {row['plain_ms']:.3f} ms, "
               f"bound {row['bound_ms']:.4f} ms (3xTF32, {by}; f32 "
               f"{bound_f32:.4f} ms), {row['bound_ms'] / row['device_ms']:.1%}"
               f" of it; torch.matmul f32 of U·Wk {row['library_ms']:.3f} ms "
               f"(device {row['library_device_ms']:.3f} ms)")
        results.append(row)
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
    report(f"[4] main path: {n} frames of {FRAME}^2 per stage, "
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
    report(f"[5] whole frame {FRAME}^2: max |kernel - plain| {f32_err:.3e} "
           f"(f32, after tanh), u8 RGB {frac:.3%} of values off by 1, alpha "
           f"exact, {saturated:.1%} of RGB values at 0 or 255; forward "
           f"GeneratorJ_RIC {ms_kernel:.2f} ms (kernel) vs {ms_plain:.2f} ms "
           f"(plain), GeneratorJ {ms_stage2:.2f} ms")


def phase_bwd_vs_plain(device, reps: int = 10):
    """Per training shape (N = 40): the backward against its plain twin (dx
    and dwk, the sampled cotangent, a second launch bit-identical) and
    against the twin in float64, beside plain TF32's error there; the
    times of its parts, its bound and the cuBLAS yardstick, and the forward
    kernel at the same shape; returns one dict per shape."""
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
        dz = rk.bwd_dz(cot, swf)
        dz_want = rk.ric_conv_bwd_dz_reference(cot, swf)
        fwd_want = rk.ric_conv_reference(x, wk, swf)
        fwd_got = rk.ric_conv_fwd(x, wk, swf)
        fwd_again = rk.ric_conv_fwd(x, wk, swf)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b, tol in (("dx", got[0], want[0], BWD_REL_TOL),
                                ("dwk", got[1], want[1], BWD_REL_TOL),
                                ("dz", dz.view(dz_want.shape), dz_want,
                                 REL_TOL),
                                ("fwd", fwd_got, fwd_want, REL_TOL)):
            if a is None:
                continue
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            check(math.isfinite(err) and err <= tol * scale,
                  f"{name} disagrees at (H,C,O)={(hw, c, o)}: max err "
                  f"{err:.3e} > {tol:g} * {scale:.3e}")
            errs[name] = err
        check(torch.equal(got[1], again[1]) and (
            not need_dx or torch.equal(got[0], again[0])),
              f"backward not bit-identical across launches at {(hw, c, o)}")
        check(torch.equal(fwd_got, fwd_again),
              f"forward not bit-identical across launches at {(hw, c, o)}")
        del fwd_want, fwd_again
        fwd_f64, fwd_tf32 = fwd_accuracy(x, wk, swf, fwd_got,
                                         f"N={BATCH} {(hw, c, o)}")
        dx_plan, dwk_plan = rk.bwd_plan(BATCH, hw, hw, c, o)
        dz2 = dz.view(-1, 9 * o)
        wkt = wk.transpose(1, 2).reshape(9 * o, c)
        x2 = x.view(-1, c)
        # float64: the kernel's f32 products, and the same products on
        # TF32-rounded operands (plain TF32), whose error the limit catches
        want64 = rk.ric_conv_bwd_reference(x.double(), wk.double(),
                                           swf.double(), cot.double(), need_dx)
        dz64 = rna_tf32(dz2).double()
        tf32 = (dz64 @ rna_tf32(wkt).double() if need_dx else None,
                (rna_tf32(x2).double().t() @ dz64).view(c, 9, o)
                .permute(1, 0, 2))
        f64, f64_tf32 = {}, {}
        for name, a, t, b in zip(("dx", "dwk"), got, tf32, want64):
            if a is None:
                continue
            f64[name] = ((a.double() - b).norm() / b.norm()).item()
            f64_tf32[name] = ((t.reshape(b.shape) - b).norm()
                              / b.norm()).item()
            check(math.isfinite(f64[name]) and f64[name] <= F64_REL_L2,
                  f"{name} at (H,C,O)={(hw, c, o)}: relative L2 error "
                  f"{f64[name]:.3e} against float64 > {F64_REL_L2:g}")
            check(f64_tf32[name] > F64_REL_L2,
                  f"{name} at (H,C,O)={(hw, c, o)}: plain TF32's relative "
                  f"L2 error {f64_tf32[name]:.3e} does not exceed "
                  f"{F64_REL_L2:g}, so the float64 check cannot tell it "
                  f"from 3xTF32")
        del want64, dz64, tf32

        def library():
            if need_dx:
                torch.matmul(dz2, wkt)
            torch.matmul(x2.t(), dz2)

        def bwd():
            rk.ric_conv_bwd(x, wk, swf, cot, need_dx)

        row = {
            "err": max(errs[n] for n in ("dx", "dwk") if n in errs),
            "fwd_err": errs["fwd"],
            "f64_rel_l2": max(f64.values()),
            "tf32_rel_l2": min(f64_tf32.values()),
            "ms": cuda_ms(bwd, reps),
            "device_ms": device_ms(bwd, reps),
            "plain_ms": cuda_ms(lambda: rk.ric_conv_bwd_reference(
                x, wk, swf, cot, need_dx), reps),
            "dz_device_ms": device_ms(lambda: rk.bwd_dz(cot, swf), reps),
            "dx_device_ms": device_ms(lambda: rk.bwd_dx(dz, wk, dx_plan),
                                      reps) if need_dx else 0.0,
            "dwk_device_ms": device_ms(lambda: rk.bwd_dwk(x, dz, dwk_plan),
                                       reps),
            "library_ms": cuda_ms(library, reps),
            "library_device_ms": device_ms(library, reps),
            "fwd_f64_rel_l2": fwd_f64,
            "fwd_tf32_rel_l2": fwd_tf32,
        }
        row.update({"fwd_" + k: v
                    for k, v in fwd_times(x, wk, swf, reps).items()})
        (row["bound_ms"], row["bound_by"],
         row["bound_f32_ms"]) = ric_bounds(*ric_bwd_work(BATCH, hw, c, o,
                                                         need_dx))
        fwd_bound = ric_bounds(*ric_fwd_work(BATCH, hw, c, o))
        row["fwd_bound_ms"], row["fwd_bound_f32_ms"] = (fwd_bound[0],
                                                        fwd_bound[2])
        fplan = rk.fwd_plan(BATCH, hw, hw, c, o)
        dx_part = (f"dx GEMM {row['dx_device_ms']:.3f} ms ({dx_plan.blocks} "
                   f"blocks, {dx_plan.slices} slices)" if need_dx
                   else "no dx")
        dx_err = f"{errs['dx']:.3e}" if need_dx else "(no dx)"
        report(f"[6] ric_conv_bwd N={BATCH} (H,C,O)=({hw},{c},{o}): max err "
               f"dx {dx_err} dwk {errs['dwk']:.3e} "
               f"(max |plain dwk| {want[1].abs().max().item():.3e}), dz "
               f"{errs['dz']:.3e}, bit-identical; relative L2 against "
               f"float64 " + ", ".join(
                   f"{n} {f64[n]:.2e} (plain TF32 {f64_tf32[n]:.2e})"
                   for n in f64) + f"; kernel {row['ms']:.3f} ms, device "
               f"{row['device_ms']:.3f} ms = dz {row['dz_device_ms']:.3f} + "
               f"{dx_part} + dwk GEMM and sum {row['dwk_device_ms']:.3f} ms "
               f"({dwk_plan.blocks} blocks, {dwk_plan.slices} slices); bound "
               f"{row['bound_ms']:.4f} ms (3xTF32, {row['bound_by']}; f32 "
               f"{row['bound_f32_ms']:.4f}), "
               f"{row['bound_ms'] / row['device_ms']:.1%} of it; torch.matmul "
               f"f32 of the products "
               f"{row['library_ms']:.3f} ms (device "
               f"{row['library_device_ms']:.3f} ms); plain "
               f"{row['plain_ms']:.3f} ms; forward: relative L2 against "
               f"float64 {fwd_f64:.2e} (plain TF32 {fwd_tf32:.2e}), "
               f"bit-identical, kernel {row['fwd_ms']:.3f} ms (device "
               f"{row['fwd_device_ms']:.3f}; {fplan.blocks} blocks, "
               f"{fplan.slices} slices), bound {row['fwd_bound_ms']:.4f} ms, "
               f"{row['fwd_bound_ms'] / row['fwd_device_ms']:.1%} of it, "
               f"torch.matmul f32 of U·Wk {row['fwd_library_ms']:.3f} ms "
               f"(device {row['fwd_library_device_ms']:.3f}), plain "
               f"{row['fwd_plain_ms']:.3f} ms")
        results.append(row)
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
    report(f"[7] training path: {fwd} forward (= {FWD_PER_STEP} x "
           f"{TRAIN_BATCHES[0]} steps + {RIC_PER_FRAME} x {2 * n_frames} "
           f"frames) and {bwd} backward (= {BWD_PER_STEP} x "
           f"{TRAIN_BATCHES[0]}) RIC launches; stage 1 image loss "
           f"{first:.4f} (first 10 steps) -> {last:.4f} (last 10); CLI wall "
           f"train_stage1 {times[1] - times[0]:.1f} s, test_stage1 "
           f"{times[2] - times[1]:.1f} s, train_stage2 "
           f"{times[3] - times[2]:.1f} s, test_stage2 {times[4] - times[3]:.1f} s, gif_writer "
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
        report("[8] profile: the profiler saw no device time (not measured)")
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3 / steps:.3f} ms "
        f"x{e.count // steps}" for e in kernels[:8])
    launches = sum(e.count for e in kernels) / steps
    report(f"[8] profile of {steps} kernel-path steps: device busy {total:.2f}"
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
    worst = max(abs(lk[k] - lref[k]) / abs(lref[k]) for k in lk)
    report(f"[8] one training step against the plain path in float64: losses"
           f" within {worst:.2e}"
           f" relative; generator gradients' relative L2 error, worst "
           f"leaves: kernel path {top(ek)}; f32 plain path {top(ep)}; "
           f"kernel path bit-identical across runs;"
           f" median ms/step in f32: kernel {ms[False]:.2f}, plain "
           f"{ms[True]:.2f} (CUDA events)")
    profile_step(cfg, copy.deepcopy(state), batch)


# ---------------------------------------------------------------------------
# stage 2b: NSR reconstruction and the hash-grid kernels
# ---------------------------------------------------------------------------

def recon_config(**grid):
    """The production NSR config of configs/neus-ortho.yaml, with the smoke
    run's cuts, and the hash grid's dtypes replaced by ``grid``."""
    import dataclasses

    from drawingspinup_torch.core.config import load_config
    from drawingspinup_torch.pipelines import stage2_recon

    cfg = stage2_recon.nsr_config_from_yaml(load_config(
        os.path.join(REPO, "drawingspinup_torch", "configs",
                     "neus-ortho.yaml"), list(RECON_OVERRIDES)))
    if grid:
        g = dataclasses.replace(cfg.sdf.grid, **grid)
        cfg = dataclasses.replace(cfg, sdf=dataclasses.replace(cfg.sdf,
                                                               grid=g))
    return cfg


@contextlib.contextmanager
def plain_hashgrid():
    """Route the hash-grid encode, its table gradient and the row gather
    through their plain twins, on CUDA tensors as on the CPU."""
    from drawingspinup_torch.kernels import hashgrid as hk

    saved = hk.hashgrid_fwd, hk.hashgrid_bwd, hk.row_gather
    hk.hashgrid_fwd = hk.hashgrid_fwd_reference
    hk.hashgrid_bwd = hk.hashgrid_bwd_reference
    hk.row_gather = hk.row_gather_reference
    try:
        yield
    finally:
        hk.hashgrid_fwd, hk.hashgrid_bwd, hk.row_gather = saved


def ulp_bf16(x) -> float:
    """One bf16 ulp of the largest |x|."""
    m = x.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def hashgrid_work(x, tables, spec, n_active: int, with_jac: bool):
    """(bytes, FLOPs) of one encode and of one table gradient at the points
    x: the encode reads x and the table rows the points' corners touch and
    writes enc (and denc); the gradient reads x, g_enc and g_denc's active
    columns and writes the active tables' f32 gradients. Per (point, level,
    corner): 2 products for the weight and 2·F ops for the features, four
    times with the jacobian; the gradient 8 + 8·F."""
    import torch

    from drawingspinup_torch.kernels import hashgrid as hk

    p, nf = x.shape[0], spec.n_features
    lf = len(spec.res) * nf
    rows = sum(int(torch.unique(hk._corners(
        x, spec.res[lvl], spec.dense[lvl], spec.cell_rows,
        spec.table_size)[0]).numel()) for lvl in range(n_active))
    cs = torch.empty((), dtype=spec.cdt).element_size()
    ts = tables[0].element_size()
    outs = 4 if with_jac else 1
    fwd = (12 * p + rows * nf * ts + outs * p * lf * cs,
           outs * p * n_active * 8 * (2 + 2 * nf))
    grads = sum(tables[lvl].shape[0] for lvl in range(n_active)) * nf * 4
    bwd = (12 * p + outs * p * n_active * nf * cs + grads,
           p * n_active * 8 * (8 + 8 * nf))
    return fwd, bwd


def phase_hashgrid_vs_plain(device, reps: int = 10):
    """The encode (K1) and table-gradient (K2) kernels against their plain
    twins on the production table, at the step's point counts and the
    band's first three phases; returns per (dtype, n_active) the numbers
    the summary line needs."""
    import torch

    from drawingspinup_torch.kernels import hashgrid as hk
    from drawingspinup_torch.models import hashgrid as thg

    results = []
    for dt in ("bfloat16", "float32"):
        grid = recon_config(table_dtype=dt, compute_dtype=dt).sdf.grid
        spec = grid.spec()
        g = torch.Generator(device=device).manual_seed(SEED + 200)
        tables = [(torch.randn(t.shape, generator=g, device=device) * 0.1)
                  .to(grid.tdt) for t in thg.init_table(grid, g, device)]
        lf = grid.n_levels * grid.n_features_per_level
        for na in HG_ACTIVE:
            row = {"dtype": dt, "n_active": na}
            for p, jac in HG_POINTS:
                x = torch.rand((p, 3), generator=g, device=device)
                got = hk.hashgrid_fwd(x, tables, spec, na, jac)
                want = hk.hashgrid_fwd_reference(x, tables, spec, na, jac)
                torch.cuda.synchronize()
                err = 0.0
                for a, b in zip(got, want):
                    if a is None:
                        continue
                    e = (a.float() - b.float()).abs().max().item()
                    bound = (1e-5 * b.abs().max().item() if dt == "float32"
                             else ulp_bf16(b))
                    check(math.isfinite(e) and e <= bound,
                          f"hashgrid_fwd {dt} n_active={na} P={p}: max err "
                          f"{e:.3e} > {bound:.3e}")
                    err = max(err, e)
                key = "jac" if jac else "enc"
                row[key + "_err"] = err
                row[key + "_work"], bwd_work = hashgrid_work(x, tables, spec,
                                                             na, jac)
                if jac:
                    row["bwd_work"] = bwd_work
                row[key + "_ms"] = cuda_ms(
                    lambda: hk.hashgrid_fwd(x, tables, spec, na, jac), reps)
                row[key + "_device_ms"] = device_ms(
                    lambda: hk.hashgrid_fwd(x, tables, spec, na, jac), reps)
                row[key + "_plain_ms"] = cuda_ms(
                    lambda: hk.hashgrid_fwd_reference(x, tables, spec, na,
                                                      jac), reps)
                if not jac:
                    continue
                ge = torch.randn((p, lf), generator=g,
                                 device=device).to(grid.cdt)
                gd = torch.randn((3, p, lf), generator=g,
                                 device=device).to(grid.cdt)
                got = hk.hashgrid_bwd(x, tables, spec, na, ge, gd)
                again = hk.hashgrid_bwd(x, tables, spec, na, ge, gd)
                want = hk.hashgrid_bwd_reference(x, tables, spec, na, ge, gd)
                torch.cuda.synchronize()
                tol = 1e-5 if dt == "float32" else 1e-2
                rel = max(((a - b).norm() / b.norm()).item()
                          for a, b in zip(got, want))
                check(math.isfinite(rel) and rel <= tol,
                      f"hashgrid_bwd {dt} n_active={na}: relative L2 error "
                      f"{rel:.3e} > {tol:g}")
                row["bwd_rel"] = rel
                row["bwd_err"] = max((a - b).abs().max().item()
                                     for a, b in zip(got, want))
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"hashgrid_bwd {dt} n_active={na}: two launches differ")
                row["bwd_ms"] = cuda_ms(
                    lambda: hk.hashgrid_bwd(x, tables, spec, na, ge, gd),
                    reps)
                row["bwd_device_ms"] = device_ms(
                    lambda: hk.hashgrid_bwd(x, tables, spec, na, ge, gd),
                    reps)
                row["bwd_plain_ms"] = cuda_ms(
                    lambda: hk.hashgrid_bwd_reference(x, tables, spec, na,
                                                      ge, gd), reps)
            report(f"[9] hash grid {dt} n_active={na}: hashgrid_fwd "
                   f"P={HG_POINTS[1][0]} max err {row['enc_err']:.3e}, "
                   f"kernel {row['enc_ms']:.3f} ms (device "
                   f"{row['enc_device_ms']:.3f}), plain "
                   f"{row['enc_plain_ms']:.3f} ms; with jacobian "
                   f"P={HG_POINTS[0][0]} max err {row['jac_err']:.3e}, kernel "
                   f"{row['jac_ms']:.3f} ms (device "
                   f"{row['jac_device_ms']:.3f}), plain "
                   f"{row['jac_plain_ms']:.3f} ms; hashgrid_bwd relative L2 "
                   f"{row['bwd_rel']:.2e} (max err {row['bwd_err']:.3e}, "
                   f"bit-identical across launches), kernel "
                   f"{row['bwd_ms']:.3f} ms (device {row['bwd_device_ms']:.3f}"
                   f"), plain {row['bwd_plain_ms']:.3f} ms; bounds "
                   + " / ".join(
                       "{:.4f} ms ({})".format(*bound_ms(*row[k + "_work"],
                                                         F32_FLOPS))
                       for k in ("enc", "jac", "bwd")))
            results.append(row)
    return results


def phase_row_gather(device, reps: int = 10):
    """The row-gather kernel (K3) against ``tab[idx]`` at the Pallas
    gathers' shapes: bit-equal, and the rate of each."""
    import torch

    from drawingspinup_torch.kernels import hashgrid as hk

    results = []
    for rows in GATHER_ROWS:
        g = torch.Generator(device=device).manual_seed(SEED + 300)
        tab = torch.randn((rows, 16), generator=g,
                          device=device).to(torch.bfloat16)
        idx = torch.randint(0, rows, (GATHER_K,), generator=g, device=device,
                            dtype=torch.int32)
        got = hk.row_gather(tab, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, tab[idx.long()]),
              f"row_gather differs from tab[idx] at T={rows}")
        ms = cuda_ms(lambda: hk.row_gather(tab, idx), reps)
        dev = device_ms(lambda: hk.row_gather(tab, idx), reps)
        plain = cuda_ms(lambda: hk.row_gather_reference(tab, idx), reps)
        library = cuda_ms(lambda: torch.index_select(tab, 0, idx), reps)
        # idx read, each row it names read once, the output written
        row_bytes = 16 * tab.element_size()
        nbytes = GATHER_K * (4 + row_bytes) + row_bytes * int(
            torch.unique(idx).numel())
        bound, _ = bound_ms(nbytes, 0, F32_FLOPS)
        report(f"[10] row_gather T={rows} (16 bf16 per row), K={GATHER_K}: "
               f"bit-equal to tab[idx]; kernel {ms:.4f} ms "
               f"({GATHER_K / ms / 1e3:.0f} M rows/s; device {dev:.4f} ms), "
               f"plain {plain:.4f} ms "
               f"({GATHER_K / plain / 1e3:.0f} M rows/s), index_select "
               f"{library:.4f} ms, bound {bound:.4f} ms (bytes)")
        results.append((ms, plain, library, nbytes, dev))
    return results


def phase_recon(root: str, device):
    """The recon CLI on a synthetic sphere uid (six 1024² views): every
    band phase, the exact kernel launches per step, the OBJ under the
    reference name; returns the launches of that run."""
    import torch

    from drawingspinup_torch.cli import recon
    from drawingspinup_torch.core.io import read_obj
    from drawingspinup_torch.kernels import hashgrid as hk
    from drawingspinup_torch.pipelines import stage2_recon
    from drawingspinup_torch.utils.synthetic import write_sphere_mv

    paths = write_sphere_mv(root, RECON_UID, size=RECON_SIZE)
    cfg = recon_config()
    steps = cfg.max_steps
    hk.FWD_LAUNCHES = hk.FWD_JAC_LAUNCHES = hk.BWD_LAUNCHES = 0
    hk.GATHER_LAUNCHES = 0
    t0 = time.time()
    recon.main(["--uid", RECON_UID, "--root", root, "--device", str(device),
                *RECON_OVERRIDES])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"hashgrid_fwd": hk.FWD_LAUNCHES + hk.FWD_JAC_LAUNCHES,
                "hashgrid_bwd": hk.BWD_LAUNCHES,
                "row_gather": hk.GATHER_LAUNCHES}
    stats = stage2_recon.LAST_STATS
    evals = stats["export"]["field_evals"]
    check(hk.FWD_JAC_LAUNCHES == steps and hk.BWD_LAUNCHES == steps
          and hk.FWD_LAUNCHES == steps + evals
          and hk.GATHER_LAUNCHES == steps,
          f"recon launches: encode {hk.FWD_LAUNCHES}, with jacobian "
          f"{hk.FWD_JAC_LAUNCHES}, table gradient {hk.BWD_LAUNCHES}, row "
          f"gather {hk.GATHER_LAUNCHES}; expected {steps} + {evals} export "
          f"evaluations, {steps}, {steps}, {steps}")
    log = stats["log"]
    check(all(math.isfinite(v) for row in log for v in row[1:]),
          f"non-finite recon log: {log}")
    check(log[-1][1] < log[0][1] and log[-1][3] > log[0][3],
          f"loss did not fall or inv_s did not rise: {log}")
    name = stage2_recon.export_name(steps, RECON_MC, RECON_FACES, True,
                                    True, False, True, True) + ".obj"
    obj = os.path.join(paths.mesh_dir, name)
    check(os.path.exists(obj), f"no {obj}")
    v, f, c = read_obj(obj)
    radius = float(np.median(np.linalg.norm(v, axis=1)))
    want = 0.45 * 0.5 * 1.35
    check(len(f) > 1000 and c is not None
          and abs(radius - want) / want < 0.35,
          f"{name}: {len(v)} vertices, {len(f)} faces, median radius "
          f"{radius:.4f} (sphere {want:.4f})")
    ex = stats["export"]
    report(f"[11] recon CLI, {steps} steps on six {RECON_SIZE}^2 views: "
           f"launches per step: 1 encode, 1 encode with jacobian, 1 table "
           f"gradient, 1 row gather (+{evals} export encodes); loss "
           f"{log[0][1]:.4f} (step {log[0][0]}) -> {log[-1][1]:.4f} (step "
           f"{log[-1][0]}), inv_s {log[0][3]:.1f} -> {log[-1][3]:.1f}; ms per"
           f" step (host synchronised, first step included) "
           + ", ".join(f"{k} levels {ms:.2f}"
                      for k, ms in stats["phase_ms"].items())
           + f"; export s: " + ", ".join(
              f"{k} {ex[k]:.2f}" for k in ("bbox", "band_eval", "smooth_pack",
                                          "march", "remesh", "save"))
           + f"; data+hull {stats['data_s']:.2f} s, checkpoint "
           f"{stats['ckpt_s']:.2f} s, CLI wall {wall:.1f} s; {name}: "
           f"{len(v)} vertices, {len(f)} faces, median radius {radius:.4f} "
           f"(sphere {want:.4f})")
    return launches


def trained_params(root: str, dtype, device):
    """The recon run's checkpoint, each leaf cast to ``dtype``, on
    ``device``, requiring grad."""
    from drawingspinup_torch.core import checkpoint as ckpt
    from drawingspinup_torch.core.contract import UidPaths

    steps = recon_config().max_steps
    saved = ckpt.restore(os.path.join(UidPaths(root, RECON_UID).mesh_dir,
                                      "ckpt", f"step_{steps}.pt"))

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v.to(device=device, dtype=dtype).requires_grad_(True)
    return conv(saved["params"])


def profile_nsr_step(run, steps: int = 5) -> None:
    """Where one NSR step's device time goes (torch.profiler), and the hash
    grid kernels' share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0) / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if total <= 0:
        report("[12] profile: the profiler saw no device time (not measured)")
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    hg = sum(e.self_device_time_total for e in kernels
             if "hashgrid" in e.key) / 1e3 / steps
    top = "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3 / steps:.3f} ms "
        f"x{e.count // steps}" for e in kernels[:8])
    launches = sum(e.count for e in kernels) / steps
    report(f"[12] profile of {steps} production steps (bf16, kernel path): "
           f"device busy {total:.2f} ms of {wall:.2f} ms wall per step "
           f"({total / wall:.1%}, the profiler's overhead included), "
           f"hash-grid kernels {hg:.3f} ms ({hg / total:.1%} of device time), "
           f"{launches:.0f} kernel launches per step; by kernel, per step: "
           f"{top}")


def phase_nsr_step_vs_plain(root: str, device) -> None:
    """One NSR step from the trained state and one set of draws, kernel path
    against plain path: in f32 against the plain path in float64, in bf16
    (production) against the plain path in f32; ms per step of each path,
    and a profile."""
    import torch

    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.pipelines import stage2_data
    from drawingspinup_torch.train import nsr

    base = recon_config()
    data32 = stage2_data.load_ortho_data(UidPaths(root, RECON_UID),
                                         im_size=RECON_SIZE, device=device)
    v, h, w = data32["masks"].shape
    draws32 = nsr.make_draws(base, v, h, w, torch.Generator(
        device=device).manual_seed(SEED + 400), device)
    step = base.max_steps - 1
    n_active = base.sdf.grid.current_level(step)

    def run(dt: str, plain: bool):
        tdt = getattr(torch, dt)
        wide = torch.float64 if dt == "float64" else torch.float32
        cfg = recon_config(table_dtype=dt, compute_dtype=dt)
        params = trained_params(root, wide, device)
        params["geometry"]["table"] = [
            t.detach().to(tdt).requires_grad_(True)
            for t in params["geometry"]["table"]]
        data = {k: x.to(wide) if x.is_floating_point() else x
                for k, x in data32.items()}
        draws = nsr.Draws(*(x.to(wide) if x.is_floating_point() else x
                            for x in draws32))
        state = nsr.TrainState(params, None, step)
        with plain_hashgrid() if plain else contextlib.nullcontext():
            logs = nsr.loss_and_grads(cfg, state, data, draws, n_active)
        return ({k: x.item() for k, x in logs.items()},
                {n: p.grad.double() for n, p in nsr.named_leaves(params)
                 if p.grad is not None})

    def distance(got, want):
        """(relative error of each loss, relative L2 error of each
        gradient leaf) of ``got`` against ``want``."""
        (lg, gg), (lw, gw) = got, want
        check(sorted(gg) == sorted(gw), "gradient leaves differ")
        for n in gw:
            check(gw[n].norm() > 0 or not gg[n].norm(),
                  f"{n}: nonzero gradient where the reference has none")
        return ({k: abs(lg[k] - lw[k]) / max(abs(lw[k]), 1e-30)
                 for k in lw if k != "num_samples"},
                {n: ((gg[n] - gw[n]).norm() / gw[n].norm()).item()
                 for n in gw if gw[n].norm() > 0})

    def within(dist, loss_tol, grad_tol, what):
        losses, grads = dist
        worst = max(losses.values())
        check(worst <= loss_tol, f"{what}: losses within {worst:.2e} "
                                 f"relative > {loss_tol:g}: {losses}")
        worst = max(grads.values())
        check(math.isfinite(worst) and worst <= grad_tol,
              f"{what}: gradient relative L2 error {worst:.3e} > "
              f"{grad_tol:g} ({top(grads)})")

    def top(errs, k: int = 3) -> str:
        return ", ".join(f"{n} {e:.2e}" for n, e in sorted(
            errs.items(), key=lambda kv: -kv[1])[:k])

    ref64 = run("float64", True)
    f32_k = distance(run("float32", False), ref64)
    f32_p = distance(run("float32", True), ref64)
    within(f32_k, 1e-4, GRAD_REL_TOL, "f32 kernel path vs float64")
    within(f32_p, 1e-4, GRAD_REL_TOL, "f32 plain path vs float64")
    ref32 = run("float32", True)
    bf_k, bf_p = run("bfloat16", False), run("bfloat16", True)
    again = run("bfloat16", False)
    check(bf_k[0] == again[0] and all(torch.equal(bf_k[1][n], again[1][n])
                                      for n in bf_k[1]),
          "the kernel path's NSR step is not bit-identical across runs")
    # the kernels against the twins in the working dtype: K1 rounds as the
    # twin does; K2 sums in another order before the one cast to bf16
    bf_same = distance(bf_k, bf_p)
    within(bf_same, 1e-5, 1e-2, "bf16 kernel path vs bf16 plain path")
    # against the f32 plain path: bf16 compute alone moves the losses ~1e-2
    # and the gradients 10-40 % from f32 in either path (a table's gradient
    # sums contributions that cancel; the MLP's backward runs in bf16), so
    # each loss and leaf of the kernel path is held to no farther from f32
    # than 1.25 x the bf16 plain path's distance
    bf_k32, bf_p32 = distance(bf_k, ref32), distance(bf_p, ref32)
    for kind, errs, plain_errs, slack in (
            ("loss", bf_k32[0], bf_p32[0], 1e-5),
            ("gradient", bf_k32[1], bf_p32[1], 1e-3)):
        for n, e in errs.items():
            check(e <= 1.25 * plain_errs[n] + slack,
                  f"bf16 {kind} {n}: kernel path {e:.3e} from f32, plain "
                  f"path {plain_errs[n]:.3e}")

    ms = {}
    cfg = recon_config()
    for plain in (False, True):
        params = trained_params(root, torch.float32, device)
        params["geometry"]["table"] = [
            t.detach().to(cfg.sdf.grid.tdt).requires_grad_(True)
            for t in params["geometry"]["table"]]
        opt = nsr.make_optimizer(cfg)
        state = nsr.TrainState(params, opt.init(params), step)
        with plain_hashgrid() if plain else contextlib.nullcontext():
            ms[plain] = cuda_ms(lambda: nsr.train_step(
                cfg, opt, state, data32, draws32, n_active), reps=10)
    tables = {n: e for n, e in bf_k32[1].items() if "table" in n}
    others = {n: e for n, e in bf_k32[1].items() if "table" not in n}
    report(f"[12] one NSR step at step {step} ({n_active} levels) of the "
           f"trained state: f32 kernel path vs float64 plain path: losses "
           f"within {max(f32_k[0].values()):.2e} relative, worst gradients "
           f"{top(f32_k[1])} (f32 plain path: losses "
           f"{max(f32_p[0].values()):.2e}, gradients {top(f32_p[1])}); bf16 "
           f"kernel path vs bf16 plain path: losses "
           f"{max(bf_same[0].values()):.2e}, gradients {top(bf_same[1])}, "
           f"bit-identical across runs; "
           f"bf16 kernel path vs f32 plain path: total loss "
           f"{bf_k32[0]['loss']:.2e} (worst term {top(bf_k32[0], 1)}), "
           f"gradients: MLP and variance {top(others)}, tables "
           f"{top(tables, 6)} (bf16 plain path: total loss "
           f"{bf_p32[0]['loss']:.2e}, MLP and variance "
           f"{top({n: bf_p32[1][n] for n in others})}, tables "
           f"{top({n: bf_p32[1][n] for n in tables}, 6)}); median ms per "
           f"production step (bf16, CUDA events): kernel {ms[False]:.2f}, "
           f"plain {ms[True]:.2f}")
    params = trained_params(root, torch.float32, device)
    params["geometry"]["table"] = [
        t.detach().to(cfg.sdf.grid.tdt).requires_grad_(True)
        for t in params["geometry"]["table"]]
    opt = nsr.make_optimizer(cfg)
    state = nsr.TrainState(params, opt.init(params), step)
    profile_nsr_step(lambda: nsr.train_step(cfg, opt, state, data32, draws32,
                                            n_active))


def phase_export_vs_plain(root: str, device) -> None:
    """The export's u8 field at mc512 from the trained params, kernel field
    against plain field over one extent; the marched meshes' sizes."""
    import torch

    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.pipelines import stage2_data, stage2_export
    from drawingspinup_torch.render.marching import marching_tetrahedra

    cfg = recon_config()
    params = trained_params(root, torch.float32, device)
    params["geometry"]["table"] = [
        t.detach().to(cfg.sdf.grid.tdt) for t in params["geometry"]["table"]]
    front = stage2_data.load_front_mask(UidPaths(root, RECON_UID))
    fields, meshes, secs = [], [], []
    vmin = vmax = None
    for plain in (False, True):
        with plain_hashgrid() if plain else contextlib.nullcontext():
            ev = stage2_export.FieldEvaluator(cfg, params, cfg.max_steps,
                                              device)
            if vmin is None:
                vmin, vmax = stage2_export.bbox_pass(ev, RECON_MC,
                                                     cfg.radius)
            torch.cuda.synchronize()
            t0 = time.time()
            u8 = stage2_export.smoothed_field(ev, vmin, vmax, RECON_MC,
                                              front)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
        fields.append(u8)
        meshes.append(marching_tetrahedra(u8.cpu().numpy(), 0.5))
    diff = (fields[0].int() - fields[1].int()).abs()
    frac = (diff > 1).float().mean().item()
    check(frac < 5e-3, f"export u8 fields differ by more than 1 on {frac:.3%}"
                       f" of voxels")
    (vk, fk), (vp, fp) = meshes
    check(abs(len(vk) - len(vp)) <= 0.1 * len(vp)
          and abs(len(fk) - len(fp)) <= 0.1 * len(fp),
          f"marched meshes differ: {len(vk)}/{len(fk)} vs {len(vp)}/{len(fp)}")
    report(f"[13] export at mc{RECON_MC}, kernel field vs plain field: u8 "
           f"values "
           f"differ by more than 1 on {frac:.4%} of voxels (max diff "
           f"{diff.max().item()}); marched {len(vk)} vertices / {len(fk)} "
           f"faces vs {len(vp)} / {len(fp)}; band eval + smooth "
           f"{secs[0]:.2f} s (kernel) vs {secs[1]:.2f} s (plain)")


def kernels_line(per_shape, serving_launches, train_shapes, fwd_launches,
                 bwd_launches, hg_rows, gather, recon_launches) -> dict:
    """The ``kernels`` JSON object from the phases' results: per kernel its
    launches on the main paths, error, times, bound and yardstick."""
    prod = next(r for r in hg_rows
                if r["dtype"] == "bfloat16" and r["n_active"] == HG_ACTIVE[-1])

    def step_sum(key: str, count: int) -> float:
        return sum(s[count] * r[key] for s, r in zip(TRAIN_SHAPES,
                                                     train_shapes))

    def bound(works):
        """Σ count · bound of each call of (count, bytes, FLOPs, peak), and
        which of the two limits sets the most of it."""
        ms = sum(n * bound_ms(b, f, p)[0] for n, b, f, p in works)
        t_bytes = sum(n * b / HBM_BYTES_PER_S for n, b, _, _ in works)
        t_ops = sum(n * f / p for n, _, f, p in works)
        return ms, "bytes" if t_bytes >= t_ops else "operations"

    def ric_bound(works):
        """(bound at 3xTF32, what sets it, bound at f32 outside the tensor
        cores) of (count, bytes, f32 FLOPs) RIC calls."""
        return (*bound([(n, b, 3 * f, TF32_FLOPS) for n, b, f in works]),
                bound([(n, b, f, F32_FLOPS) for n, b, f in works])[0])

    fwd_bound = ric_bound([(s[3], *ric_fwd_work(1, s[0], s[1], s[2]))
                           for s in RIC_SHAPES])

    def frame_sum(key: str) -> float:
        return sum(s[3] * r[key] for s, r in zip(RIC_SHAPES, per_shape))

    bwd_bound = ric_bound([(s[4], *ric_bwd_work(BATCH, s[0], s[1], s[2],
                                                k > 0))
                           for k, s in enumerate(TRAIN_SHAPES)])
    hg_bound = bound([(1, *prod[k + "_work"], F32_FLOPS)
                      for k in ("enc", "jac")])
    hg_bwd_bound = bound([(1, *prod["bwd_work"], F32_FLOPS)])
    gather_bound = bound([(1, gather[-1][3], 0, F32_FLOPS)])
    return {"kernels": [{
        "name": "ric_conv_fwd", "route": "cuda", "source": RIC_SOURCE,
        "replaces": RIC_REPLACES, "launches": fwd_launches,
        "max_abs_err": max(max(r["err"] for r in per_shape),
                           max(r["fwd_err"] for r in train_shapes)),
        "ms": frame_sum("ms"), "plain_ms": frame_sum("plain_ms"),
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        "library_ms": frame_sum("library_ms"),
        "timed": f"sum over the {RIC_PER_FRAME} RIC convs of one "
                 f"{FRAME}^2 GeneratorJ_RIC forward (phase 3 medians); "
                 f"{TIMED}; library_ms: torch.matmul in f32 of U (pixels x "
                 f"9C, the sampled input, built before timing) and wk "
                 f"(9C x O)",
        "device_ms": frame_sum("device_ms"),
        "library_device_ms": frame_sum("library_device_ms"),
        "bound_f32_ms": fwd_bound[2],
        "f64_rel_l2": max(max(r["f64_rel_l2"] for r in per_shape),
                          max(r["fwd_f64_rel_l2"] for r in train_shapes)),
        "plain_tf32_f64_rel_l2": min(
            min(r["tf32_rel_l2"] for r in per_shape),
            min(r["fwd_tf32_rel_l2"] for r in train_shapes)),
        "launches_serving_path": serving_launches,
        "ms_train_step": step_sum("fwd_ms", 3),
        "device_ms_train_step": step_sum("fwd_device_ms", 3),
        "plain_ms_train_step": step_sum("fwd_plain_ms", 3),
        "bound_ms_train_step": step_sum("fwd_bound_ms", 3),
        "bound_f32_ms_train_step": step_sum("fwd_bound_f32_ms", 3),
        "library_ms_train_step": step_sum("fwd_library_ms", 3),
        "library_device_ms_train_step": step_sum("fwd_library_device_ms", 3),
    }, {
        "name": "ric_conv_bwd", "route": "cuda", "source": BWD_SOURCE,
        "replaces": BWD_REPLACES, "launches": bwd_launches,
        "max_abs_err": max(r["err"] for r in train_shapes),
        "ms": step_sum("ms", 4), "plain_ms": step_sum("plain_ms", 4),
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        "library_ms": step_sum("library_ms", 4),
        "timed": f"sum over the {BWD_PER_STEP} RIC backward launches of one "
                 f"training step, N={BATCH} (phase 6 medians); {TIMED}; "
                 f"library_ms: torch.matmul in f32 of the same two products "
                 f"on the same dz",
        "device_ms": step_sum("device_ms", 4),
        "device_ms_dz": step_sum("dz_device_ms", 4),
        "device_ms_dx": step_sum("dx_device_ms", 4),
        "device_ms_dwk": step_sum("dwk_device_ms", 4),
        "library_device_ms": step_sum("library_device_ms", 4),
        "bound_f32_ms": bwd_bound[2],
        "f64_rel_l2": max(r["f64_rel_l2"] for r in train_shapes),
        "plain_tf32_f64_rel_l2": min(r["tf32_rel_l2"] for r in train_shapes),
    }, {
        "name": "hashgrid_fwd", "route": "cuda", "source": HG_SOURCE,
        "replaces": HG_REPLACES, "launches": recon_launches["hashgrid_fwd"],
        "max_abs_err": max(max(r["enc_err"], r["jac_err"]) for r in hg_rows),
        "ms": prod["enc_ms"] + prod["jac_ms"],
        "plain_ms": prod["enc_plain_ms"] + prod["jac_plain_ms"],
        "bound_ms": hg_bound[0], "bound_by": hg_bound[1], "library_ms": None,
        "timed": f"one production step's two encodes at 6 levels, bf16: "
                 f"{HG_POINTS[1][0]} points, and {HG_POINTS[0][0]} with the "
                 f"jacobian (phase 9 medians); {TIMED}",
        "device_ms": prod["enc_device_ms"] + prod["jac_device_ms"],
    }, {
        "name": "hashgrid_bwd", "route": "cuda", "source": HG_BWD_SOURCE,
        "replaces": HG_BWD_REPLACES,
        "launches": recon_launches["hashgrid_bwd"],
        "max_abs_err": max(r["bwd_err"] for r in hg_rows),
        "ms": prod["bwd_ms"], "plain_ms": prod["bwd_plain_ms"],
        "bound_ms": hg_bwd_bound[0], "bound_by": hg_bwd_bound[1],
        "library_ms": None,
        "timed": f"one production step's table gradient at 6 levels, bf16, "
                 f"{HG_POINTS[0][0]} points (phase 9 medians); {TIMED}",
        "device_ms": prod["bwd_device_ms"],
    }, {
        "name": "row_gather", "route": "cuda", "source": GATHER_SOURCE,
        "replaces": GATHER_REPLACES, "launches": recon_launches["row_gather"],
        "max_abs_err": 0.0, "ms": gather[-1][0], "plain_ms": gather[-1][1],
        "bound_ms": gather_bound[0], "bound_by": gather_bound[1],
        "library_ms": gather[-1][2],
        "timed": f"{GATHER_K} rows of a ({GATHER_ROWS[-1]}, 16) bf16 table "
                 f"(phase 10 medians; T={GATHER_ROWS[0]}: {gather[0][0]:.4f} "
                 f"ms, plain {gather[0][1]:.4f} ms); library_ms: "
                 f"torch.index_select; {TIMED}",
        "device_ms": gather[-1][4],
    }]}


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
        hg_rows = phase_hashgrid_vs_plain(device)
        gather = phase_row_gather(device)
        recon_launches = phase_recon(root, device)
        phase_nsr_step_vs_plain(root, device)
        phase_export_vs_plain(root, device)

    print(json.dumps(kernels_line(
        per_shape, serving_launches, train_shapes, fwd_launches, bwd_launches,
        hg_rows, gather, recon_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

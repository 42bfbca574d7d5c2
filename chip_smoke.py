#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``drawingspinup_torch``) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels and the native mesh library from the
checkout's sources and drives stage 3 at the production width
(configs/config_stage{1,2}.yaml), with weights drawn from a seed, on 512²
frames that the port's run_render CLI renders from a synthetic two-bone
rig: the serving path (run_render → test_stage1 → test_stage2 → GIF), then
the training path (run_render → train_stage1 → test_stage1 → train_stage2
→ test_stage2 → GIF) on batches of 40 × 32² patches. Then stage 2b at the
production width of configs/neus-ortho.yaml, trained from a seed: the
recon CLI on six 1024² views of a synthetic sphere, 600 steps, export at
mc512. Then the stage-3 renders of a rig of production size, stage 1
(the predict CLI, LaMa's FFC ResNet at the full width of
configs/lama-fourier.yaml, seeded weights) on eight 512² drawings, and
stage 2a (the mv CLI, the Wonder3D MV-UNet, SD VAE and CLIP ViT-L/14 at
full width, seeded weights, 75 DDIM steps, and the ISNet matte) on one of
stage 1's outputs, and last the batch sweep drawing → GIF over two uids.
Phases:

  1. versions, and the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (RIC conv forward and backward, hash-grid encode
     and table gradient, row gather, pixel rays) and the native library,
     with the build times;
  3. forward kernel (3xTF32 implicit GEMM) against its plain PyTorch twin
     at the 8 RIC layer shapes of a 512² GeneratorJ_RIC forward: max
     |kernel − plain| ≤ 1e-4 · max |plain|, within relative L2 1e-5 of the
     twin run in float64, a limit that the same product on TF32-rounded
     operands (plain TF32) misses, a second launch bit-identical; the
     median CUDA-event time of each, the bound and the share of it reached,
     and the yardstick: torch.matmul in f32 of U · Wk, with U the sampled
     input (``ric_conv_sample_reference``) built outside the timed region
     (timed here only; the port never calls it);
  4. the serving path through the port's CLIs on a rigged uid whose 2
     actions × 4 frames run_render renders on the card: exactly 21 kernel
     launches per GeneratorJ_RIC frame, every frame and GIF written, ms per
     frame of each stage;
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
  7. the training path through the port's CLIs on a second rigged uid
     (the same actions and the rest_pose keyframe, rendered by run_render
     on the card, and the character drawings):
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
     (65 536 points), n_active 4, 5 and 6, in bf16 and f32, first on
     uniform points and, once phase 11 has trained the uid, on the points
     of one of its NSR steps in the step's own ray order: K1 within
     1e-5 · max |plain| (f32) or one bf16 ulp of the largest output, its
     inactive columns zero; K2 within relative L2 1e-5 (f32) or 1e-2 (bf16)
     of the twin's f32 sums and 1e-6 of the same terms summed in float64,
     bit-equal to its PyTorch emulation (hashgrid_bwd_fixed_point) in f32
     and in the tables' dtype, bit-identical from launch to launch and
     under a permutation of the points, NaN where the twin is not finite;
     the median CUDA-event time of each, K2 as the step's backward calls
     it (the gradients in the tables' dtype), and a partial
     yardstick: the scatter alone as index_put_(accumulate=True) of K2's
     terms with deterministic algorithms on;
 10. the row-gather kernel (K3) against tab[idx], bit-equal, at the Pallas
     gathers' shapes (T = 74³ and 129³ rows of 16 bf16, K = 262 144) and at
     the recon step's (2048 rows of 12 f32 from a 6 × 1024² table), with the
     bound of each; then the fused pixel-ray kernel (K4), which builds one
     NSR step's 2048 rays and fetches their target rows in one launch,
     against its plain twin at that shape: target rows and view weights
     bit-equal, rays within 2 f32 ulp of their terms' magnitude, a second
     launch bit-identical; its times beside the twin's, the unfused build's
     (eager ops around K3) and index_select's of the rows alone;
 11. the recon CLI (``python -m drawingspinup_torch.cli.recon``) on a
     synthetic sphere uid with the cuts trainer.max_steps=600,
     system.constant_steps=100, update_steps=200 (4 → 5 → 6 levels): per
     step exactly one K1 without the jacobian (coarse pass), one with, one
     K2 and one K4 (the rays and pixel targets) and no K3, plus one K1 per
     export evaluation;
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
     of each path and of the kernel path with the unfused pixel build, and
     a profile of each of the last two: device busy and launches per step;
 13. the export's u8 field at mc512 from the trained params, kernel field
     against plain field: more than 1 apart on < 0.5 % of voxels, marched
     vertex and face counts within 10 %; then the export at mc256 by each
     chain JAX can take there (device-smooth; the level chain, as
     DSU_DEVICE_SMOOTH=0 runs it, band-sparse; the level chain's dense grid,
     which every R < 256 runs): each a non-empty mesh of the sphere's median
     radius within 35 %, with its device and host seconds;
 14. the renders: run_render on a rig of 50 000 faces (the recon OBJ's
     f50000) animated over 2 s, 61 frames of 760², on the card and with
     --device cpu: equal frame counts and sizes, color and pos u8 more
     than 1 apart on < 0.5 % of values, alpha and edge differing on
     < 0.5 % of pixels; seconds per frame split into skinning (device),
     rasterization (host), shading, edges and PNG writes;
 15. stage 1: the predict CLI on 8 drawings of 512² at the full width of
     lama-fourier.yaml, seeded weights (the head rescaled so that the
     logits straddle the contour threshold) loaded from a torch
     checkpoint: every ffc_resnet_inpainted.png written with the input's
     alpha; the generator's logits on the card in f32 within relative L2
     1e-4 of the same weights in float64 on the CPU (the CPU f32 run's
     distance beside), the thresholded contour masks differing on < 0.1 %
     of pixels; ms per drawing at batch 1 and 8 (CUDA events), cuFFT's
     share of the device time (torch.profiler), threshold + Telea host
     seconds per drawing and the CLI's wall seconds per uid;
 16. stage 2a: the mv CLI at full width (UNet 320/640/1280/1280 with joint
     mid attention, SD VAE, CLIP ViT-L/14; 256² input, 12 images of 32²
     latents, 75 DDIM steps in bf16, eta 1, 1024² output), seeded weights,
     on phase 15's first uid: 18 PNGs of 1024², the decoded images finite;
     one UNet call (batch 12, that uid's conditioning, the joint
     attentions' projections drawn nonzero) in f32 within relative L2 1e-4
     of the same call in float64 on the card, the bf16 call's distance
     beside; the denoise loop run twice from one generator state
     bit-identical (6 steps); ms per UNet call at batch 12 in bf16 and f32
     (CUDA events) with its TFLOP/s (FLOPs counted from the shapes), the
     CLI's seconds by part (read, encode, 75-step loop, decode + upscale
     + u8, masks, PNG writes) and wall, steady encode and decode times, and
     device busy and launches over one denoise step (torch.profiler); then
     ISNet DIS at full width (seeded weights written as a state_dict and
     loaded through DSU_ISNET_CKPT, as the mv pipeline loads them) on the
     uid's four side views of 1024^2: f32 within relative L2 1e-4 of
     float64 on the card, the u8 masks differing from float64's on < 0.1 %
     of pixels, ms per view. Phases 14-16 launch none of the hand-written
     kernels;
 17. the sweep: two uids made from phase 15's drawings (the mv contract
     filled by the sphere fixture, since seeded Wonder3D weights give no
     usable views; a rig per uid; the second uid on the thinning list)
     through pipelines/sweep.py's run_sweep with cli/sweep.py's stage
     functions, stage1 → recon → render → train_style → test_style → gif,
     at the production widths with phase 11's recon cut (600 steps) and
     phases 4 and 7's --max-batches (100, 20): both uids done and no
     failure, the log stage-major, every stage's outputs present, the
     thinning uid's OBJ under the reference's thinning name, each kernel's
     launches over the sweep as the stages' counts predict (the kernels
     line's ``launches_sweep``), a resumed sweep running no stage; the
     seconds per stage per uid.

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
import io
import json
import math
import os
import re
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
# phases 4 and 7: a rig that fits a 512^2 frame (height < the 1.35 ortho
# scale), its 4 frames 0.1 s of animation at 30 fps
STAGE3_RIG = dict(n_seg=64, duration=0.1, height=1.2, half=0.2)
# phase 14: the production-size rig, a bar of 50 000 faces (the recon OBJ's
# f50000), 2 s of animation: 61 frames of 760^2 (the bar outgrows the
# 1.35 ortho scale, so the frame grows past 512)
RENDER_UID = "smoke_render"
RENDER_RIG = dict(n_seg=6250, duration=2.0)
RENDER_FRAMES = 61
RENDER_SHARE = 5e-3     # card vs CPU: values off by > 1, alpha, edge pixels
# phase 15: stage 1 at the full width of configs/lama-fourier.yaml
LAMA_YAML = "drawingspinup_torch/configs/lama-fourier.yaml"
DRAWINGS = 8
DRAWING_SIZE = 512
LOGIT_REL_L2 = 1e-4     # card f32 vs CPU float64
MASK_SHARE = 1e-3       # thresholded contour masks, card vs float64
# phase 16: stage 2a at full width on phase 15's first drawing
MV_UID = "drawing0"
MV_SEED = SEED + 500
MV_REL_L2 = 1e-4        # the f32 UNet call vs float64 (stage 1's bound)
MV_SAME_STEPS = 6       # the bit-identity check's denoise loop
MV_OUT = 1024
ISNET_REL_L2 = 1e-4     # phase 16: ISNet f32 vs float64 (stage 1's bound)
# phase 13: the export chains at mc256 (JAX's dispatch: device-smooth, or
# the level chain under DSU_DEVICE_SMOOTH=0, band-sparse at R >= 256)
CHAIN_MC = 256
SPHERE_RADIUS = 0.45        # utils/synthetic.py::write_sphere_mv's
# phase 17: the sweep (cli/sweep.py's stage functions) over two uids made
# from phase 15's drawings, one of them on the thinning list
SWEEP_UIDS = ("sweep0", "sweep1")
SWEEP_DRAWINGS = ("drawing1", "drawing2")
SWEEP_STAGES = ("stage1", "recon", "render", "train_style", "test_style",
                "gif")
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
PIXEL_SOURCE = "drawingspinup_torch/kernels/csrc/pixel_rays.cu"
PIXEL_REPLACES = GATHER_REPLACES    # the rowdma gather, at the recon step
RAY_ULPS = 2            # phase 10: rays vs the twin, ulps of their terms
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
           f"hash-grid encode and table gradient, row gather, pixel rays) "
           f"in {t1 - t0:.1f} s into {_build.BUILD_DIR}, the native mesh "
           f"library "
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


def render_uid(root: str, uid: str, device, training: bool = False):
    """A rigged uid (``utils/synthetic.py::write_rig_uid``: a bar of
    ``STAGE3_RIG["n_seg"]`` segments bending at mid-height, one animated FBX
    per action) rendered by the port's ``run_render`` CLI on ``device``:
    the actions' ``color``, ``pos`` and ``edge`` passes (test mode) and,
    for ``training``, the ``rest_pose`` keyframe (train mode) and the two
    character drawings under ``char/``."""
    from PIL import Image

    from drawingspinup_torch.cli import run_render
    from drawingspinup_torch.core.io import write_image
    from drawingspinup_torch.utils.synthetic import write_rig_uid

    paths = write_rig_uid(root, uid, actions=ACTIONS, **STAGE3_RIG)
    args = ["--uid", uid, "--data_dir", root, "--device", str(device)]
    with contextlib.redirect_stdout(sys.stderr):
        run_render.main(args + ["--test"])
        if training:
            run_render.main(args)
    for action in ACTIONS + (("rest_pose",) if training else ()):
        want = FRAMES_PER_ACTION if action in ACTIONS else 1
        for name in ("color", "pos", "edge"):
            d = os.path.join(paths.action_dir(action), name)
            pngs = sorted(os.listdir(d))
            check(len(pngs) == want, f"run_render wrote {len(pngs)} frames "
                                     f"in {d}, expected {want}")
            with Image.open(os.path.join(d, pngs[0])) as im:
                check(im.size == (FRAME, FRAME),
                      f"run_render frame {im.size}, expected {FRAME}^2")
    if training:
        # the drawings: a disc in flat, banded colours on white
        yy, xx = np.mgrid[0:FRAME, 0:FRAME]
        ref = np.asarray(np.hypot(yy - FRAME / 2, xx - FRAME / 2)
                         < FRAME * 0.3)
        bands = (np.floor(yy / (FRAME / 8)) % 2)[..., None]
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
    paths = render_uid(root, uid, device)
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

    paths = render_uid(root, TRAIN_UID, device, training=True)
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
    """Route the hash-grid encode, its table gradient, the row gather and
    the pixel rays through their plain twins, on CUDA tensors as on the
    CPU."""
    import torch

    from drawingspinup_torch.kernels import hashgrid as hk
    from drawingspinup_torch.kernels import pixel_rays as pr

    saved = hk.hashgrid_fwd, hk.hashgrid_bwd, hk.row_gather, pr.pixel_rays
    reference = hk.hashgrid_bwd_reference

    def plain_bwd(*args, out_dtype=torch.float32):
        return [g.to(out_dtype) for g in reference(*args)]

    hk.hashgrid_fwd = hk.hashgrid_fwd_reference
    hk.hashgrid_bwd = plain_bwd
    hk.row_gather = hk.row_gather_reference
    pr.pixel_rays = pr.pixel_rays_reference
    try:
        yield
    finally:
        hk.hashgrid_fwd, hk.hashgrid_bwd, hk.row_gather, pr.pixel_rays = \
            saved


@contextlib.contextmanager
def unfused_pixels():
    """Build the recon step's rays and targets as the step built them before
    the fused kernel: the twin's eager ops around the row-gather kernel."""
    from drawingspinup_torch.kernels import hashgrid as hk
    from drawingspinup_torch.kernels import pixel_rays as pr

    saved = pr.pixel_rays, pr.fetch_rows
    pr.pixel_rays, pr.fetch_rows = pr.pixel_rays_reference, hk.row_gather
    try:
        yield
    finally:
        pr.pixel_rays, pr.fetch_rows = saved


def ulp_bf16(x) -> float:
    """One bf16 ulp of the largest |x|."""
    m = x.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def hashgrid_work(x, tables, spec, n_active: int, with_jac: bool):
    """(bytes, FLOPs) of one encode and of one table gradient at the points
    x: the encode reads x and the table rows the points' corners touch and
    writes enc (and denc); the gradient reads x, g_enc and g_denc's active
    columns and writes the active tables' gradients in the tables' dtype,
    as the step's backward asks for them. Per (point, level,
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
    grads = sum(tables[lvl].shape[0] for lvl in range(n_active)) * nf * ts
    bwd = (12 * p + outs * p * n_active * nf * cs + grads,
           p * n_active * 8 * (8 + 8 * nf))
    return fwd, bwd


def uniform_points(device):
    """Phase 9's first point sets: uniform in the unit cube, per HG_POINTS
    entry."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 201)
    return {jac: torch.rand((p, 3), generator=g, device=device)
            for p, jac in HG_POINTS}


def step_points(root: str, device):
    """The points that one NSR step of the trained uid hands the encode, in
    the step's own order (train/nsr.py::render_rays): the coarse pass's
    2048 rays x 32 samples, and the full eval's 2048 rays x 64 sorted
    samples followed by 2 x 2048 probes (with the jacobian)."""
    import torch

    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.kernels import hashgrid as hk
    from drawingspinup_torch.pipelines import stage2_data
    from drawingspinup_torch.train import nsr

    cfg = recon_config()
    data = stage2_data.load_ortho_data(UidPaths(root, RECON_UID),
                                       im_size=RECON_SIZE, device=device)
    v, h, w = data["masks"].shape
    draws = nsr.make_draws(cfg, v, h, w, torch.Generator(
        device=device).manual_seed(SEED + 400), device)
    params = trained_params(root, torch.float32, device)
    params["geometry"]["table"] = [
        t.detach().to(cfg.sdf.grid.tdt).requires_grad_(True)
        for t in params["geometry"]["table"]]
    step = cfg.max_steps - 1
    seen = {}
    kernel = hk.hashgrid_fwd

    def record(x, tables, spec, n_active, with_jac):
        seen[with_jac] = x.clone()
        return kernel(x, tables, spec, n_active, with_jac)

    hk.hashgrid_fwd = record
    try:
        nsr.loss_and_grads(cfg, nsr.TrainState(params, None, step), data,
                           draws, cfg.sdf.grid.current_level(step))
    finally:
        hk.hashgrid_fwd = kernel
    for p, jac in HG_POINTS:
        check(jac in seen and tuple(seen[jac].shape) == (p, 3),
              f"the NSR step's encode {'with' if jac else 'without'} the "
              f"jacobian saw {seen.get(jac, torch.empty(0)).shape}, not "
              f"({p}, 3)")
    return seen


def hashgrid_terms(x, spec, n_active: int, g_enc, g_denc):
    """K2's f32 terms of all active levels, (K, F), and their rows in one
    flat buffer of all levels, (K,) int64: the scatter alone."""
    import torch

    from drawingspinup_torch.kernels import hashgrid as hk

    idx, terms, base = [], [], 0
    for lvl in range(n_active):
        i, c = hk._level_terms(x, spec, lvl, g_enc, g_denc, torch.float32)
        idx.append(i.reshape(-1) + base)
        terms.append(c.reshape(-1, spec.n_features))
        base += (spec.res[lvl] + 1) ** 3 if spec.dense[lvl] \
            else spec.table_size
    return torch.cat(idx), torch.cat(terms), base


def check_table_gradient(x, tables, spec, na: int, ge, gd, where: str):
    """K2 against its twin (relative L2 1e-5 / 1e-2), the float64 sum of
    the same terms (1e-6), its own PyTorch emulation (bit-equal), a second
    launch and a permutation of the points (bit-identical), each with f32
    gradients and with the tables' dtype, and non-finite
    cotangents (NaN where the twin is not finite); returns (relative L2 to
    the twin, to float64, max |kernel - twin|)."""
    import torch

    from drawingspinup_torch.kernels import hashgrid as hk

    got = hk.hashgrid_bwd(x, tables, spec, na, ge, gd)
    want = hk.hashgrid_bwd_reference(x, tables, spec, na, ge, gd)
    perm = torch.randperm(x.shape[0], device=x.device,
                          generator=torch.Generator(
                              device=x.device).manual_seed(SEED + 202))
    for out in sorted({torch.float32, tables[0].dtype}, key=str):
        # f32, and the tables' dtype as the step's backward asks for it
        first = hk.hashgrid_bwd(x, tables, spec, na, ge, gd, out_dtype=out)
        again = hk.hashgrid_bwd(x, tables, spec, na, ge, gd, out_dtype=out)
        emulated = hk.hashgrid_bwd_fixed_point(x, tables, spec, na, ge, gd,
                                               out_dtype=out)
        shuffled = hk.hashgrid_bwd(x[perm].contiguous(), tables, spec, na,
                                   ge[perm].contiguous(),
                                   gd[:, perm].contiguous(), out_dtype=out)
        torch.cuda.synchronize()
        check(all(a.dtype == out and torch.equal(a, b)
                  for a, b in zip(first, emulated)),
              f"hashgrid_bwd {where}, {out} out: differs from "
              f"hashgrid_bwd_fixed_point")
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"hashgrid_bwd {where}, {out} out: two launches differ")
        check(all(torch.equal(a, b) for a, b in zip(first, shuffled)),
              f"hashgrid_bwd {where}, {out} out: a permutation of the points "
              f"changes it")
    idx, terms, rows = hashgrid_terms(x, spec, na, ge, gd)
    exact = torch.zeros((rows, spec.n_features), dtype=torch.float64,
                        device=x.device).index_add_(0, idx, terms.double())
    exact = torch.split(exact, [g.shape[0] for g in got])
    torch.cuda.synchronize()
    tol = 1e-5 if spec.cdt == torch.float32 else 1e-2
    rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(got, want))
    check(math.isfinite(rel) and rel <= tol,
          f"hashgrid_bwd {where}: relative L2 error {rel:.3e} > {tol:g}")
    f64 = max(((a.double() - b).norm() / b.norm()).item()
              for a, b in zip(got, exact))
    check(math.isfinite(f64) and f64 <= 1e-6,
          f"hashgrid_bwd {where}: relative L2 error {f64:.3e} against the "
          f"float64 sum > 1e-6")
    nf = spec.n_features
    ge_bad, gd_bad = ge.clone(), gd.clone()
    ge_bad[7, 0] = math.nan
    gd_bad[1, 11, (na - 1) * nf + 1] = math.inf
    bad = hk.hashgrid_bwd(x, tables, spec, na, ge_bad, gd_bad)
    twin = hk.hashgrid_bwd_reference(x, tables, spec, na, ge_bad, gd_bad)
    torch.cuda.synchronize()
    for lvl, (a, b) in enumerate(zip(bad, twin)):
        nonfinite = ~torch.isfinite(b)
        check(bool(nonfinite.any()) == (lvl in (0, na - 1))
              and bool(torch.isnan(a[nonfinite]).all())
              and bool(torch.isfinite(a[~nonfinite]).all()),
              f"hashgrid_bwd {where}: level {lvl} is not NaN exactly where "
              f"the twin is not finite")
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    return rel, f64, err


def phase_hashgrid_vs_plain(device, points, label: str, reps: int = 10):
    """The encode (K1) and table-gradient (K2) kernels against their plain
    twins on the production table, at the step's point counts (``points``:
    per jacobian flag the (P, 3) points) and the band's first three phases;
    returns per (dtype, n_active) the numbers the summary line needs."""
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
        nf = grid.n_features_per_level
        lf = grid.n_levels * nf
        for na in HG_ACTIVE:
            row = {"dtype": dt, "n_active": na}
            for p, jac in HG_POINTS:
                x = points[jac]
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
                          f"hashgrid_fwd {dt} n_active={na} P={p} {label}: "
                          f"max err {e:.3e} > {bound:.3e}")
                    check(not a[..., na * nf:].any(),
                          f"hashgrid_fwd {dt} n_active={na} P={p} {label}: "
                          f"the inactive columns are not zero")
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
                where = f"{dt} n_active={na} {label}"
                row["bwd_rel"], row["bwd_f64"], row["bwd_err"] = \
                    check_table_gradient(x, tables, spec, na, ge, gd, where)
                # timed as the step's backward calls it: the gradients in
                # the tables' dtype
                tdt = tables[0].dtype
                row["bwd_ms"] = cuda_ms(
                    lambda: hk.hashgrid_bwd(x, tables, spec, na, ge, gd,
                                            out_dtype=tdt), reps)
                row["bwd_device_ms"] = device_ms(
                    lambda: hk.hashgrid_bwd(x, tables, spec, na, ge, gd,
                                            out_dtype=tdt), reps)
                row["bwd_plain_ms"] = cuda_ms(
                    lambda: [g.to(tdt) for g in hk.hashgrid_bwd_reference(
                        x, tables, spec, na, ge, gd)], reps)
                # the partial yardstick: the scatter alone, deterministic
                idx, terms, rows = hashgrid_terms(x, spec, na, ge, gd)
                buf = torch.zeros((rows, nf), dtype=torch.float32,
                                  device=device)
                was = torch.are_deterministic_algorithms_enabled()
                torch.use_deterministic_algorithms(True)
                try:
                    row["scatter_ms"] = cuda_ms(lambda: buf.index_put_(
                        (idx,), terms, accumulate=True), reps)
                    row["scatter_device_ms"] = device_ms(
                        lambda: buf.index_put_((idx,), terms,
                                               accumulate=True), reps)
                finally:
                    torch.use_deterministic_algorithms(was)
                del idx, terms, buf
            outs = "f32" if dt == "float32" else f"f32 and {dt}"
            report(f"[9] hash grid, {label} points, {dt} n_active={na}: "
                   f"hashgrid_fwd P={HG_POINTS[1][0]} max err "
                   f"{row['enc_err']:.3e}, kernel {row['enc_ms']:.3f} ms "
                   f"(device {row['enc_device_ms']:.4f}), plain "
                   f"{row['enc_plain_ms']:.3f} ms; with jacobian "
                   f"P={HG_POINTS[0][0]} max err {row['jac_err']:.3e}, kernel "
                   f"{row['jac_ms']:.3f} ms (device "
                   f"{row['jac_device_ms']:.4f}), plain "
                   f"{row['jac_plain_ms']:.3f} ms; inactive columns zero; "
                   f"hashgrid_bwd relative L2 {row['bwd_rel']:.2e} to the "
                   f"twin, {row['bwd_f64']:.2e} to float64 (max err "
                   f"{row['bwd_err']:.3e}; {outs} out bit-equal to its "
                   f"emulation, across launches and under a permutation; NaN "
                   f"where the twin is not finite), kernel {row['bwd_ms']:.3f} ms (device "
                   f"{row['bwd_device_ms']:.4f}, {dt} out), plain "
                   f"{row['bwd_plain_ms']:.3f} ms, partial yardstick "
                   f"index_put_(accumulate=True) of its terms, deterministic "
                   f"{row['scatter_ms']:.3f} ms (device "
                   f"{row['scatter_device_ms']:.4f}); bounds "
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
    # the recon step's shape (train/nsr.py::sample_pixel_rays before the
    # fused pixel-ray kernel): one NSR step's pixel targets, 2048 rows of
    # PIXEL_COLUMNS f32 (48 bytes) from the six RECON_SIZE^2 views
    from drawingspinup_torch.train.nsr import PIXEL_COLUMNS, NSRConfig

    rays = NSRConfig.train_num_rays
    rows = 6 * RECON_SIZE ** 2
    g = torch.Generator(device=device).manual_seed(SEED + 301)
    tab = torch.randn((rows, PIXEL_COLUMNS), generator=g, device=device)
    idx = torch.randint(0, rows, (rays,), generator=g, device=device,
                        dtype=torch.int32)
    got = hk.row_gather(tab, idx)
    torch.cuda.synchronize()
    check(torch.equal(got, tab[idx.long()]),
          "row_gather differs from tab[idx] at the recon step's shape")
    row_bytes = PIXEL_COLUMNS * tab.element_size()
    nbytes = rays * (4 + row_bytes) + row_bytes * int(
        torch.unique(idx).numel())
    main = {"ms": cuda_ms(lambda: hk.row_gather(tab, idx), reps),
            "device_ms": device_ms(lambda: hk.row_gather(tab, idx), reps),
            "plain_ms": cuda_ms(lambda: hk.row_gather_reference(tab, idx),
                                reps),
            "library_ms": cuda_ms(lambda: torch.index_select(tab, 0, idx),
                                  reps),
            "library_device_ms": device_ms(
                lambda: torch.index_select(tab, 0, idx), reps),
            "bound_ms": bound_ms(nbytes, 0, F32_FLOPS)[0],
            "shape": f"K={rays} rows of {PIXEL_COLUMNS} f32 ({row_bytes} "
                     f"bytes) from a ({rows}, {PIXEL_COLUMNS}) table"}
    report(f"[10] row_gather at the recon step's shape, {main['shape']}: "
           f"bit-equal to tab[idx]; kernel {main['ms']:.4f} ms (device "
           f"{main['device_ms']:.4f} ms), plain {main['plain_ms']:.4f} ms, "
           f"index_select {main['library_ms']:.4f} ms (device "
           f"{main['library_device_ms']:.4f} ms), bound "
           f"{main['bound_ms']:.5f} ms (bytes)")
    return results, main


def phase_pixel_rays(device, reps: int = 10) -> dict:
    """The fused pixel-ray kernel (K4) against its plain twin at the recon
    step's shape: 2048 rays of six RECON_SIZE^2 views."""
    import torch

    from drawingspinup_torch.kernels import hashgrid as hk
    from drawingspinup_torch.kernels import pixel_rays as pr
    from drawingspinup_torch.train.nsr import PIXEL_COLUMNS, NSRConfig

    r, v, h, w = NSRConfig.train_num_rays, 6, RECON_SIZE, RECON_SIZE
    g = torch.Generator(device=device).manual_seed(SEED + 302)
    q, _ = torch.linalg.qr(torch.randn((v, 3, 3), generator=g, device=device,
                                       dtype=torch.float64))
    c2w = torch.cat([q, 2 * torch.randn((v, 3, 1), generator=g,
                                        device=device, dtype=torch.float64)],
                    -1).float().contiguous()
    vw = torch.rand((v,), generator=g, device=device) + 0.5
    pixels = torch.randn((v * h * w, PIXEL_COLUMNS), generator=g,
                         device=device)
    vi, yi, xi = (torch.randint(0, n, (r,), generator=g, device=device)
                  for n in (v, h, w))
    args = (c2w, vw, pixels, h, w, vi, yi, xi)
    got = pr.pixel_rays(*args)
    again = pr.pixel_rays(*args)
    want = pr.pixel_rays_reference(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
          "pixel_rays: target rows or view weights differ from the twin")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "pixel_rays: two launches differ")
    ulps = pr.ray_ulps(got, want, c2w, h, w, vi, yi, xi)
    check(max(ulps) <= RAY_ULPS,
          f"pixel_rays: rays {ulps[0]:.2f} (origins) and {ulps[1]:.2f} "
          f"(directions) ulps from the twin > {RAY_ULPS}")
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    flat = ((vi * h + yi) * w + xi).to(torch.int32)
    row_bytes = PIXEL_COLUMNS * 4
    # the draws and each named row read once, c2w and the weights once; the
    # rays (2 × 12 bytes), rows and weights written once
    nbytes = r * 24 + row_bytes * int(torch.unique(flat).numel()) \
        + v * (48 + 4) + r * (24 + row_bytes + 4)

    def kernel():
        pr.pixel_rays(*args)

    def twin():
        pr.pixel_rays_reference(*args)

    def rows():
        torch.index_select(pixels, 0, flat)

    out = {"ms": cuda_ms(kernel, reps), "device_ms": device_ms(kernel, reps),
           "plain_ms": cuda_ms(twin, reps),
           "plain_device_ms": device_ms(twin, reps),
           "index_select_ms": cuda_ms(rows, reps),
           "index_select_device_ms": device_ms(rows, reps),
           "bound_ms": bound_ms(nbytes, 0, F32_FLOPS)[0], "bytes": nbytes,
           "err": err, "ulps": ulps,
           "shape": f"R={r} rays of {v} views of {h}x{w}, rows of "
                    f"{PIXEL_COLUMNS} f32 ({row_bytes} bytes)"}
    with unfused_pixels():  # the same call, built around the row gather
        out["unfused_ms"] = cuda_ms(kernel, reps)
        out["unfused_device_ms"] = device_ms(kernel, reps)
    report(f"[10] pixel_rays at the recon step's shape, {out['shape']}: "
           f"rows and view weights bit-equal to the twin, rays within "
           f"{ulps[0]:.2f} / {ulps[1]:.2f} ulps (origins / directions; max "
           f"abs {err:.2e}), relaunch bit-identical; kernel {out['ms']:.4f} "
           f"ms (device {out['device_ms']:.4f}), twin {out['plain_ms']:.4f} "
           f"(device {out['plain_device_ms']:.4f}), unfused build around the "
           f"row gather {out['unfused_ms']:.4f} (device "
           f"{out['unfused_device_ms']:.4f}), index_select of the rows alone "
           f"{out['index_select_ms']:.4f} (device "
           f"{out['index_select_device_ms']:.4f}); bound {out['bound_ms']:.5f}"
           f" ms ({nbytes / 1e6:.3f} MB; bytes)")
    return out


def phase_recon(root: str, device):
    """The recon CLI on a synthetic sphere uid (six 1024² views): every
    band phase, the exact kernel launches per step, the OBJ under the
    reference name; returns the launches of that run."""
    import torch

    from drawingspinup_torch.cli import recon
    from drawingspinup_torch.core.io import read_obj
    from drawingspinup_torch.kernels import hashgrid as hk
    from drawingspinup_torch.kernels import pixel_rays as pr
    from drawingspinup_torch.pipelines import stage2_recon
    from drawingspinup_torch.utils.synthetic import write_sphere_mv

    paths = write_sphere_mv(root, RECON_UID, size=RECON_SIZE)
    cfg = recon_config()
    steps = cfg.max_steps
    hk.FWD_LAUNCHES = hk.FWD_JAC_LAUNCHES = hk.BWD_LAUNCHES = 0
    hk.GATHER_LAUNCHES = pr.LAUNCHES = 0
    t0 = time.time()
    recon.main(["--uid", RECON_UID, "--root", root, "--device", str(device),
                *RECON_OVERRIDES])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"hashgrid_fwd": hk.FWD_LAUNCHES + hk.FWD_JAC_LAUNCHES,
                "hashgrid_bwd": hk.BWD_LAUNCHES,
                "row_gather": hk.GATHER_LAUNCHES,
                "pixel_rays": pr.LAUNCHES}
    stats = stage2_recon.LAST_STATS
    evals = stats["export"]["field_evals"]
    check(hk.FWD_JAC_LAUNCHES == steps and hk.BWD_LAUNCHES == steps
          and hk.FWD_LAUNCHES == steps + evals
          and pr.LAUNCHES == steps and hk.GATHER_LAUNCHES == 0,
          f"recon launches: encode {hk.FWD_LAUNCHES}, with jacobian "
          f"{hk.FWD_JAC_LAUNCHES}, table gradient {hk.BWD_LAUNCHES}, pixel "
          f"rays {pr.LAUNCHES}, row gather {hk.GATHER_LAUNCHES}; expected "
          f"{steps} + {evals} export evaluations, {steps}, {steps}, {steps}, "
          f"0")
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
           f"gradient, 1 pixel rays, no row gather (+{evals} export "
           f"encodes); loss "
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


def profile_nsr_step(run, label: str, steps: int = 5):
    """Where one NSR step's device time goes (torch.profiler), and the hash
    grid kernels' share of it; returns (device busy ms, kernel launches)
    per step, or None when the profiler saw no device time."""
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
        report(f"[12] profile ({label}): the profiler saw no device time "
               f"(not measured)")
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    hg = sum(e.self_device_time_total for e in kernels
             if "hashgrid" in e.key) / 1e3 / steps
    parts = {}
    for e in kernels:
        m = re.search(r"hashgrid_\w+", e.key)
        if m:
            t, n = parts.get(m.group(0), (0.0, 0))
            parts[m.group(0)] = (t + e.self_device_time_total, n + e.count)
    hg_parts = ", ".join(f"{k} {t / 1e3 / steps:.4f} ms x{n // steps}"
                         for k, (t, n) in parts.items())
    top = "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3 / steps:.3f} ms "
        f"x{e.count // steps}" for e in kernels[:8])
    launches = sum(e.count for e in kernels) / steps
    report(f"[12] profile of {steps} production steps (bf16, {label}): "
           f"device busy {total:.2f} ms of {wall:.2f} ms wall per step "
           f"({total / wall:.1%}, the profiler's overhead included), "
           f"hash-grid kernels {hg:.3f} ms ({hg / total:.1%} of device time: "
           f"{hg_parts}), "
           f"{launches:.0f} kernel launches per step; by kernel, per step: "
           f"{top}")
    return total, launches


def phase_nsr_step_vs_plain(root: str, device) -> dict:
    """One NSR step from the trained state and one set of draws, kernel path
    against plain path: in f32 against the plain path in float64, in bf16
    (production) against the plain path in f32; ms per step of each path
    and of the kernel path with the unfused pixel build, and a profile of
    the last two."""
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

    def fresh_state():
        params = trained_params(root, torch.float32, device)
        params["geometry"]["table"] = [
            t.detach().to(cfg.sdf.grid.tdt).requires_grad_(True)
            for t in params["geometry"]["table"]]
        opt = nsr.make_optimizer(cfg)
        return opt, nsr.TrainState(params, opt.init(params), step)

    paths = {"kernel": contextlib.nullcontext, "plain": plain_hashgrid,
             "unfused": unfused_pixels}
    for name, ctx in paths.items():
        opt, state = fresh_state()
        with ctx():
            ms[name] = cuda_ms(lambda: nsr.train_step(
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
           f"production step (bf16, CUDA events): kernel {ms['kernel']:.2f}, "
           f"kernel with the unfused pixel build {ms['unfused']:.2f}, plain "
           f"{ms['plain']:.2f}")
    prof = {}
    for name in ("unfused", "kernel"):
        opt, state = fresh_state()
        label = "kernel path" + (", the unfused pixel build around the row "
                                 "gather" if name == "unfused" else "")
        with paths[name]():
            prof[name] = profile_nsr_step(lambda: nsr.train_step(
                cfg, opt, state, data32, draws32, n_active), label)
    if prof["kernel"] and prof["unfused"]:
        check(prof["unfused"][1] > prof["kernel"][1],
              f"the fused pixel kernel did not cut the step's launches: "
              f"{prof['unfused'][1]:.0f} -> {prof['kernel'][1]:.0f}")
        report(f"[12] launches per production step: "
               f"{prof['unfused'][1]:.0f} with the unfused pixel build, "
               f"{prof['kernel'][1]:.0f} with the fused kernel "
               f"({prof['unfused'][1] - prof['kernel'][1]:.0f} fewer); "
               f"device busy {prof['unfused'][0]:.3f} -> "
               f"{prof['kernel'][0]:.3f} ms; host clock {ms['unfused']:.2f} "
               f"-> {ms['kernel']:.2f} ms")
    return {"ms": ms, "profile": prof}


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
    export_chains(cfg, params, front, device)


def export_chains(cfg, params, front, device) -> None:
    """The export at mc256 by each chain JAX can take there: device-smooth
    (the default), the level chain as DSU_DEVICE_SMOOTH=0 runs it
    (band-sparse), and the level chain's dense grid (what every R < 256
    runs); each a non-empty mesh of the sphere's median radius within 35 %,
    with its device and host seconds."""
    import torch

    from drawingspinup_torch.pipelines import stage2_export as ex

    device_parts = ("bbox", "band_eval", "smooth_pack", "grid_eval")
    host_parts = ("carve_smooth", "march", "remesh")
    rows = []
    old = os.environ.get("DSU_DEVICE_SMOOTH")
    try:
        for label, env in (("device-smooth", "1"),
                           ("level (DSU_DEVICE_SMOOTH=0)", "0")):
            os.environ["DSU_DEVICE_SMOOTH"] = env
            torch.cuda.synchronize()
            v, f, times = ex.export_mesh(cfg, params, CHAIN_MC,
                                         cfg.max_steps, device, front,
                                         RECON_FACES)
            rows.append((label, v, f, times))
    finally:
        if old is None:
            os.environ.pop("DSU_DEVICE_SMOOTH", None)
        else:
            os.environ["DSU_DEVICE_SMOOTH"] = old
    check(rows[0][3]["chain"] == "device_smooth"
          and rows[1][3]["chain"] == "level",
          f"export chains at mc{CHAIN_MC}: "
          f"{[r[3]['chain'] for r in rows]}")
    ev = ex.FieldEvaluator(cfg, params, cfg.max_steps, device)
    times = {}
    level, vmin, vmax = ex.isosurface_level(ev, CHAIN_MC, cfg.radius,
                                            sparse=False, times=times)
    v, f = ex.isosurface_from_level(level, vmin, vmax, CHAIN_MC, front,
                                    RECON_FACES, times=times)
    rows.append(("level, dense grid", v, f, times))
    out = []
    for label, v, f, times in rows:
        radius = float(np.median(np.linalg.norm(v, axis=1)))
        check(len(f) > 1000
              and abs(radius - SPHERE_RADIUS) / SPHERE_RADIUS < 0.35,
              f"export at mc{CHAIN_MC}, {label}: {len(v)} vertices, "
              f"{len(f)} faces, median radius {radius:.4f} (sphere "
              f"{SPHERE_RADIUS})")
        dev_s = sum(times.get(k, 0.0) for k in device_parts)
        host_s = sum(times.get(k, 0.0) for k in host_parts)
        out.append(f"{label}: device {dev_s:.2f} s ("
                   + ", ".join(f"{k} {times[k]:.2f}" for k in device_parts
                               if k in times)
                   + f"), host {host_s:.2f} s ("
                   + ", ".join(f"{k} {times[k]:.2f}" for k in host_parts
                               if k in times)
                   + f"), {len(v)} vertices / {len(f)} faces, median "
                   f"radius {radius:.4f}")
    report(f"[13] export chains at mc{CHAIN_MC} (sphere radius "
           f"{SPHERE_RADIUS}): " + "; ".join(out))


# ---------------------------------------------------------------------------
# the stage-3 renders and stage 1
# ---------------------------------------------------------------------------

def render_passes(d: str):
    """Every frame of the color, pos and edge passes under ``d``, u8."""
    from drawingspinup_torch.core.io import read_image_u8

    return {name: [read_image_u8(os.path.join(d, name, f)).astype(np.int16)
                   for f in sorted(os.listdir(os.path.join(d, name)))]
            for name in ("color", "pos", "edge")}


def phase_renders(root: str, device) -> None:
    """The run_render CLI on the production-size rig, on the card and with
    ``--device cpu``: equal frames within the shares of RENDER_SHARE, and
    seconds per frame by part."""
    from drawingspinup_torch.cli import run_render
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.utils.synthetic import write_rig_uid

    runs = []
    for uid, dev in ((RENDER_UID, str(device)), (RENDER_UID + "_cpu", "cpu")):
        write_rig_uid(root, uid, actions=("walk",), **RENDER_RIG)
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            run_render.main(["--uid", uid, "--data_dir", root, "--test",
                             "--device", dev])
        wall = time.time() - t0
        print(buf.getvalue(), end="", file=sys.stderr)
        info = json.loads(buf.getvalue().strip().splitlines()[-1])["walk"]
        runs.append((info, wall, render_passes(
            UidPaths(root, uid).action_dir("walk"))))
    (info, wall, got), (cinfo, cwall, want) = runs
    n = info["frames"]
    check(n == cinfo["frames"] == RENDER_FRAMES
          and info["size"] == cinfo["size"] >= FRAME,
          f"renders: {n} / {cinfo['frames']} frames of {info['size']} / "
          f"{cinfo['size']} px, expected {RENDER_FRAMES} of >= {FRAME}")
    value_off, alpha_off, edge_off = [], [], []
    for k in range(n):
        for name in ("color", "pos"):
            g, w = got[name][k], want[name][k]
            check(g.shape == w.shape == (info["size"], info["size"], 4),
                  f"render {name} frame {k + 1}: {g.shape} vs {w.shape}")
            value_off.append(np.abs(g[..., :3] - w[..., :3]) > 1)
            alpha_off.append(g[..., 3] != w[..., 3])
        edge_off.append(got["edge"][k] != want["edge"][k])
    shares = [float(np.mean(a)) for a in (value_off, alpha_off, edge_off)]
    lit = float(np.mean([f[..., 3] > 0 for f in got["color"]]))
    check(lit > 0.01, f"renders: only {lit:.2%} of pixels covered")
    check(all(x < RENDER_SHARE for x in shares),
          f"renders, card vs CPU: color/pos values off by more than 1 on "
          f"{shares[0]:.3%}, alpha on {shares[1]:.3%}, edge on "
          f"{shares[2]:.3%} (limit {RENDER_SHARE:.1%})")
    parts = ", ".join(f"{k} {v / n:.4f}" for k, v in info["seconds"].items())
    cparts = ", ".join(f"{k} {v / n:.4f}"
                       for k, v in cinfo["seconds"].items())
    report(f"[14] renders: run_render on a rig of {8 * RENDER_RIG['n_seg']} "
           f"faces, {n} frames ({RENDER_RIG['duration']} s at 30 fps) of "
           f"{info['size']}^2 x 3 passes; card vs --device cpu: color/pos "
           f"values off by more than 1 on {shares[0]:.4%}, alpha on "
           f"{shares[1]:.4%}, edge on {shares[2]:.4%} of pixels; s/frame "
           f"(host clock, the device synchronised at each part) on the card "
           f"{wall / n:.4f} wall ({parts}), with --device cpu "
           f"{cwall / n:.4f} wall ({cparts}); {lit:.1%} of pixels covered")


def conv_flops(model, x) -> float:
    """Multiply-add FLOPs (2 per MAC) of ``model``'s convolutions and
    transposed convolutions on ``x``, per sample."""
    import torch

    total = [0.0]

    def hook(m, inp, out):
        k = m.weight[0, 0].numel()
        if isinstance(m, torch.nn.ConvTranspose2d):
            total[0] += 2.0 * inp[0].numel() * m.out_channels * k
        else:
            total[0] += 2.0 * out.numel() * m.in_channels // m.groups * k

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0] / x.shape[0]


def write_drawings(root: str, n: int, size: int, seed: int):
    """``n`` drawing uids: a disc in a seeded colour with a dark contour
    ring, at a seeded place and radius, as ``char/texture.png`` (RGBA)."""
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.core.io import write_image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    uids = []
    for i in range(n):
        cy, cx = size * rng.uniform(0.4, 0.6, 2)
        r0 = size * rng.uniform(0.2, 0.32)
        r = np.hypot(yy - cy, xx - cx)
        body, ring = r < 0.93 * r0, (r >= 0.93 * r0) & (r < 1.1 * r0)
        rgba = np.zeros((size, size, 4), np.float32)
        rgba[body, :3] = rng.uniform(0.3, 0.95, 3) * (
            0.8 + 0.2 * np.sin(xx[body] / 9.0)[:, None])
        rgba[ring, :3] = 0.05
        rgba[..., 3] = body | ring
        uids.append(f"drawing{i}")
        write_image(UidPaths(root, uids[-1]).texture, rgba)
    return uids


def phase_stage1(root: str, device) -> None:
    """The predict CLI on DRAWINGS drawings at the full width of
    lama-fourier.yaml; the generator's logits on the card against float64
    on the CPU; ms per drawing, cuFFT's share, Telea's host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from drawingspinup_torch.cli import predict
    from drawingspinup_torch.core import device as device_setup
    from drawingspinup_torch.core.config import load_config
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.core.io import read_image_u8
    from drawingspinup_torch.pipelines import stage1

    uids = write_drawings(root, DRAWINGS, DRAWING_SIZE, SEED + 400)
    yaml = os.path.join(REPO, LAMA_YAML)
    inputs = [stage1.load_input(UidPaths(root, u), DRAWING_SIZE)
              for u in uids]
    x8 = torch.from_numpy(np.concatenate(
        [np.stack([i[0] for i in inputs]), np.stack([i[1] for i in inputs])],
        axis=-1)).permute(0, 3, 1, 2).contiguous()
    # seeded weights, the head rescaled so that the logits of the first
    # drawing have std 2 around the threshold's logit: the He init alone
    # gives logits of std ~10^3, where the thresholded masks check little
    thr = math.log(stage1.CONTOUR_THRESHOLD
                   / (1 - stage1.CONTOUR_THRESHOLD))
    model = stage1.build_generator(load_config(yaml))
    predict.seeded_init(model, SEED)
    model.to(device)
    with torch.no_grad():
        y = model.logits(x8[:1].to(device))
        head = model.model[-1]
        k = 2.0 / y.std()
        head.weight.mul_(k)
        head.bias.copy_(k * (head.bias - y.mean())
                        + thr)
    ckpt = os.path.join(root, "lama_seeded.pth")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    lst = os.path.join(root, "drawing_uids.json")
    with open(lst, "w") as f:
        json.dump(uids, f)

    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        predict.main([yaml, f"pretrained.path={ckpt}", f"uid_json={lst}",
                      "--root", root, "--device", str(device),
                      "--batch-size", str(DRAWINGS),
                      "--size", str(DRAWING_SIZE)])
    torch.cuda.synchronize()
    cli_s = (time.time() - t0) / DRAWINGS
    for u in uids:
        p = UidPaths(root, u)
        check(os.path.exists(p.inpainted), f"predict wrote no {p.inpainted}")
        out, tex = read_image_u8(p.inpainted), read_image_u8(p.texture)
        check(out.shape == (DRAWING_SIZE, DRAWING_SIZE, 4)
              and np.array_equal(out[..., 3], tex[..., 3]),
              f"{p.inpainted}: shape {out.shape} or alpha differs from the "
              f"input's")

    # the CLI's weights, from its checkpoint, on the card and on the CPU
    cfg = load_config(yaml, [f"pretrained.path={ckpt}"])
    card = stage1.build_generator(cfg)
    predict.load_weights(card, cfg, SEED)
    cpu32 = copy.deepcopy(card)
    cpu64 = copy.deepcopy(card).double()
    card.to(device)
    x1 = x8[:1]
    with torch.inference_mode():
        y_card = card.logits(x1.to(device)).double().cpu()
        t0 = time.time()
        y64 = cpu64.logits(x1.double())
        t64 = time.time() - t0
        y32 = cpu32.logits(x1).double()
        probs = card(x8.to(device))
    check(bool(torch.isfinite(y_card).all() and torch.isfinite(probs).all()),
          "stage 1: non-finite logits or probabilities")
    rel_card = ((y_card - y64).norm() / y64.norm()).item()
    rel_cpu = ((y32 - y64).norm() / y64.norm()).item()
    mask_off = ((y_card > thr) != (y64 > thr)).double().mean().item()
    contour = (y64 > thr).double().mean().item()
    check(rel_card <= LOGIT_REL_L2,
          f"stage 1 logits, card f32 vs CPU float64: relative L2 "
          f"{rel_card:.3e} > {LOGIT_REL_L2:g} (CPU f32: {rel_cpu:.3e})")
    check(mask_off < MASK_SHARE,
          f"stage 1 contour masks differ on {mask_off:.4%} of pixels")

    with torch.inference_mode():
        xd8, xd1 = x8.to(device), x1.to(device)
        ms1 = cuda_ms(lambda: card(xd1), reps=5)
        ms8 = cuda_ms(lambda: card(xd8), reps=5) / DRAWINGS
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            card(xd8)
            torch.cuda.synchronize()
        # yardsticks, not the port's setting (heuristic choice among
        # deterministic algorithms): cuDNN autotuned among the
        # deterministic algorithms, and among all
        torch.backends.cudnn.benchmark = True
        try:
            tuned8 = []
            for deterministic in (True, False):
                torch.backends.cudnn.deterministic = deterministic
                tuned8.append(cuda_ms(lambda: card(xd8), reps=5, warmup=3)
                              / DRAWINGS)
        finally:
            device_setup.setup(device)    # the port's settings again
    flops = conv_flops(card, xd1)
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    # cuFFT: the device time under torch.fft's ops (cuDNN's own FFT
    # convolution kernels also carry "fft" in their names)
    fft = sum(e.device_time_total for e in events
              if e.key.startswith("aten::_fft_")) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
                    f"x{e.count}" for e in kernels[:6])
    fft_note = (f"device busy {busy:.2f} ms a batch of {DRAWINGS}, cuFFT "
                f"(torch.fft's ops) {fft:.2f} ms ({fft / busy:.1%}); top "
                f"kernels: {top}") if busy > 0 else \
        "cuFFT share not measured (the profiler saw no device time)"
    p_np = probs.permute(0, 2, 3, 1).float().cpu().numpy()
    t0 = time.time()
    for (rgb, alpha), prob in zip(inputs, p_np):
        stage1.postprocess_one(rgb, alpha, prob)
    telea_s = (time.time() - t0) / DRAWINGS
    report(f"[15] stage 1: predict on {DRAWINGS} drawings of "
           f"{DRAWING_SIZE}^2, lama-fourier.yaml at full width "
           f"({sum(p.numel() for p in card.parameters()) / 1e6:.1f} M "
           f"parameters, seeded): every ffc_resnet_inpainted.png written, "
           f"alpha equal to the input's; logits card f32 vs CPU float64 "
           f"relative L2 {rel_card:.3e} (CPU f32 {rel_cpu:.3e}; limit "
           f"{LOGIT_REL_L2:g}), contour masks differ on {mask_off:.4%} of "
           f"pixels ({contour:.1%} contour); forward {ms1:.2f} ms per drawing "
           f"at batch 1, {ms8:.2f} at batch {DRAWINGS} (CUDA events; "
           f"{flops / 1e9:.1f} GFLOP of convolutions a drawing, "
           f"{flops / ms8 / 1e9:.1f} TFLOP/s at batch {DRAWINGS}; not the "
           f"port's setting: cuDNN autotuned among its deterministic "
           f"algorithms {tuned8[0]:.2f}, among all {tuned8[1]:.2f}); "
           f"{fft_note}; threshold + Telea "
           f"{telea_s:.3f} host s per drawing; CLI wall {cli_s:.2f} s per "
           f"uid (checkpoint load and first-call set-up included); CPU "
           f"float64 forward {t64:.1f} s")


def count_flops(model, *args) -> float:
    """FLOPs of one forward of ``model``: 2 per multiply-add of every conv
    and dense map (forward hooks) and of the attention products, 4·B·Sq·Sk·C
    a call of ``models/attention_mv.py::attention_core``."""
    import torch

    from drawingspinup_torch.models import attention_mv as am

    total = [0.0]

    def conv(m, inp, out):          # Cout·Ho·Wo·N outputs × Cin·kh·kw
        total[0] += 2.0 * out.numel() * m.weight[0].numel()

    def dense(m, inp, out):         # outputs × in features
        total[0] += 2.0 * out.numel() * m.weight.shape[1]

    core = am.attention_core

    def counted(q, k, v, heads):
        total[0] += 4.0 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
        return core(q, k, v, heads)

    hooks = [m.register_forward_hook(
        conv if isinstance(m, torch.nn.Conv2d) else dense)
        for m in model.modules()
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                          am.Conv1x1Tokens))]
    am.attention_core = counted
    try:
        with torch.inference_mode():
            model(*args)
    finally:
        am.attention_core = core
        for h in hooks:
            h.remove()
    return total[0]


def phase_mv(root: str, device) -> None:
    """Stage 2a: the mv CLI at full width on phase 15's first uid; one UNet
    call in f32 against float64; the denoise loop's bit-identity; times by
    part and a profile of one denoise step."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from drawingspinup_torch.cli import mv as cli_mv
    from drawingspinup_torch.core.contract import VIEWS, UidPaths
    from drawingspinup_torch.core.io import read_image_u8
    from drawingspinup_torch.ops import diffusion as D
    from drawingspinup_torch.pipelines import stage2_mv as mv

    paths = UidPaths(root, MV_UID)
    check(os.path.exists(paths.inpainted),
          f"stage 2a needs stage 1's {paths.inpainted}")
    # the CLI, the decoded images' finiteness recorded on the way
    finite = []
    decode = mv.MVPipeline.decode

    def recorded(self, latents):
        img = decode(self, latents)
        finite.append(bool(torch.isfinite(img).all()))
        return img

    mv.MVPipeline.decode = recorded
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            cli_mv.main(["--uid", MV_UID, "--root", root, "--device",
                         str(device), "--seed", str(MV_SEED)])
        torch.cuda.synchronize()
    finally:
        mv.MVPipeline.decode = decode
    wall = time.time() - t0
    stats = dict(mv.LAST_STATS)
    check(finite == [True], f"stage 2a: decoded images finite: {finite}")
    for kind in ("normal", "color", "mask"):
        for v in VIEWS:
            a = read_image_u8(paths.mv(kind, v))
            check(a.shape[:2] == (MV_OUT, MV_OUT)
                  and (kind != "mask" or set(np.unique(a)) <= {0, 255}),
                  f"{paths.mv(kind, v)}: shape {a.shape}")
    front = read_image_u8(paths.mv("mask", "front"))[..., 0] > 127
    alpha = read_image_u8(paths.inpainted)[..., 3] > 127
    check(abs(front.mean() - alpha.mean()) < 0.01,
          f"front mask covers {front.mean():.4f}, the drawing "
          f"{alpha.mean():.4f}")

    # one UNet call at batch 12 on the uid's conditioning: f32 vs float64
    cfg = mv.MVPipelineConfig()
    pipe = mv.MVPipeline.init_random(cfg, MV_SEED, device)
    g = torch.Generator(device=device).manual_seed(MV_SEED + 1)
    with torch.no_grad():
        for n, p in pipe.unet.named_parameters():
            if "attn_joint" in n and "to_out" in n:
                p.copy_(torch.randn(p.shape, generator=g, device=device)
                        / math.sqrt(p.shape[-1]))
    image, _ = mv.load_input(paths, cfg.image_size, device)
    views = list(VIEWS)
    with torch.inference_mode():
        embeds, cond = pipe.encode_image(image)
        nv2 = 2 * len(views)
        lat = torch.randn((nv2,) + tuple(cond.shape[1:]), generator=g,
                          device=device)
        ts = D.timesteps_for(cfg.ddim, cfg.num_inference_steps)
        cam = torch.as_tensor(mv.sincos(mv.camera_task_embeddings(views)),
                              device=device)
        args32 = (torch.cat([lat, cond.expand(nv2, -1, -1, -1)], 1),
                  torch.tensor(int(ts[len(ts) // 2]), device=device),
                  embeds.expand(nv2, -1, -1).contiguous(), cam)

        def cast(dt):
            return tuple(a.to(dt) if a.is_floating_point() else a
                         for a in args32)

        y32 = pipe.unet(*args32).double()
        u64 = copy.deepcopy(pipe.unet).double()
        t0 = time.time()
        y64 = u64(*cast(torch.float64))
        torch.cuda.synchronize()
        t64 = time.time() - t0
        del u64
        u16 = pipe.unet_in(torch.bfloat16)
        args16 = cast(torch.bfloat16)
        y16 = u16(*args16).double()
    check(bool(torch.isfinite(y32).all() and torch.isfinite(y16).all()),
          "stage 2a: non-finite UNet output")
    norm = y64.norm()
    rel32 = ((y32 - y64).norm() / norm).item()
    rel16 = ((y16 - y64).norm() / norm).item()
    check(rel32 <= MV_REL_L2,
          f"stage 2a UNet, f32 vs float64 on the card: relative L2 "
          f"{rel32:.3e} > {MV_REL_L2:g}")
    flops = count_flops(u16, *args16)
    with torch.inference_mode():
        ms16 = cuda_ms(lambda: u16(*args16), reps=5)
        ms32 = cuda_ms(lambda: pipe.unet(*args32), reps=3)
        enc_ms = cuda_ms(lambda: pipe.encode_image(image), reps=3)
        z = torch.randn((nv2,) + tuple(cond.shape[1:]), generator=g,
                        device=device)
        dec_ms = cuda_ms(lambda: pipe.decode_u8(z), reps=3)

    # the denoise loop twice from one generator state, bit-identical
    short = mv.MVPipeline(dataclasses.replace(
        cfg, num_inference_steps=MV_SAME_STEPS), pipe.unet, pipe.vae,
        pipe.clip)
    runs = [short.denoise(embeds, cond, views, torch.Generator(
        device=device).manual_seed(MV_SEED + 2)) for _ in range(2)]
    check(torch.equal(runs[0], runs[1]),
          "stage 2a: the denoise loop differs between two runs")

    # one denoise step under the profiler
    one = mv.MVPipeline(dataclasses.replace(cfg, num_inference_steps=1),
                        pipe.unet, pipe.vae, pipe.clip)
    gen = torch.Generator(device=device).manual_seed(MV_SEED + 3)
    one.denoise(embeds, cond, views, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        one.denoise(embeds, cond, views, gen)
        torch.cuda.synchronize()
        step_wall = 1e3 * (time.time() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
                    f"x{e.count}" for e in kernels[:6])
    step_note = (f"one denoise step under the profiler: device busy "
                 f"{busy:.2f} ms of {step_wall:.2f} ms wall "
                 f"({busy / step_wall:.1%}, the profiler's overhead "
                 f"included), {launches} kernel launches; top: {top}"
                 if busy > 0 else "one denoise step: the profiler saw no "
                 "device time (not measured)")
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    report(f"[16] stage 2a: mv CLI at full width (UNet "
           f"{n_params / 1e6:.1f} M parameters, joint mid attention; SD VAE;"
           f" CLIP ViT-L/14; seeded), {cfg.num_inference_steps} DDIM steps "
           f"over {nv2} images of {cond.shape[2]}^2 latents in "
           f"{cfg.compute_dtype}, uid {MV_UID}: 18 PNGs of {MV_OUT}^2, "
           f"decoded images finite; UNet call (batch {nv2}) f32 vs float64 "
           f"on the card relative L2 {rel32:.3e} (limit {MV_REL_L2:g}; "
           f"bf16 {rel16:.3e}; float64 call {t64:.1f} s); denoise loop "
           f"bit-identical over two runs ({MV_SAME_STEPS} steps); UNet "
           f"{ms16:.2f} ms a call in bf16, {ms32:.2f} in f32 (CUDA events; "
           f"{flops / 1e12:.3f} TFLOP a call: {flops / ms16 / 1e9:.1f} "
           f"TFLOP/s in bf16, {flops / ms32 / 1e9:.1f} in f32); CLI s: read "
           f"{stats['read_s']:.2f}, encode {stats['encode_s']:.2f}, "
           f"{cfg.num_inference_steps}-step loop {stats['denoise_s']:.2f} "
           f"({1e3 * stats['denoise_s'] / cfg.num_inference_steps:.1f} ms a "
           f"step), decode + upscale + u8 {stats['decode_u8_s']:.2f}, masks "
           f"(host) {stats['masks_s']:.2f}, PNG writes "
           f"{stats['write_s']:.2f}, CLI wall {wall:.1f} s a uid (weights "
           f"drawn and cast included); steady encode {enc_ms:.1f} ms, decode "
           f"+ upscale + u8 {dec_ms:.1f} ms (CUDA events); {step_note}")


def phase_isnet(root: str, device) -> None:
    """ISNet DIS at full width with seeded weights, loaded as the mv
    pipeline loads them (a state_dict named by DSU_ISNET_CKPT), on the side
    views of phase 16's uid: f32 against float64 on the card, the written
    masks against float64's, ms per view."""
    import torch

    from drawingspinup_torch.core.contract import VIEWS, UidPaths
    from drawingspinup_torch.core.io import read_image
    from drawingspinup_torch.models.isnet import ISNetDIS
    from drawingspinup_torch.pipelines import stage2_mv as mv

    torch.manual_seed(SEED + 600)
    model = ISNetDIS()
    g = torch.Generator().manual_seed(SEED + 601)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    ckpt = os.path.join(root, "isnet_seeded.pth")
    torch.save(model.state_dict(), ckpt)
    paths = UidPaths(root, MV_UID)
    sides = [v for v in VIEWS if v not in ("front", "back")]
    imgs = [read_image(paths.mv("color", v))[..., :3] for v in sides]
    old = os.environ.get("DSU_ISNET_CKPT")
    os.environ["DSU_ISNET_CKPT"] = ckpt
    try:
        masks = [mv.background_removal(im, device=device) for im in imgs]
        torch.cuda.synchronize()
        ms_view = cuda_ms(lambda: mv.background_removal(imgs[0],
                                                        device=device),
                          reps=3)
        net = mv.isnet_model(device)
    finally:
        if old is None:
            os.environ.pop("DSU_ISNET_CKPT")
        else:
            os.environ["DSU_ISNET_CKPT"] = old
    x = torch.from_numpy(np.ascontiguousarray(imgs[0])).to(device)
    x = (x - 0.5).permute(2, 0, 1)[None]
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: net(x), reps=3)
        net64 = copy.deepcopy(net).double()
        rels, shares = [], []
        for im, m in zip(imgs, masks):
            xi = torch.from_numpy(np.ascontiguousarray(im)).to(device)
            xi = (xi - 0.5).permute(2, 0, 1)[None]
            d64 = net64(xi.double())[0][0, 0]
            d32 = net(xi)[0][0, 0].double()
            rels.append(((d32 - d64).norm() / d64.norm()).item())
            u8 = torch.floor(torch.clamp(torch.clamp(d64, 0, 1) * 255.0
                                         + 0.5, 0, 255)).cpu().numpy()
            got = np.floor(np.clip(m * 255.0 + 0.5, 0, 255))
            shares.append(float((got != u8).mean()))
        del net64
    check(all(np.isfinite(m).all() and m.shape == im.shape[:2]
              for m, im in zip(masks, imgs)),
          "ISNet masks: non-finite or of the wrong shape")
    check(max(rels) <= ISNET_REL_L2,
          f"ISNet f32 vs float64 on the card: relative L2 {max(rels):.3e} > "
          f"{ISNET_REL_L2:g}")
    check(max(shares) < MASK_SHARE,
          f"ISNet masks differ from float64's on {max(shares):.4%} of "
          f"pixels")
    n_params = sum(p.numel() for p in net.parameters())
    report(f"[16] ISNet DIS at full width ({n_params / 1e6:.1f} M parameters,"
           f" seeded, loaded through DSU_ISNET_CKPT) on {len(sides)} side "
           f"views of {imgs[0].shape[0]}^2: f32 vs float64 on the card "
           f"relative L2 {max(rels):.3e} (limit {ISNET_REL_L2:g}), u8 masks "
           f"differ on {max(shares):.4%} of pixels (limit {MASK_SHARE:.1%}), "
           f"mask mean {np.mean([m.mean() for m in masks]):.3f}; "
           f"background_removal {ms_view:.2f} ms a view (host to host), the "
           f"network's forward {fwd_ms:.2f} ms (CUDA events)")


def phase_sweep(root: str, device) -> dict:
    """Two uids through ``run_sweep`` with ``cli/sweep.py``'s stage
    functions, drawing to GIF; returns the kernel launches of that run and
    the seconds per stage per uid."""
    import torch

    from drawingspinup_torch.cli import sweep as sweep_cli
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.core.io import read_image, write_image
    from drawingspinup_torch.kernels import hashgrid as hk
    from drawingspinup_torch.kernels import pixel_rays as pr
    from drawingspinup_torch.kernels import ric_conv as rk
    from drawingspinup_torch.pipelines import stage2_recon
    from drawingspinup_torch.pipelines import sweep
    from drawingspinup_torch.utils.synthetic import make_rig_fbx, \
        write_sphere_mv

    for uid, src in zip(SWEEP_UIDS, SWEEP_DRAWINGS):
        paths = UidPaths(root, uid)
        rgba = read_image(UidPaths(root, src).texture)
        write_image(paths.texture, rgba)
        write_image(paths.texture_with_bg, rgba[..., :3] * rgba[..., 3:]
                    + (1 - rgba[..., 3:]))
        # the mv contract (seeded Wonder3D weights give no usable views)
        write_sphere_mv(root, uid, size=RECON_SIZE)
        # the rig, without the bar's OBJ: the recon stage writes the mesh
        os.makedirs(paths.fbx_dir, exist_ok=True)
        for action in ("rest_pose",) + ACTIONS:
            make_rig_fbx(os.path.join(paths.fbx_dir, f"{action}.fbx"),
                         action != "rest_pose", **STAGE3_RIG)
    uids = os.path.join(root, "sweep_uids.json")
    thin = os.path.join(root, "sweep_thinning.json")
    with open(uids, "w") as f:
        json.dump(list(SWEEP_UIDS), f)
    with open(thin, "w") as f:
        json.dump([SWEEP_UIDS[1]], f)
    yaml = os.path.join(REPO, LAMA_YAML)
    fns = sweep_cli.stage_functions(
        root, str(device),
        predict_args=[yaml, f"pretrained.path="
                      f"{os.path.join(root, 'lama_seeded.pth')}",
                      "--size", str(DRAWING_SIZE), "--batch-size", "1"],
        recon_overrides=[*RECON_OVERRIDES,
                         f"dataset.thinning_uid_list_file={thin}"],
        train_args=[["--max-batches", str(n), "--seed", str(SEED)]
                    for n in TRAIN_BATCHES],
        allow_degraded=True)
    log = os.path.join(root, "sweep_log.jsonl")
    rk.LAUNCHES = rk.BWD_LAUNCHES = 0
    hk.FWD_LAUNCHES = hk.FWD_JAC_LAUNCHES = hk.BWD_LAUNCHES = 0
    hk.GATHER_LAUNCHES = pr.LAUNCHES = 0
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        # no resume on this first run: train_style's eval writes the
        # res_stage frames by which a resumed sweep counts test_style done
        result = sweep.run_sweep(root, uids,
                                 {s: fns[s] for s in SWEEP_STAGES},
                                 resume=False, log_path=log)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"ric_conv_fwd": rk.LAUNCHES, "ric_conv_bwd": rk.BWD_LAUNCHES,
                "hashgrid_fwd": hk.FWD_LAUNCHES + hk.FWD_JAC_LAUNCHES,
                "hashgrid_bwd": hk.BWD_LAUNCHES,
                "pixel_rays": pr.LAUNCHES, "row_gather": hk.GATHER_LAUNCHES}
    with open(log) as f:
        records = [json.loads(line) for line in f]
    failed = [r for r in records if r["stage"] == "FAILED"]
    check(not failed and result["ok"] == list(SWEEP_UIDS),
          f"sweep: {result}; failures: "
          f"{[(r['uid'], r['error'], r['traceback'][-600:]) for r in failed]}")
    done = [r["uid"] for r in records if r["stage"] == "done"]
    check(done == list(SWEEP_UIDS), f"sweep: done records {done}")
    order = [(r["uid"], r["stage"]) for r in records
             if r["stage"] != "done"]
    check(order == [(u, s) for s in SWEEP_STAGES for u in SWEEP_UIDS],
          f"sweep: not stage-major: {order}")
    n_frames = len(ACTIONS) * FRAMES_PER_ACTION + 1
    steps = recon_config().max_steps
    n = len(SWEEP_UIDS)
    want_fwd = n * (FWD_PER_STEP * TRAIN_BATCHES[0]
                    + RIC_PER_FRAME * 2 * n_frames)
    check(launches["ric_conv_fwd"] == want_fwd
          and launches["ric_conv_bwd"] == n * BWD_PER_STEP * TRAIN_BATCHES[0]
          and launches["pixel_rays"] == n * steps
          and launches["hashgrid_bwd"] == n * steps
          and hk.FWD_JAC_LAUNCHES == n * steps
          and hk.FWD_LAUNCHES > n * steps
          and launches["row_gather"] == 0,
          f"sweep launches {launches} (encode without the jacobian "
          f"{hk.FWD_LAUNCHES}); expected RIC forward {want_fwd}, backward "
          f"{n * BWD_PER_STEP * TRAIN_BATCHES[0]}, per recon step one pixel "
          f"rays, one table gradient, one encode with and one without the "
          f"jacobian, plus the export's encodes, no row gather")
    names = [stage2_recon.export_name(steps, RECON_MC, RECON_FACES, True,
                                      True, thinned, True, True) + ".obj"
             for thinned in (False, True)]
    for uid, name in zip(SWEEP_UIDS, names):
        paths = UidPaths(root, uid)
        for stage in SWEEP_STAGES:
            check(sweep.stage_done(paths, stage),
                  f"sweep: {uid} has no {stage} outputs")
        objs = sorted(f for f in os.listdir(paths.mesh_dir)
                      if f.endswith(".obj"))
        check(objs == [name], f"sweep: {uid}'s meshes {objs}, expected "
                              f"{name}")
        for action in ACTIONS + ("rest_pose",):
            check(os.path.exists(paths.gif(action)),
                  f"sweep: no {paths.gif(action)}")
    # a resumed sweep runs no stage
    calls = []
    again = sweep.run_sweep(root, uids, {
        s: (lambda uid, s=s: calls.append((uid, s))) for s in SWEEP_STAGES},
        log_path=os.path.join(root, "sweep_resume.jsonl"))
    check(not calls and again["ok"] == list(SWEEP_UIDS),
          f"resumed sweep ran {calls}")
    secs = {(r["uid"], r["stage"]): r["seconds"] for r in records
            if r["stage"] in SWEEP_STAGES}
    table = "; ".join(
        f"{uid}: " + ", ".join(f"{s} {secs[uid, s]:.1f}"
                               for s in SWEEP_STAGES)
        + f" (total {sum(secs[uid, s] for s in SWEEP_STAGES):.1f})"
        for uid in SWEEP_UIDS)
    degraded = sorted({c for r in records
                       for c in r.get("degraded_weights", [])})
    report(f"[17] sweep (cli/sweep.py's stage functions, stage-major) of "
           f"{n} uids, {', '.join(SWEEP_STAGES)}: both done, no failure, "
           f"{SWEEP_UIDS[1]} thinned (its OBJ {names[1]}); a resumed sweep "
           f"ran no stage; kernel launches "
           + ", ".join(f"{k} {v}" for k, v in launches.items())
           + f"; seconds per stage per uid: {table}; wall {wall:.1f} s; "
           f"degraded weights logged: {degraded}")
    return {"launches": launches, "seconds": secs}


def kernels_line(per_shape, serving_launches, train_shapes, fwd_launches,
                 bwd_launches, hg_uniform, hg_rays, gather, gather_main,
                 pixel, recon_launches, sweep_launches) -> dict:
    """The ``kernels`` JSON object from the phases' results: per kernel its
    launches on the main paths (``launches``: the stage-3 training path for
    the RIC kernels, the recon CLI for the rest; ``launches_sweep``: phase
    17's sweep of two uids), error, times, bound and yardstick; the hash
    grid's at the production step on its own ray-ordered points, the
    uniform points' beside; the row gather, which the recon step no longer
    launches, inside the pixel-ray kernel's entry that took its place."""
    def production(rows):
        return next(r for r in rows if r["dtype"] == "bfloat16"
                    and r["n_active"] == HG_ACTIVE[-1])

    prod, uni = production(hg_rays), production(hg_uniform)
    hg_rows = hg_uniform + hg_rays

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
    line = {"kernels": [{
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
        "timed": f"one production step's two encodes at 6 levels, bf16, on "
                 f"the step's own ray-ordered points: {HG_POINTS[1][0]} "
                 f"points, and {HG_POINTS[0][0]} with the jacobian (phase 9 "
                 f"medians); *_uniform: the same on uniform points; {TIMED}",
        "device_ms": prod["enc_device_ms"] + prod["jac_device_ms"],
        "ms_uniform": uni["enc_ms"] + uni["jac_ms"],
        "device_ms_uniform": uni["enc_device_ms"] + uni["jac_device_ms"],
    }, {
        "name": "hashgrid_bwd", "route": "cuda", "source": HG_BWD_SOURCE,
        "replaces": HG_BWD_REPLACES,
        "launches": recon_launches["hashgrid_bwd"],
        "max_abs_err": max(r["bwd_err"] for r in hg_rows),
        "ms": prod["bwd_ms"], "plain_ms": prod["bwd_plain_ms"],
        "bound_ms": hg_bwd_bound[0], "bound_by": hg_bwd_bound[1],
        "library_ms": None,
        "timed": f"one production step's table gradient at 6 levels, bf16 "
                 f"compute, written as the bf16 tables' gradients as the "
                 f"step's backward asks, on the step's own {HG_POINTS[0][0]} "
                 f"ray-ordered points (phase 9 medians); *_uniform: the same "
                 f"on uniform points; {TIMED}",
        "device_ms": prod["bwd_device_ms"],
        "ms_uniform": uni["bwd_ms"],
        "device_ms_uniform": uni["bwd_device_ms"],
        "f64_rel_l2": max(r["bwd_f64"] for r in hg_rows),
        "partial_yardstick": "not the whole function: the scatter alone, "
                             "index_put_(accumulate=True) of the kernel's f32 "
                             "terms under torch.use_deterministic_algorithms"
                             "(True), the terms built before timing",
        "partial_yardstick_ms": prod["scatter_ms"],
        "partial_yardstick_device_ms": prod["scatter_device_ms"],
    }, {
        "name": "pixel_rays", "route": "cuda", "source": PIXEL_SOURCE,
        "replaces": PIXEL_REPLACES, "launches": recon_launches["pixel_rays"],
        "max_abs_err": pixel["err"], "ms": pixel["ms"],
        "plain_ms": pixel["plain_ms"], "bound_ms": pixel["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "timed": f"one recon step's rays and target rows, {pixel['shape']} "
                 f"(phase 10 medians); plain: the twin (eager ops, the rows "
                 f"by tab[idx]); unfused: the same eager ops around the row "
                 f"gather kernel, the step's build before the fused kernel; "
                 f"no one PyTorch call computes the function, so library_ms "
                 f"is null and index_select of the rows alone stands beside "
                 f"as a partial yardstick; {TIMED}",
        "device_ms": pixel["device_ms"],
        "plain_device_ms": pixel["plain_device_ms"],
        "unfused_ms": pixel["unfused_ms"],
        "unfused_device_ms": pixel["unfused_device_ms"],
        "partial_yardstick": "not the whole function: torch.index_select "
                             "of the target rows alone",
        "partial_yardstick_ms": pixel["index_select_ms"],
        "partial_yardstick_device_ms": pixel["index_select_device_ms"],
        "ray_ulps": list(pixel["ulps"]),
    }, {
        "name": "row_gather", "route": "cuda", "source": GATHER_SOURCE,
        "replaces": GATHER_REPLACES, "launches": recon_launches["row_gather"],
        "main_path": "off the recon step since pixel_rays fetches its rows; "
                     "held to tab[idx] in phase 10",
        "max_abs_err": 0.0, "ms": gather[-1][0], "plain_ms": gather[-1][1],
        "bound_ms": gather_bound[0], "bound_by": gather_bound[1],
        "library_ms": gather[-1][2],
        "timed": f"{GATHER_K} rows of a ({GATHER_ROWS[-1]}, 16) bf16 table "
                 f"(phase 10 medians; T={GATHER_ROWS[0]}: {gather[0][0]:.4f} "
                 f"ms, plain {gather[0][1]:.4f} ms); library_ms: "
                 f"torch.index_select; {TIMED}",
        "device_ms": gather[-1][4],
        "main_path_shape": gather_main["shape"],
        "ms_main_path": gather_main["ms"],
        "device_ms_main_path": gather_main["device_ms"],
        "plain_ms_main_path": gather_main["plain_ms"],
        "library_ms_main_path": gather_main["library_ms"],
        "library_device_ms_main_path": gather_main["library_device_ms"],
        "bound_ms_main_path": gather_main["bound_ms"],
    }]}
    for k in line["kernels"]:
        k["launches_sweep"] = sweep_launches[k["name"]]
    return line


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
    t_start = time.time()
    phase_versions()
    phase_build()
    per_shape = phase_kernel_vs_plain(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serving_launches = phase_main_path(root, device)
        phase_whole_frame(root, device)
        train_shapes = phase_bwd_vs_plain(device)
        fwd_launches, bwd_launches = phase_training(root, device)
        phase_step_vs_plain(root, device)
        hg_uniform = phase_hashgrid_vs_plain(device, uniform_points(device),
                                             "uniform")
        gather, gather_main = phase_row_gather(device)
        pixel = phase_pixel_rays(device)
        recon_launches = phase_recon(root, device)
        hg_rays = phase_hashgrid_vs_plain(device, step_points(root, device),
                                          "ray-ordered")
        phase_nsr_step_vs_plain(root, device)
        phase_export_vs_plain(root, device)
        phase_renders(root, device)
        phase_stage1(root, device)
        phase_mv(root, device)
        phase_isnet(root, device)
        sweep_run = phase_sweep(root, device)

    report(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s "
           f"(the builds included)")
    print(json.dumps(kernels_line(
        per_shape, serving_launches, train_shapes, fwd_launches, bwd_launches,
        hg_uniform, hg_rays, gather, gather_main, pixel, recon_launches,
        sweep_run["launches"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

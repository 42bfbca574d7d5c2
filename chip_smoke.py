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
stage 1's outputs, the batch sweep drawing → GIF over two uids,
stage-1 training (train_lama on BiCar renders at full width) and stage 1
with the lama-regular.yaml generator, and last the two per-character
trainings and the latency sweep's training stages data-parallel over
torch.distributed, the FFC generator's training step tensor-parallel
(phase 23), and the toy golden flow on the card judged by the port's
fidelity CLI against the same flow on the CPU (phase 24).
Phases:

  1. versions, and the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (RIC conv forward and backward, hash-grid encode
     and table gradient, row gather, pixel rays, stage-2a attention) and
     the native library, with the build times;
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
     seconds per drawing and the CLI's wall seconds per uid; the cost of
     the reflect pads' one path: ms per drawing at batch 8, device busy
     and launches per forward with models/ffc.py's reflect_pad2d and with
     PyTorch's reflection pad in its place, in one call; then the CLI on
     24 drawings at batch 8 in the overlapped order (batch k+1's forward
     enqueued before batch k's Telea) and with --serial, twice each in
     turns: the PNGs byte-equal, both walls, and the host seconds of
     threshold + Telea + PNG write per drawing inside the CLI;
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
     of pixels, ms per view. Phases 14 and 15 launch none of the
     hand-written kernels; phase 16's bf16 UNet launches the attention
     kernel of 16a;
 16a. stage 2a's attention core (``kernels/csrc/mv_attention.cu``, the
     bf16 flash kernel) at every core shape of one bf16 UNet call of the
     yaml's pipeline (views, domains and cross folds at head dims 40, 80
     and 160; ``benchmark/mv_work.py``'s list): within 2 bf16 ulps of
     max |v| of the plain version (f32 SDPA on the upcast tensors;
     ``output_ulps`` says why 2) and within relative L2 1e-2 over the
     whole output (``output_rel_l2`` says why); per shape
     and summed over a uid's 75 steps the kernel's ms and device ms, the
     plain version's, the library's (SDPA on the same bf16 tensors, the
     backend it picked named) and the bound (its FLOPs at the bf16 peak
     or its bytes, the larger); then one uid through
     ``MVPipeline.images_u8`` under torch.profiler: ``mv.attn.launch``
     equals the views, domains and cross counters and the kernels traced
     (3600), and the uid runs no fused attention kernel of PyTorch's
     beyond CLIP's encode's own;
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
     seconds per stage per uid;
 18. stage-1 training: render/bicar.py renders 8 coloured OBJs (bars and
     spheres from utils/synthetic.py), then cli/train_lama.py trains LaMa's
     FFC ResNet at LamaTrainConfig's full width (ngf 64, 3 downsamplings,
     9 blocks) for 12 steps at batch 8 on 512² crops of 572² loads: every
     loss finite, the mean BCE of the last 5 steps below the first 5's;
     two runs of 2 steps from one seed bit-identical (and, reported only,
     how many tensors differ with PyTorch's reflection pad in place of
     reflect_pad2d); one f32 step on 2
     crops against the same step in float64 on the card (losses within
     relative 1e-4, every gradient within relative L2 1e-2; the
     transposed convolutions' biases, whose exact gradient is 0 under a
     train-mode batch norm, reported apart); the saved step_12.pt loaded
     strictly by the predict CLI on phase 15's drawings; ms per step (host
     clock, the first step excluded), data seconds per batch, device busy
     and launches per step (torch.profiler) and TFLOP/s from the counted
     convolution FLOPs (3 × the forward's);
 19. stage 1 with lama-regular.yaml: the predict CLI with pix2pixHD's
     GlobalGenerator at the yaml's width (ngf 64, 3 downsamplings, 9
     blocks, BN, 4 → 1 sigmoid), seeded weights under the reference's
     names loaded through pretrained.path, on phase 15's 8 drawings: every
     output written with the input's alpha; f32 logits within relative L2
     1e-4 of float64 on the card, thresholded masks differing on < 0.1 %
     of pixels; ms per drawing at batch 8. Phases 18-19 launch none of
     the hand-written kernels;
 20. data parallelism over torch.distributed on the one card, at the
     widths of phases 7 and 11 (configs/neus-ortho.yaml, 2048 rays, six
     1024² views; config_stage1.yaml, 40 × 32² patches): (a) an NCCL
     process group of one rank in this process: 3 dp steps of each
     training bit-identical to 3 plain steps from one state on the same
     draws, with the same kernel launches; (b) two ranks spawned on
     cuda:0 over gloo (which reduces CUDA tensors through the host): one
     dp step of each training, the ranks' parameters, gradients and
     moments bit-identical to each other, and against the two shards
     computed in this process with their gradients averaged by hand and
     one update: losses within relative 1e-5 (NSR, bf16) and 1e-4 (stage
     1), gradients and updates within relative L2 1e-2; the all-reduce's
     bytes a step; (c) run_sweep's recon and train_style stages for one
     uid over those two ranks (phase 17's cuts): done on both, rank 0
     alone writing the OBJ, the checkpoints and the log (every write under
     the data root raises on rank 1), the final parameters bit-identical
     across the ranks, each rank's kernel launches as its steps predict
     (the kernels line's ``launches_dp_ranks``). ms a step at world size
     1 and with the two ranks sharing the card, which is not a scaling
     figure. NCCL across more than one GPU is not run here. (d) Stage 2a's
     batch split (mvdiffusion-joint-ortho-6views.yaml at full width,
     seeded, phase 15's first drawing, 4 denoise steps): under an NCCL
     group of one rank the denoise loop bit-identical to the plain path;
     generate_uid in f32 on two gloo ranks sharing cuda:0 against one
     rank on the same draws: the gathered latents bit-identical across the
     ranks and within relative L2 1e-4 of the one-rank run, the PNGs more
     than 1 apart on < 0.5 % of values, the masks equal, rank 1 writing
     nothing; in bf16, ms a denoise step on one rank and on two, and the
     K/V bytes each rank gathers a step, counted from the UNet's shapes
     and from the gathers;
 21. the recon CLI's multi-uid tail: recon_uid over phase 17's two uids at
     neus-ortho.yaml's widths (mc512, 50 000 faces, the second thinned,
     200 steps), one turn in series and one with each export's host half
     on a one-worker thread beside the next uid's training
     (``drawingspinup_torch/bench/recon_tail.py``'s turn; that module
     alone runs the alternating turns that compare the walls): wall
     seconds, each tail's seconds and how much of the first one ran beside
     the second uid's training, the OBJs byte-equal, the launches equal;
     then the recon CLI on both uids (resumed from their checkpoints,
     mc256) with the first uid's save_mesh raising: ``failed`` names it,
     exit code 1, the second OBJ written;
 22. stage-3 ``compute_dtype="bfloat16"``: a stage-1 step at
     config_stage1.yaml in bf16 against f32 (ms a step on the host clock,
     device busy and launches a step), its loss falling over 20 steps;
     the RIC forward and backward kernels against their twins on
     bf16-rounded inputs at the training shapes (phases 3 and 6's
     limits); a served 512² frame in bf16 against f32 (the share of u8
     values more than 1 apart; the RGB within JAX's own bf16 bounds, max
     0.15 and mean 0.03 of the tanh output; alpha equal);
 23. tensor parallelism (``parallel/tp.py``, JAX's ``shard_params_tp``):
     the dry run's FFC training step at LaMa's full width (27 042 561
     parameters), batch 2 of 256² crops: (a) in an NCCL group of one
     rank, ``make_mesh(1, 1)``, two steps bit-identical to the plain step;
     (b) dp 1 × tp 2 on two gloo ranks sharing cuda:0 in f32, three steps
     (at this width the first Adam step overshoots, the plain step's loss
     too rises at step 2): 13 522 849 parameters a rank, step 3's loss
     below step 1's, each gathered gradient of step 1 no farther
     (relative L2) from the plain float64 step's than max(1.25 × the plain
     f32 step's distance, 1e-5), that distance the larger of the plain
     step's over its two row orders and the 1.25 raised to the plain
     step's own worst ratio between them where that is larger (its
     rounding spread: up to 1.66× on some leaves; the transposed convs'
     zero-gradient biases reported apart), the running statistics
     within relative 1e-5, each rank's collectives as the shapes predict
     (``parallel/dryrun.py::predicted_traffic``); ms a step at tp 1 and 2
     (not a scaling figure: gloo goes through the host), launches and
     busy a step per rank; (c) ``python -m
     drawingspinup_torch.parallel.dryrun --ranks 2 --device cuda:0
     --backend gloo``: the four parts of JAX's ``dryrun_multichip``;
 24. the toy golden flow (``utils/synthetic.py::run_toy_flow``: stage 1 at
     a narrow width and 64², the sphere views, recon at the tiny budget,
     the two-bone rig rendered, three style batches, the GIF) from the
     port's seeded inits on the card and with --device cpu on the card's
     host, every random draw of both made on the CPU (``cpu_draws``), the
     card's tree judged against the CPU's by the port's
     ``cli/fidelity.py`` at ``tests/test_goldens.py``'s cross-run bounds
     (stage-3 images >= 20 dB PSNR, every other image >= 30 dB, mesh
     chamfer <= 2.5e-2, mesh V/F within 10 %, GIF frame counts equal; the
     stage-3 images against stage 3 rerun on the CPU on the card's renders,
     since the toy recon turns the devices' last-bit differences into
     meshes 1.0e-2 apart (chamfer; NVIDIA H100 80GB HBM3, 700.00 W), as
     other draws do, whose renders part stage 3 beyond its bound; the
     flows' own stage-3 PSNR is printed): the
     CPU run takes the kernels' plain versions, so this holds the
     hash-grid and pixel-ray kernels to them at artifact level (the toy
     flow's style generator is GeneratorJ, as in the goldens, and
     launches no RIC kernel); the card's tree against the committed
     goldens (printed, not gated: they started from JAX's init); phase
     17's first uid at production sizes judged against a byte copy of its
     tree (every PSNR inf, every perceptual distance 0, each chamfer that
     of the mesh against its own vertices: JAX's chamfer samples 20 000
     vertices of each side in turn); the
     seconds of each stage on each device and of each judge, and the
     flow's launches (the kernels line's ``launches_golden``).

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
MV_ATTN_ULPS = 2        # phase 16a: kernel vs plain, bf16 ulps of max |v|
MV_ATTN_REL_L2 = 1e-2   # phase 16a: kernel vs plain, relative L2 (both held)
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
# phase 18: LaMa training at full width; phase 19: lama-regular.yaml
LAMA_OBJS = 8
LAMA_STEPS = 12
LAMA_BATCH = 8
LAMA_SIZE = 512
LAMA_F64_BATCH = 2          # the float64 comparison's step: 2 crops of 512²
LAMA_PROFILE_STEPS = 2
LAMA_LOSS_TOL = 1e-4        # the f32 step's losses vs float64
REGULAR_YAML = "drawingspinup_torch/configs/lama-regular.yaml"
# phase 20: data parallelism on the one card: NCCL at world size 1 in
# process, then DP_WORLD spawned gloo ranks sharing cuda:0
DP_WORLD = 2
DP_STEPS = 3            # (a): steps of each training, dp against plain
DP_TIMED = 5            # steps timed after them
DP_JOIN_S = 600         # a rank still running then fails the phase
DP_UID = "dp0"          # (c): made from phase 17's first uid
DP_SWEEP_STAGES = ("recon", "train_style")
DP_NSR_LOSS_TOL = 1e-5  # an NSR step in bf16 against the same path
DP_MV_STEPS = 4         # (d): denoise steps of the split run (the yaml: 75)
DP_MV_TIMED = 3         # (d): bf16 denoise steps timed on one rank and two
DP_MV_REL_L2 = 1e-4     # (d): split latents against one rank, f32
DP_MV_U8_SHARE = 5e-3   # (d): PNG values more than 1 apart
TAIL_STEPS = 200        # phase 21: recon steps a uid (the yaml: 3000)
TAIL_FAIL_MC = 256      # phase 21: the forced failure's export grid
BF16_STEPS = 20         # phase 22: bf16 steps whose loss must fall
# phase 22: a served frame, bf16 vs f32, held to JAX's own bf16 bounds on
# the generator's tanh output (tests/test_stage3.py: max 0.15, mean 0.03)
# in u8 steps of 2/255
BF16_U8_MAX, BF16_U8_MEAN = 0.15 * 127.5, 0.03 * 127.5
# phase 23: the tensor-parallel FFC step at LaMa's full width (cut: batch 2
# of 256² crops against LaMa's 8 of 512², two steps; gloo moves every
# gathered activation through the host)
TP_SIZE = 256
TP_BATCH = 2
TP_PARAMS = 27_042_561          # the full-width generator
TP_PER_RANK = 13_522_849        # its shards at tp 2 (JAX's rule)
TP_STEPS = 3                    # (b): at full width the first Adam step
# overshoots (the plain step's loss too rises at step 2) and step 3's loss
# falls below step 1's
TP_TIMED = 2                    # steps timed after the checked ones
TP_GRAD_FLOOR = 1e-5            # (b): the floor of test_torch_lama.py's rule
# (the plain f32 distance the larger of its two row orders, the factor
# 1.25 or the plain step's own spread between them, if larger)
TP_STAT_TOL = 1e-5              # (b): running statistics vs float64
# phase 15: the overlapped order against --serial
OVERLAP_DRAWINGS = 24
OVERLAP_BATCH = 8
# phase 24: the toy golden flow, judged at tests/test_goldens.py's bounds
GOLDEN_UID = "toy_golden"
GOLDENS_TREE = os.path.join(REPO, "tests", "data", "goldens", "preprocessed")
GOLDEN_STAGE3_DB = 20.0
GOLDEN_DB = 30.0
GOLDEN_CHAMFER = 2.5e-2
GOLDEN_COUNT_TOL = 0.10
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
MV_ATTN_SOURCE = "drawingspinup_torch/kernels/csrc/mv_attention.cu"
MV_ATTN_REPLACES = ("none: the JAX package's attention core is "
                    "jax.nn.dot_product_attention on f32 "
                    "(drawingspinup_tpu/models/attention_mv.py)")
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
BF16_FLOPS = 989.4e12       # bf16 on the tensor cores


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
           f"hash-grid encode and table gradient, row gather, pixel rays, "
           f"stage-2a attention) "
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
    zero_launches()
    t0 = time.time()
    test_stage1.main(args)
    torch.cuda.synchronize()
    t1 = time.time()
    test_stage2.main(args)
    torch.cuda.synchronize()
    t2 = time.time()
    gif_writer.main(args[:4])
    t3 = time.time()
    launches = launch_counts()["ric_conv_fwd"]
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
    graph_frames = phase_frame_graph(models[0], paths, x_u8, got, device)
    with torch.no_grad():
        ms_kernel = cuda_ms(lambda: models[0](x), reps=5)
        with plain_ric_convs():
            ms_plain = cuda_ms(lambda: models[0](x), reps=5)
        ms_stage2 = cuda_ms(lambda: models[1](x), reps=5)
    report(f"[5] whole frame {FRAME}^2: max |kernel - plain| {f32_err:.3e} "
           f"(f32, after tanh), u8 RGB {frac:.3%} of values off by 1, alpha "
           f"exact, {saturated:.1%} of RGB values at 0 or 255; forward "
           f"GeneratorJ_RIC {ms_kernel:.2f} ms (kernel) vs {ms_plain:.2f} ms "
           f"(plain), GeneratorJ {ms_stage2:.2f} ms; {graph_frames} frames "
           f"from the frame graph (one capture), each bit-equal to its "
           f"eager frame")


def phase_frame_graph(model, paths, x_u8, first, device) -> int:
    """The main path's stage-1 generator after its key's two eager frames
    (phase 5's kernel and plain frames): a captured, then replayed frame
    of each of three stacks and of the first again, each bit-equal to the
    eager frame of its stack (``gan.frame_rgba`` called directly; the
    first also to phase 5's eager kernel frame ``first``), one capture, a
    replay a frame and 21 RIC launches a replayed frame; returns the
    frames served."""
    import torch

    from drawingspinup_torch.core import profiling
    from drawingspinup_torch.pipelines import stage3_data
    from drawingspinup_torch.train import gan

    stacks = [x_u8] + [stage3_data.load_full_frame_u8(
        paths.action_dir(ACTIONS[0]), f"{k:04d}.png", False) for k in (2, 3)]
    stacks.append(x_u8)
    with torch.no_grad():
        eager = [gan.frame_rgba(model, torch.from_numpy(s).to(device), True,
                                True, False).cpu().numpy() for s in stacks]
    check(np.array_equal(eager[0], first),
          "frame_rgba differs from the eager served frame")
    before = profiling.counters()
    for k, (s, want) in enumerate(zip(stacks, eager)):
        got = gan.generate_full_rgba(model, s, True, True, False)
        check(np.array_equal(got, want),
              f"frame graph: frame {k} differs from its eager frame "
              f"({int((got != want).sum())} values)")
    c = profiling.counters() - before
    n = len(stacks)
    check(c["serve.graph.capture"] == 1 and c["serve.graph.replay"] == n
          and c["serve.eager"] == 0
          and c["ric.fwd.launch"] == RIC_PER_FRAME * n,
          f"frame graph counters {dict(c)}: expected 1 capture, {n} "
          f"replays, no eager frame, {RIC_PER_FRAME * n} RIC launches")
    return n


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
    zero_launches()
    times = [time.time()]
    for main, argv in runs:
        main(argv)
        torch.cuda.synchronize()
        times.append(time.time())
    launched = launch_counts()
    fwd, bwd = launched["ric_conv_fwd"], launched["ric_conv_bwd"]
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
    from drawingspinup_torch.core import profiling
    from drawingspinup_torch.core.io import read_obj
    from drawingspinup_torch.pipelines import stage2_recon
    from drawingspinup_torch.utils.synthetic import write_sphere_mv

    paths = write_sphere_mv(root, RECON_UID, size=RECON_SIZE)
    cfg = recon_config()
    steps = cfg.max_steps
    zero_launches()
    t0 = time.time()
    recon.main(["--uid", RECON_UID, "--root", root, "--device", str(device),
                *RECON_OVERRIDES])
    torch.cuda.synchronize()
    wall = time.time() - t0
    c = profiling.counters()
    enc, enc_jac = c["hashgrid.fwd.launch"], c["hashgrid.fwd_jac.launch"]
    grad, rays = c["hashgrid.bwd.launch"], c["pixel_rays.launch"]
    gather = c["row_gather.launch"]
    launches = {"hashgrid_fwd": enc + enc_jac, "hashgrid_bwd": grad,
                "row_gather": gather, "pixel_rays": rays}
    stats = stage2_recon.LAST_STATS
    evals = stats["export"]["field_evals"]
    check(enc_jac == steps and grad == steps and enc == steps + evals
          and rays == steps and gather == 0,
          f"recon launches: encode {enc}, with jacobian {enc_jac}, table "
          f"gradient {grad}, pixel rays {rays}, row gather {gather}; "
          f"expected "
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
        # the pads' one path (reflect_pad2d, for the training step's
        # deterministic backward) against PyTorch's reflection pad, in
        # this call: shipped, F.pad, F.pad, shipped
        pad_ms = {"reflect_pad2d": [], "F.pad": []}
        for name in ("reflect_pad2d", "F.pad", "F.pad", "reflect_pad2d"):
            with (torch_reflect_pads() if name == "F.pad"
                  else contextlib.nullcontext()):
                pad_ms[name].append(cuda_ms(lambda: card(xd8), reps=5)
                                    / DRAWINGS)
        pad_prof = {}
        for name in pad_ms:
            with (torch_reflect_pads() if name == "F.pad"
                  else contextlib.nullcontext()):
                pad_prof[name] = device_profile(
                    lambda: card(xd8), 2, os.path.join(root, "stage1_trace"))
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
    pad_note = "; ".join(
        f"{n} {np.mean(v):.2f} ms per drawing at batch {DRAWINGS} "
        f"({', '.join(f'{t:.2f}' for t in v)}), device busy "
        f"{pad_prof[n][0]:.2f} ms and {pad_prof[n][1]:.0f} launches a "
        f"forward" for n, v in pad_ms.items())
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
           f"{fft_note}; the reflect pads, in this call: {pad_note}; "
           f"threshold + Telea "
           f"{telea_s:.3f} host s per drawing; CLI wall {cli_s:.2f} s per "
           f"uid (checkpoint load and first-call set-up included); CPU "
           f"float64 forward {t64:.1f} s")
    phase_stage1_overlap(root, device, yaml, ckpt, ms8)


def phase_stage1_overlap(root: str, device, yaml: str, ckpt: str,
                         fwd_ms: float) -> None:
    """Phase 15's second part: the predict CLI on OVERLAP_DRAWINGS drawings
    at batch OVERLAP_BATCH in the overlapped order (the default) and with
    --serial, in turns (overlap, serial, serial, overlap), each on its own
    copy of the drawings: every PNG byte-equal across the four runs; the
    walls of ``predict_uids`` and its host seconds of threshold + Telea +
    PNG write per drawing. ``fwd_ms``: ms of the forward per drawing at
    batch DRAWINGS (CUDA events)."""
    from drawingspinup_torch.cli import predict
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.pipelines import stage1

    runs = {"overlap": [], "serial": []}
    pngs = []
    for turn, order in enumerate(("overlap", "serial", "serial", "overlap")):
        sub = os.path.join(root, f"stage1_{order}_{turn}")
        uids = write_drawings(sub, OVERLAP_DRAWINGS, DRAWING_SIZE,
                              SEED + 410)
        lst = os.path.join(sub, "uids.json")
        with open(lst, "w") as f:
            json.dump(uids, f)
        with contextlib.redirect_stdout(sys.stderr):
            rc = predict.main([yaml, f"pretrained.path={ckpt}",
                               f"uid_json={lst}", "--root", sub,
                               "--device", str(device), "--batch-size",
                               str(OVERLAP_BATCH), "--size",
                               str(DRAWING_SIZE)]
                              + (["--serial"] if order == "serial" else []))
        check(rc == 0, f"predict {order}: exit code {rc}")
        check(stage1.LAST_STATS["drawings"] == OVERLAP_DRAWINGS,
              f"predict {order}: {stage1.LAST_STATS}")
        runs[order].append(dict(stage1.LAST_STATS))
        blobs = []
        for u in uids:
            with open(UidPaths(sub, u).inpainted, "rb") as f:
                blobs.append(f.read())
        pngs.append(blobs)
    differ = [i for i in range(OVERLAP_DRAWINGS)
              if len({run[i] for run in pngs}) != 1]
    check(not differ, f"stage 1 overlap: the PNGs of drawings {differ} "
                      f"differ between the orders or the turns")
    batches = -(-OVERLAP_DRAWINGS // OVERLAP_BATCH)
    walls = {k: [r["wall_s"] for r in v] for k, v in runs.items()}
    post = {k: [r["post_s"] / OVERLAP_DRAWINGS for r in v]
            for k, v in runs.items()}
    telea_batch = np.mean(post["serial"]) * OVERLAP_BATCH
    fwd_batch = fwd_ms / 1e3 * OVERLAP_BATCH
    predicted = min(telea_batch, fwd_batch) * (batches - 1)
    saved = np.mean(walls["serial"]) - np.mean(walls["overlap"])
    report(f"[15] stage 1 overlap: predict on {OVERLAP_DRAWINGS} drawings "
           f"of {DRAWING_SIZE}^2 at batch {OVERLAP_BATCH} ({batches} "
           f"batches), turns overlap, serial, serial, overlap: every PNG "
           f"byte-equal across the four runs; predict_uids wall overlapped "
           f"{', '.join(f'{w:.3f}' for w in walls['overlap'])} s, serial "
           f"{', '.join(f'{w:.3f}' for w in walls['serial'])} s (saved "
           f"{saved:.3f} s; predicted min(Telea a batch {telea_batch:.3f} "
           f"s, forward a batch {fwd_batch:.3f} s) x {batches - 1} = "
           f"{predicted:.3f} s); threshold + Telea + PNG write host s per "
           f"drawing overlapped "
           f"{', '.join(f'{t:.4f}' for t in post['overlap'])}, serial "
           f"{', '.join(f'{t:.4f}' for t in post['serial'])}")


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



def sdpa_backend(q, k, v) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these
    (B, heads, S, d) tensors (PyTorch's own dispatch rule)."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v)).name


def attention_kernel_counts(fn) -> tuple:
    """(launches of the hand-written attention kernel, of PyTorch's fused
    attention kernels (names with fmha or flash)) over one call of
    ``fn``, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ours = lib = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        ours += e.count if "mv_attention_kernel" in name else 0
        lib += e.count if "fmha" in name or "flash" in name else 0
    return ours, lib


def phase_mv_attention(device, reps: int = 10) -> dict:
    """Stage 2a's attention core (``kernels/mv_attention.py``, the bf16
    flash kernel) at the main path's shapes: every core of one bf16 UNet
    call against the plain version (f32 SDPA on the upcast tensors) within
    ``MV_ATTN_ULPS`` bf16 ulps of max |v| (``output_ulps``) and
    ``MV_ATTN_REL_L2`` over the whole output (``output_rel_l2``), the cores
    those of ``benchmark/mv_work.py``'s list; per shape the
    kernel's, the plain version's and the library's times (SDPA on the same
    bf16 tensors, with the backend it picked named) beside the bound; then
    one uid through ``MVPipeline.images_u8``: ``mv.attn.launch`` equals the
    views, domains and cross counters (3600 at 75 steps), the profiler
    sees the kernel that many times, and no fused attention kernel of
    PyTorch's beyond CLIP's own."""
    import torch
    import torch.nn.functional as F

    from benchmark import mv_work
    from drawingspinup_torch.core import profiling
    from drawingspinup_torch.kernels import mv_attention as mk
    from drawingspinup_torch.pipelines import stage2_mv as mv

    cfg = mv.MVPipelineConfig()
    pipe = mv.MVPipeline.init_random(cfg, MV_SEED, device)
    # {(B, Sq, Sk, C): calls a UNet forward}: the list the card tests take,
    # which a CPU test holds to the UNet's own calls at the yaml's config
    cores: dict = {}
    with open(os.path.join(REPO, "benchmark", "configs",
                           "wonder3d_mv.json")) as f:
        for a in mv_work.attention_cores(json.load(f)):
            key = (a.b, a.sq, a.sk, a.c)
            cores[key] = cores.get(key, 0) + 1
    steps = cfg.num_inference_steps
    heads = cfg.unet.attention_heads
    rows, g = [], torch.Generator(device=device).manual_seed(MV_SEED + 4)
    for (b, sq, sk, c), calls in sorted(cores.items()):
        q = (2 * torch.randn((b, sq, c), generator=g, device=device)
             ).bfloat16()
        k = torch.randn((b, sk, c), generator=g, device=device).bfloat16()
        v = torch.randn((b, sk, c), generator=g, device=device).bfloat16()
        got = mk.mv_attention(q, k, v, heads)
        want = mk.attention_reference(q, k, v, heads)
        ulps = mk.output_ulps(got, want, v, heads)
        rel = mk.output_rel_l2(got, want)
        check(ulps <= MV_ATTN_ULPS and rel <= MV_ATTN_REL_L2,
              f"[16a] mv_attention at {(b, sq, sk, c)}: {ulps} ulps "
              f"(limit {MV_ATTN_ULPS}), relative L2 {rel:.3e} (limit "
              f"{MV_ATTN_REL_L2:g}) from the plain version")
        d = c // heads

        def split(t, s):
            return t.view(b, s, heads, d).transpose(1, 2)

        qh, kh, vh = split(q, sq), split(k, sk), split(v, sk)

        def library():
            F.scaled_dot_product_attention(qh, kh, vh)

        flops = 4.0 * b * sq * sk * c
        nbytes = 2.0 * b * c * 2 * (sq + sk)
        bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
        rows.append({
            "shape": [b, sq, sk, c], "calls_per_uid": calls * steps,
            "ulps": ulps, "rel_l2": rel,
            "ms": cuda_ms(lambda: mk.mv_attention(q, k, v, heads), reps),
            "device_ms": device_ms(lambda: mk.mv_attention(q, k, v, heads),
                                   reps),
            "plain_ms": cuda_ms(
                lambda: mk.attention_reference(q, k, v, heads), reps),
            "library_ms": cuda_ms(library, reps),
            "library_device_ms": device_ms(library, reps),
            "library_backend": sdpa_backend(qh, kh, vh),
            "bound_ms": bound, "bound_by": by, "tflops": 0.0})
        rows[-1]["tflops"] = flops / rows[-1]["device_ms"] / 1e9

    def per_uid(key: str) -> float:
        """ms a uid: each core's ms times its calls a uid."""
        return sum(r["calls_per_uid"] * r[key] for r in rows)

    # one uid: the counters and the profiler's kernels
    h = w = cfg.image_size
    yy, xx = np.mgrid[:h, :w]
    blob = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.3 * h) ** 2)
    rgb = np.random.default_rng(MV_SEED).uniform(0.2, 0.8, (h, w, 3))
    drawing = torch.from_numpy(np.where(blob[..., None], rgb, 1.0)
                               .astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(MV_SEED + 5)
    pipe.images_u8(drawing, generator=gen)          # warm
    torch.cuda.synchronize()
    _, clip_lib = attention_kernel_counts(lambda: pipe.encode_image(drawing))
    before = profiling.counters()
    ours, lib = attention_kernel_counts(
        lambda: pipe.images_u8(drawing, generator=gen))
    after = profiling.counters()

    def moved(name: str) -> int:
        return after.get(name, 0) - before.get(name, 0)

    folds = sum(moved(f"mv.attn.{k}") for k in ("views", "domains",
                                                  "cross", "self"))
    cores_per_uid = sum(cores.values()) * steps
    check(moved(mk.LAUNCHES) == folds == cores_per_uid == ours,
          f"[16a] one uid: {moved(mk.LAUNCHES)} mv.attn.launch, {folds} "
          f"attention calls, {ours} kernels in the profiler, "
          f"{cores_per_uid} cores expected")
    check(lib == clip_lib,
          f"[16a] one uid ran {lib} fused attention kernels of PyTorch's, "
          f"CLIP's encode alone {clip_lib}: the UNet reached SDPA")
    lines = "; ".join(
        f"{tuple(r['shape'])} x{r['calls_per_uid']}: {r['ms']:.3f} ms "
        f"({r['device_ms']:.3f} device, {r['tflops']:.0f} TFLOP/s), plain "
        f"{r['plain_ms']:.3f}, SDPA bf16 {r['library_ms']:.3f} "
        f"({r['library_backend']}), "
        f"bound {r['bound_ms']:.4f} ({r['bound_by']}), {r['ulps']} ulps, "
        f"relative L2 {r['rel_l2']:.3e}"
        for r in rows)
    report(f"[16a] stage 2a attention core, bf16 flash kernel against the "
           f"plain version (f32 SDPA) within {MV_ATTN_ULPS:g} ulps and "
           f"relative L2 {MV_ATTN_REL_L2:g} at every core of a bf16 UNet "
           f"call (B, Sq, Sk, C; {heads} heads; the list of "
           f"benchmark/mv_work.py): "
           f"{lines}; ms a uid ({steps} steps): kernel {per_uid('ms'):.1f} "
           f"({per_uid('device_ms'):.1f} device), plain "
           f"{per_uid('plain_ms'):.1f}, SDPA bf16 {per_uid('library_ms'):.1f}"
           f" ({per_uid('library_device_ms'):.1f} device), bound "
           f"{per_uid('bound_ms'):.1f}; one uid: mv.attn.launch "
           f"{moved(mk.LAUNCHES)} = views + domains + cross {folds} = "
           f"kernels traced {ours}; fused attention kernels of PyTorch's "
           f"{lib} (CLIP's encode alone: {clip_lib})")
    return {"rows": rows, "launches": moved(mk.LAUNCHES),
            "ms": per_uid("ms"), "device_ms": per_uid("device_ms"),
            "plain_ms": per_uid("plain_ms"),
            "library_ms": per_uid("library_ms"),
            "library_device_ms": per_uid("library_device_ms"),
            "bound_ms": per_uid("bound_ms"),
            "max_ulps": max(r["ulps"] for r in rows)}


def phase_sweep(root: str, device) -> dict:
    """Two uids through ``run_sweep`` with ``cli/sweep.py``'s stage
    functions, drawing to GIF; returns the kernel launches of that run and
    the seconds per stage per uid."""
    import torch

    from drawingspinup_torch.cli import sweep as sweep_cli
    from drawingspinup_torch.core import profiling
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.core.io import read_image, write_image
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
    zero_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        # no resume on this first run: train_style's eval writes the
        # res_stage frames by which a resumed sweep counts test_style done
        result = sweep.run_sweep(root, uids,
                                 {s: fns[s] for s in SWEEP_STAGES},
                                 resume=False, log_path=log)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    enc = profiling.counters()["hashgrid.fwd.launch"]
    enc_jac = profiling.counters()["hashgrid.fwd_jac.launch"]
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
          and enc_jac == n * steps
          and enc > n * steps
          and launches["row_gather"] == 0,
          f"sweep launches {launches} (encode without the jacobian "
          f"{enc}); expected RIC forward {want_fwd}, backward "
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


def zero_launches() -> None:
    """Every hand-written kernel's launch count set to 0: the counters (and
    span aggregates) of core/profiling.py cleared."""
    from drawingspinup_torch.core import profiling

    profiling.reset()


def launches_total() -> int:
    return sum(launch_counts().values())


def check_drawings(root: str, uids, what: str) -> None:
    """Every drawing's ffc_resnet_inpainted.png written, alpha equal to the
    input's."""
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.core.io import read_image_u8

    for u in uids:
        p = UidPaths(root, u)
        check(os.path.exists(p.inpainted), f"{what}: no {p.inpainted}")
        out, tex = read_image_u8(p.inpainted), read_image_u8(p.texture)
        check(out.shape == (DRAWING_SIZE, DRAWING_SIZE, 4)
              and np.array_equal(out[..., 3], tex[..., 3]),
              f"{what}: {p.inpainted}: shape {out.shape} or alpha differs "
              f"from the input's")


def device_profile(run, steps: int, logdir: str):
    """(device busy ms, kernel launches) per call of ``run`` over
    ``steps`` calls, from core/profiling.py's torch.profiler trace."""
    import torch

    from drawingspinup_torch.core import profiling

    torch.cuda.synchronize()
    with profiling.trace(logdir) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    return busy, sum(e.count for e in kernels) / steps


@contextlib.contextmanager
def torch_reflect_pads():
    """models/ffc.py's reflect pads (pix2pixHD's too) as PyTorch's own
    ``F.pad(mode="reflect")``, whose CUDA backward adds with atomics, in
    place of ``reflect_pad2d``: the yardstick of phases 15 and 18."""
    import torch.nn.functional as F

    from drawingspinup_torch.models import ffc

    shipped = ffc.reflect_pad2d
    ffc.reflect_pad2d = lambda x, ph, pw: F.pad(x, (pw, pw, ph, ph),
                                                mode="reflect")
    try:
        yield
    finally:
        ffc.reflect_pad2d = shipped


def phase_lama_train(root: str, device) -> None:
    """BiCar renders, then the train_lama CLI at full width; losses,
    bit-identity, f32 against float64, the saved generator in predict;
    ms per step, data s per batch, device busy and launches, TFLOP/s."""
    import torch

    from drawingspinup_torch.cli import predict, train_lama
    from drawingspinup_torch.core import profiling
    from drawingspinup_torch.pipelines.stage1_data import BiCarDataset
    from drawingspinup_torch.train import lama
    from drawingspinup_torch.utils.synthetic import write_bicar_objs

    obj_root, data, out = (os.path.join(root, d) for d in
                           ("lama_objs", "lama_data", "lama_run"))
    uids = write_bicar_objs(obj_root, LAMA_OBJS, SEED + 1800)
    uid_json = os.path.join(root, "lama_uids.json")
    with open(uid_json, "w") as f:
        json.dump(uids, f)

    # the CLI's own steps, their losses kept (read after the run)
    logs, step_fn = [], lama.train_step

    def recorded(cfg, state, batch):
        state, step_logs = step_fn(cfg, state, batch)
        logs.append(step_logs)
        return state, step_logs

    lama.train_step = recorded
    zero_launches()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            train_lama.main(["--data-root", data, "--uid-json", uid_json,
                             "--out", out, "--steps", str(LAMA_STEPS),
                             "--batch-size", str(LAMA_BATCH),
                             "--size", str(LAMA_SIZE), "--render", obj_root,
                             "--device", str(device), "--seed", str(SEED)])
    finally:
        lama.train_step = step_fn
    wall = time.time() - t0
    check(launches_total() == 0, "train_lama launched a hand-written kernel")
    saved = json.loads(buf.getvalue().strip().splitlines()[-1])["saved"]
    check(os.path.exists(saved), f"train_lama wrote no {saved}")
    bce = [float(x["bce"]) for x in logs]
    check(len(logs) == LAMA_STEPS and all(
        math.isfinite(float(v)) for x in logs for v in x.values()),
        f"train_lama: {len(logs)} steps, losses {logs}")
    check(np.mean(bce[-5:]) < np.mean(bce[:5]),
          f"train_lama: the BCE did not fall: {bce}")
    render_s = profiling.samples("train_lama/render")[0]
    data_s = float(np.mean(profiling.samples("train_lama/data")))
    steps_s = profiling.samples("train_lama/step")
    step_ms = 1e3 * float(np.mean(steps_s[1:]))

    # two runs of two steps from one seed: bit-identical
    cfg = lama.LamaTrainConfig(batch_size=LAMA_BATCH)
    it = BiCarDataset(data, uid_json, "train", seed=SEED + 1,
                      crop_size=LAMA_SIZE,
                      load_size=int(LAMA_SIZE * 572 / 512)).batches(
        LAMA_BATCH)
    batches = [next(it) for _ in range(2)]

    def two_runs():
        """The generator tensors that differ between two runs of the
        two steps from one seed, and the state of the last run."""
        runs = []
        for _ in range(2):
            state = lama.init_state(cfg, torch.Generator().manual_seed(SEED),
                                    size=LAMA_SIZE, device=device)
            for b in batches:
                state, _ = lama.train_step(cfg, state, b)
            runs.append({k: v.clone() for k, v in
                         state.generator.state_dict().items()})
        return [k for k in runs[0]
                if not torch.equal(runs[0][k], runs[1][k])], state

    # the yardstick, reported only: whether F.pad's atomics reorder a sum
    # in a given run is not fixed
    with torch_reflect_pads():
        fpad_differ = len(two_runs()[0])
    differ, state = two_runs()
    check(not differ, f"train_lama: two runs from one seed differ in "
                      f"{len(differ)} tensors, e.g. {differ[:4]}")
    n_tensors = len(state.generator.state_dict())

    # device busy and launches per step, on the warm state
    busy, n_launch = device_profile(
        lambda: lama.train_step(cfg, state, batches[0]),
        LAMA_PROFILE_STEPS, os.path.join(root, "lama_trace"))
    x1 = lama.batch_tensors(batches[0], next(state.generator.parameters())
                            )[0][:1]
    flops = 3 * conv_flops(copy.deepcopy(state.generator).eval(), x1)

    # one step in f32 and in float64 from one state, on LAMA_F64_BATCH crops
    small = {k: v[:LAMA_F64_BATCH] for k, v in batches[1].items()}
    grads, losses = [], []
    for dtype in (torch.float32, torch.float64):
        st = lama.init_state(cfg, torch.Generator().manual_seed(SEED + 2),
                             size=LAMA_SIZE, device=device)
        st.generator.to(dtype)
        st.g_opt = lama.make_optimizer(st.generator, cfg.lr)
        st, step_logs = lama.train_step(cfg, st, small)
        losses.append({k: float(v) for k, v in step_logs.items()})
        grads.append({n: p.grad.double() for n, p in
                      st.generator.named_parameters()})
        del st
    layers = list(state.generator.model)
    zero_grad = {f"model.{i}.bias" for i, m in enumerate(layers[:-1])
                 if isinstance(m, torch.nn.ConvTranspose2d)}
    loss_rel = max(abs(losses[0][k] - losses[1][k]) / abs(losses[1][k])
                   for k in ("g_loss", "bce", "dice"))
    rel = {n: float((g - grads[1][n]).norm() / grads[1][n].norm())
           for n, g in grads[0].items() if n not in zero_grad}
    worst = max(rel, key=rel.get)
    check(loss_rel <= LAMA_LOSS_TOL,
          f"train_lama f32 vs float64: losses {losses}")
    check(rel[worst] <= GRAD_REL_TOL,
          f"train_lama f32 vs float64: gradient {worst} relative L2 "
          f"{rel[worst]:.3e} > {GRAD_REL_TOL:g}")
    zero_norms = {n: (float(grads[0][n].norm()), float(grads[1][n].norm()))
                  for n in sorted(zero_grad)}

    # the trained generator, strictly loaded by the predict CLI
    drawings = os.path.join(root, "drawing_uids.json")
    with open(drawings) as f:
        duids = json.load(f)
    with contextlib.redirect_stdout(sys.stderr):
        predict.main([os.path.join(REPO, LAMA_YAML),
                      f"pretrained.path={saved}", f"uid_json={drawings}",
                      "--root", root, "--device", str(device),
                      "--batch-size", str(DRAWINGS),
                      "--size", str(DRAWING_SIZE)])
    check_drawings(root, duids, "predict with the trained LaMa")
    check(launches_total() == 0, "phase 18 launched a hand-written kernel")
    report(f"[18] stage-1 training: train_lama on {LAMA_OBJS} BiCar renders "
           f"(render/bicar.py, {render_s:.2f} s), LamaTrainConfig at full "
           f"width ({sum(p.numel() for p in state.generator.parameters()) / 1e6:.1f} M "
           f"generator parameters), {LAMA_STEPS} steps at batch {LAMA_BATCH} "
           f"of {LAMA_SIZE}^2 crops: losses finite, BCE first 5 "
           f"{np.mean(bce[:5]):.4f} -> last 5 {np.mean(bce[-5:]):.4f} "
           f"(per step {', '.join(f'{b:.4f}' for b in bce)}); two runs of 2 "
           f"steps bit-identical (with PyTorch's reflection pad in place of "
           f"reflect_pad2d, {fpad_differ} of {n_tensors} generator tensors "
           f"differ); f32 vs float64 on the card "
           f"({LAMA_F64_BATCH} crops): losses within {loss_rel:.2e} "
           f"(limit {LAMA_LOSS_TOL:g}), gradients within relative L2 "
           f"{rel[worst]:.2e} (limit {GRAD_REL_TOL:g}; worst {worst}; median "
           f"{np.median(list(rel.values())):.2e}), the transposed convs' "
           f"biases (exact gradient 0) |g| f32/f64 "
           + ", ".join(f"{n} {a:.1e}/{b:.1e}"
                       for n, (a, b) in zero_norms.items())
           + f"; {os.path.basename(saved)} loaded strictly by predict on "
           f"{len(duids)} drawings; {step_ms:.1f} ms per step (host clock, "
           f"synchronised, the first step of {steps_s[0] * 1e3:.0f} ms "
           f"excluded), data {data_s:.3f} s per batch (host), device busy "
           f"{busy:.1f} ms and {n_launch:.0f} launches per step "
           f"(torch.profiler), {flops * LAMA_BATCH / step_ms / 1e9:.1f} "
           f"TFLOP/s ({flops / 1e9:.1f} GFLOP of convolutions per crop and "
           f"step, 3 x the forward's); CLI wall {wall:.1f} s")


def phase_lama_regular(root: str, device) -> None:
    """The predict CLI with lama-regular.yaml (pix2pixHD's GlobalGenerator)
    at full width on phase 15's drawings; f32 against float64 on the card;
    ms per drawing."""
    import torch

    from drawingspinup_torch.cli import predict
    from drawingspinup_torch.core.config import load_config
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.pipelines import stage1

    yaml = os.path.join(REPO, REGULAR_YAML)
    lst = os.path.join(root, "drawing_uids.json")
    with open(lst) as f:
        uids = json.load(f)
    inputs = [stage1.load_input(UidPaths(root, u), DRAWING_SIZE)
              for u in uids]
    x8 = torch.from_numpy(np.concatenate(
        [np.stack([i[0] for i in inputs]), np.stack([i[1] for i in inputs])],
        axis=-1)).permute(0, 3, 1, 2).contiguous()
    thr = math.log(stage1.CONTOUR_THRESHOLD
                   / (1 - stage1.CONTOUR_THRESHOLD))
    # seeded weights, the head rescaled as in phase 15
    model = stage1.build_generator(load_config(yaml))
    predict.seeded_init(model, SEED + 1900)
    model.to(device)
    with torch.no_grad():
        y = model.logits(x8[:1].to(device))
        head = model.model[-1]
        k = 2.0 / y.std()
        head.weight.mul_(k)
        head.bias.copy_(k * (head.bias - y.mean()) + thr)
    ckpt = os.path.join(root, "lama_regular_seeded.pth")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    zero_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        predict.main([yaml, f"pretrained.path={ckpt}", f"uid_json={lst}",
                      "--root", root, "--device", str(device),
                      "--batch-size", str(DRAWINGS),
                      "--size", str(DRAWING_SIZE)])
    torch.cuda.synchronize()
    cli_s = (time.time() - t0) / len(uids)
    check(launches_total() == 0, "phase 19 launched a hand-written kernel")
    check_drawings(root, uids, "predict with lama-regular.yaml")

    cfg = load_config(yaml, [f"pretrained.path={ckpt}"])
    card = stage1.build_generator(cfg)
    predict.load_weights(card, cfg, SEED)
    c64 = copy.deepcopy(card).double().to(device)
    card.to(device)
    x1 = x8[:1].to(device)
    with torch.inference_mode():
        y32 = card.logits(x1).double()
        y64 = c64.logits(x1.double())
    check(bool(torch.isfinite(y32).all()), "lama-regular: non-finite logits")
    rel = ((y32 - y64).norm() / y64.norm()).item()
    mask_off = ((y32 > thr) != (y64 > thr)).double().mean().item()
    contour = (y64 > thr).double().mean().item()
    check(rel <= LOGIT_REL_L2,
          f"lama-regular logits f32 vs float64: relative L2 {rel:.3e} > "
          f"{LOGIT_REL_L2:g}")
    check(mask_off < MASK_SHARE,
          f"lama-regular contour masks differ on {mask_off:.4%} of pixels")
    del c64
    xd8 = x8.to(device)
    with torch.inference_mode():
        ms8 = cuda_ms(lambda: card(xd8), reps=5) / DRAWINGS
    flops = conv_flops(card, x1)
    report(f"[19] stage 1 with lama-regular.yaml: predict on {len(uids)} "
           f"drawings of {DRAWING_SIZE}^2, pix2pixHD's GlobalGenerator at "
           f"the yaml's width ({sum(p.numel() for p in card.parameters()) / 1e6:.1f} M "
           f"parameters, seeded, reference names, loaded through "
           f"pretrained.path): every output written, alpha equal to the "
           f"input's; logits f32 vs float64 on the card relative L2 "
           f"{rel:.3e} (limit {LOGIT_REL_L2:g}), masks differ on "
           f"{mask_off:.4%} of pixels ({contour:.1%} contour); forward "
           f"{ms8:.2f} ms per drawing at batch {DRAWINGS} (CUDA events; "
           f"{flops / 1e9:.1f} GFLOP a drawing, {flops / ms8 / 1e9:.1f} "
           f"TFLOP/s); CLI wall {cli_s:.2f} s per uid")


# ---------------------------------------------------------------------------
# phase 20: data parallelism over torch.distributed on the one card
# ---------------------------------------------------------------------------

def dp_nsr(root: str, device):
    """(config, data, n_active at step 0) of the production NSR step on
    phase 11's sphere uid."""
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.pipelines import stage2_data

    cfg = recon_config()
    data = stage2_data.load_ortho_data(
        UidPaths(root, RECON_UID), im_size=RECON_SIZE,
        hull_trange=cfg.hull_trange, radius=cfg.radius, device=device)
    return cfg, data, cfg.sdf.grid.current_level(0)


def dp_gan(root: str, device):
    """(config, keyframe) of the production stage-1 step on phase 7's
    uid."""
    from drawingspinup_torch.core.contract import UidPaths

    return stage_config(1), keyframe(UidPaths(root, TRAIN_UID), 1, device)


def host_copy(t):
    return None if t is None else t.detach().to("cpu", copy=True)


def nsr_snapshot(state) -> dict:
    """A CPU copy of an NSR state's parameters, gradients and moments."""
    from drawingspinup_torch.train import nsr

    leaves = list(nsr.named_leaves(state.params))
    return {"params": {n: host_copy(p) for n, p in leaves},
            "grads": {n: host_copy(p.grad) for n, p in leaves},
            "mu": {n: host_copy(v) for n, v in state.opt_state.mu.items()},
            "nu": {n: host_copy(v) for n, v in state.opt_state.nu.items()}}


def gan_snapshot(state, stepped: bool = True) -> dict:
    """A CPU copy of a stage-3 state: G's and D's parameters and buffers,
    and once it has ``stepped`` their gradients and both optimizers'
    moments."""
    out = {}
    for part, module, opt in (("gen", state.gen, state.g_opt),
                              ("disc", state.disc, state.d_opt)):
        out[part] = {k: host_copy(v) for k, v in module.state_dict().items()}
        if stepped:
            out[f"{part}_grads"] = {k: host_copy(p.grad)
                                    for k, p in module.named_parameters()}
            out[f"{part}_moments"] = {
                f"{k}.{m}": host_copy(opt.state[p][m])
                for k, p in module.named_parameters()
                for m in ("exp_avg", "exp_avg_sq")}
    return out


def same_bits(a: dict, b: dict) -> list:
    """Names of the tensors of two snapshots that are not bit-identical."""
    import torch

    bad = []
    for part, tensors in a.items():
        for n, v in tensors.items():
            w = b[part][n]
            if v is None or w is None:
                same = v is None and w is None
            else:
                same = v.dtype == w.dtype and torch.equal(v, w)
            if not same:
                bad.append(f"{part}.{n}")
    return bad


def rel_l2(got, want) -> float:
    want = want.double()
    n = want.norm().item()
    d = (got.double() - want).norm().item()
    return d / n if n else d


def phase_dp_world1(root: str, device, tmp: str) -> dict:
    """(a) NCCL at world size 1 in this process: DP_STEPS steps of each
    training by the dp step against the plain step from one state on the
    same draws, bit-identical, with the same kernel launches; ms a step of
    each (host synchronised)."""
    import functools

    import torch
    import torch.distributed as dist

    from drawingspinup_torch.parallel import mesh
    from drawingspinup_torch.train import gan, gan_parallel, nsr, \
        nsr_parallel

    rank, world, _ = mesh.init_dp(device, backend="nccl",
                                  init_method=f"file://{tmp}/nccl_store")
    check((rank, world, dist.get_backend()) == (0, 1, "nccl"),
          f"NCCL group: rank {rank}, world {world}, {dist.get_backend()}")
    try:
        cfg, data, _ = dp_nsr(root, device)
        v, h, w = data["masks"].shape
        gcfg, kf = dp_gan(root, device)
        runs = {}
        for dp in (False, True):
            opt = nsr.make_optimizer(cfg)
            state = nsr.init_state(cfg, SEED, device)
            fn = nsr_parallel.make_train_step_dp(cfg, opt, world) if dp \
                else functools.partial(nsr.train_step, cfg, opt)
            g = torch.Generator(device=device).manual_seed(SEED + 1)

            def nsr_step():
                draws = nsr.make_draws(cfg, v, h, w, g, device)
                return fn(state, data, draws, n_active=cfg.sdf.grid
                          .current_level(state.step))

            zero_launches()
            logs = [nsr_step() for _ in range(DP_STEPS)]
            torch.cuda.synchronize()
            nsr_launches = launch_counts()
            snap = nsr_snapshot(state)
            snap["logs"] = {f"{i}.{k}": host_copy(x)
                            for i, lg in enumerate(logs)
                            for k, x in lg.items()}
            nsr_ms = host_ms(nsr_step, DP_TIMED)

            gstate = gan.init_state(gcfg, device, SEED)
            gfn = gan_parallel.make_train_step_dp(gcfg, world) if dp \
                else functools.partial(gan.train_step, gcfg)
            gg = torch.Generator(device=device).manual_seed(SEED + 1)
            zero_launches()
            glogs = [gfn(gstate, kf, gg) for _ in range(DP_STEPS)]
            torch.cuda.synchronize()
            gan_launches = launch_counts()
            gsnap = gan_snapshot(gstate)
            gsnap["logs"] = {f"{i}.{k}": host_copy(x)
                             for i, lg in enumerate(glogs)
                             for k, x in lg.items()}
            gan_ms = host_ms(lambda: gfn(gstate, kf, gg), DP_TIMED)
            runs[dp] = (snap, nsr_launches, nsr_ms, gsnap, gan_launches,
                        gan_ms)
    finally:
        dist.destroy_process_group()
    (ns, nl, nms, gs, gl, gms), (ns1, nl1, nms1, gs1, gl1, gms1) = \
        runs[False], runs[True]
    bad = same_bits(ns, ns1) + same_bits(gs, gs1)
    check(not bad, f"[20a] dp steps at world 1 differ from the plain steps: "
                   f"{bad[:8]}")
    check(nl == nl1 and gl == gl1 and nl["pixel_rays"] == DP_STEPS
          and gl["ric_conv_bwd"] == BWD_PER_STEP * DP_STEPS,
          f"[20a] launches: NSR plain {nl}, dp {nl1}; stage 3 plain {gl}, "
          f"dp {gl1}")
    report(f"[20a] NCCL process group of 1 rank in process: {DP_STEPS} dp "
           f"steps of each training bit-identical to the plain steps "
           f"(parameters, gradients, moments, batch statistics, logs), the "
           f"same launches (NSR {nl1}; stage 3 {gl1}); ms a step, host "
           f"synchronised, {DP_TIMED} steps at world size 1: NSR plain "
           f"{nms:.2f}, dp {nms1:.2f}; stage 1 plain {gms:.2f}, dp "
           f"{gms1:.2f}")
    return {"nsr_ms": nms1, "gan_ms": gms1, "nsr_plain_ms": nms,
            "gan_plain_ms": gms}


def host_ms(fn, steps: int) -> float:
    """Host-clock ms a call of ``fn`` over ``steps`` calls, synchronised
    at both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.time() - t0) / steps


def forbid_writes(root: str) -> list:
    """Make every write under ``root`` in this process raise; returns the
    list that records the paths it was asked to write."""
    import builtins
    import functools

    root = os.path.realpath(root)
    attempts = []

    def guard(fn, writes):
        @functools.wraps(fn)
        def wrapped(path, *args, **kwargs):
            if isinstance(path, (str, os.PathLike)) and os.path.realpath(
                    path).startswith(root + os.sep) \
                    and writes(*args, **kwargs):
                attempts.append(os.fspath(path))
                raise PermissionError(f"a rank other than 0 wrote {path}")
            return fn(path, *args, **kwargs)
        return wrapped

    builtins.open = guard(builtins.open, lambda mode="r", *a, **k: any(
        c in k.get("mode", mode) for c in "wax+"))
    os.makedirs = guard(os.makedirs, lambda *a, **k: True)
    os.mkdir = guard(os.mkdir, lambda *a, **k: True)
    return attempts


def dp_rank_steps(root: str, device, rank: int, world: int) -> dict:
    """(b) on one rank: one dp step of each training at full width on this
    rank's shard, then DP_TIMED more, timed."""
    import torch

    from drawingspinup_torch.parallel import mesh
    from drawingspinup_torch.train import gan, gan_parallel, nsr, \
        nsr_parallel

    cfg, data, n_active = dp_nsr(root, device)
    v, h, w = data["masks"].shape
    state = nsr.init_state(cfg, SEED, device)
    step = nsr_parallel.make_train_step_dp(cfg, nsr.make_optimizer(cfg),
                                           world)
    g = torch.Generator(device=device).manual_seed(mesh.rank_seed(SEED + 1))
    logs = step(state, data, nsr.make_draws(step.draw_cfg, v, h, w, g,
                                            device), n_active=n_active)
    out = {"nsr": nsr_snapshot(state),
           "nsr_logs": {k: host_copy(x) for k, x in logs.items()}}
    out["nsr_ms"] = host_ms(lambda: step(state, data, nsr.make_draws(
        step.draw_cfg, v, h, w, g, device), n_active=n_active), DP_TIMED)
    gcfg, kf = dp_gan(root, device)
    gstate = gan.init_state(gcfg, device, SEED)
    gstep = gan_parallel.make_train_step_dp(gcfg, world)
    gg = torch.Generator(device=device).manual_seed(mesh.rank_seed(SEED + 1))
    glogs = gstep(gstate, kf, gg)
    out["gan"] = gan_snapshot(gstate)
    out["gan_logs"] = {k: host_copy(x) for k, x in glogs.items()}
    out["gan_ms"] = host_ms(lambda: gstep(gstate, kf, gg), DP_TIMED)
    out["per_rank"] = (step.rays_per_rank, gstep.per_rank)
    return out


def dp_rank_sweep(root: str, device, rank: int, world: int) -> dict:
    """(c) on one rank: run_sweep's recon and train_style stages for
    DP_UID over the ranks; the kernel launches of this rank, the final
    parameters of each training, and (rank 1) the writes it attempted."""
    import torch

    from drawingspinup_torch.cli import sweep as sweep_cli
    from drawingspinup_torch.pipelines import stage2_recon, sweep
    from drawingspinup_torch.train import gan, nsr

    dp_root = os.path.join(root, "dp")
    attempts = forbid_writes(dp_root) if rank else []
    seen = {}

    def spy(module, name: str, index: int):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen[name] = args[index]
            return fn(*args, **kwargs)
        setattr(module, name, wrapped)

    spy(nsr, "train_step", 2)
    spy(gan, "train_step_on_batch", 1)
    fns = sweep_cli.stage_functions(
        dp_root, str(device), recon_overrides=list(RECON_OVERRIDES),
        train_args=[["--max-batches", str(n), "--seed", str(SEED)]
                    for n in TRAIN_BATCHES], allow_degraded=True)
    zero_launches()
    t0 = time.time()
    result = sweep.run_sweep(dp_root, os.path.join(dp_root, "uids.json"),
                             {s: fns[s] for s in DP_SWEEP_STAGES})
    torch.cuda.synchronize()
    wall = time.time() - t0
    stats = stage2_recon.LAST_STATS
    return {"result": result, "launches": launch_counts(),
            "field_evals": stats.get("export", {}).get("field_evals"),
            "recon_steps": stats["steps"], "wall": wall,
            "nsr": {n: host_copy(p)
                    for n, p in nsr.named_leaves(seen["train_step"].params)},
            "gan": gan_snapshot(seen["train_step_on_batch"]),
            "attempts": attempts}


def dp_rank(task: str, rank: int, world: int, root: str, tmp: str) -> None:
    """A spawned rank of phase 20: join the gloo group on cuda:0 as
    torchrun's variables say, run ``task``, save what it saw."""
    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0")
    from drawingspinup_torch.parallel import mesh

    _, _, device = mesh.init_dp("cuda:0", backend="gloo",
                                init_method=f"file://{tmp}/store_{task}")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            out = {"steps": dp_rank_steps, "sweep": dp_rank_sweep,
                   "mv": dp_rank_mv, "tp": dp_rank_tp}[task](
                       root, device, rank, world)
        torch.save(out, os.path.join(tmp, f"out_{task}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(task: str, root: str, tmp: str) -> list:
    """DP_WORLD spawned ranks of ``task`` on the one card → their
    outputs; a rank that has not ended in DP_JOIN_S fails the phase."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(task, r, DP_WORLD, root, tmp))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(DP_JOIN_S)
        check(not any(p.is_alive() for p in procs),
              f"[20] {task}: a rank still runs after {DP_JOIN_S} s")
        check([p.exitcode for p in procs] == [0] * DP_WORLD,
              f"[20] {task}: rank exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(tmp, f"out_{task}_{r}.pt"),
                       weights_only=False) for r in range(DP_WORLD)]


def averaged_by_hand(shards) -> None:
    """Run each ``shard(reduce)`` in a thread of its own; ``reduce``
    averages each tensor over the shards by hand, ``(a + b) / n`` in the
    tensor's dtype, as the ranks' all-reduce would."""
    import threading

    import torch

    n = len(shards)
    barrier = threading.Barrier(n)
    lists = [None] * n
    errors = []

    def make_reduce(i):
        def reduce(tensors):
            lists[i] = list(tensors)
            barrier.wait()
            if i == 0:
                with torch.no_grad():
                    for group in zip(*lists):
                        if group[0] is None:
                            continue
                        total = group[0].clone()
                        for t in group[1:]:
                            total += t
                        total /= n
                        for t in group:
                            t.copy_(total)
            barrier.wait()
        return reduce

    def run(i):
        try:
            shards[i](make_reduce(i))
        except Exception as e:   # reported by the caller
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"[20b] the by-hand average failed: {errors}")


def phase_dp_two_ranks(root: str, device, tmp: str) -> dict:
    """(b) two gloo ranks on the one card, one dp step of each training at
    full width, against the shards computed in this process, their
    gradients averaged by hand, then one update."""
    import dataclasses

    import torch

    from drawingspinup_torch.parallel import mesh
    from drawingspinup_torch.pipelines.stage3_data import sample_patches
    from drawingspinup_torch.train import gan, nsr

    outs = spawn_ranks("steps", root, tmp)
    for part in ("nsr", "gan"):
        bad = same_bits(outs[0][part], outs[1][part])
        check(not bad, f"[20b] ranks' {part} states differ: {bad[:8]}")
    cfg, data, n_active = dp_nsr(root, device)
    v, h, w = data["masks"].shape
    rays, patches = outs[0]["per_rank"]
    draw_cfg = dataclasses.replace(cfg, train_num_rays=rays)
    states = [nsr.init_state(cfg, SEED, device) for _ in range(DP_WORLD)]
    logs = [None] * DP_WORLD

    def nsr_shard(r):
        def run(reduce):
            g = torch.Generator(device=device).manual_seed(
                mesh.rank_seed(SEED + 1, r))
            logs[r] = nsr.train_step(
                cfg, nsr.make_optimizer(cfg), states[r], data,
                nsr.make_draws(draw_cfg, v, h, w, g, device),
                n_active=n_active, reduce=reduce)
        return run

    averaged_by_hand([nsr_shard(r) for r in range(DP_WORLD)])
    want = nsr_snapshot(states[0])
    got = outs[0]["nsr"]
    worst = {"loss": max(abs(outs[0]["nsr_logs"][k].item() - x.item())
                         / max(abs(x.item()), 1e-30)
                         for k, x in logs[0].items())}
    worst["grad"] = max(rel_l2(got["grads"][n], g_)
                        for n, g_ in want["grads"].items() if g_ is not None)
    p0 = nsr_snapshot(nsr.init_state(cfg, SEED, device))["params"]
    worst["param"] = max(rel_l2(got["params"][n] - x, want["params"][n] - x)
                         for n, x in p0.items()
                         if want["grads"][n] is not None)
    check(worst["loss"] <= DP_NSR_LOSS_TOL and worst["grad"] <= GRAD_REL_TOL
          and worst["param"] <= GRAD_REL_TOL,
          f"[20b] NSR dp step against the by-hand average: {worst}")
    nsr_worst = worst

    gcfg, kf = dp_gan(root, device)
    gstates = [gan.init_state(gcfg, device, SEED) for _ in range(DP_WORLD)]
    glogs = [None] * DP_WORLD

    def gan_shard(r):
        def run(reduce):
            g = torch.Generator(device=device).manual_seed(
                mesh.rank_seed(SEED + 1, r))
            batch = sample_patches(kf, g, patches, gcfg.patch_size)
            glogs[r] = gan.train_step_on_batch(gcfg, gstates[r], batch,
                                               reduce=reduce)
        return run

    averaged_by_hand([gan_shard(r) for r in range(DP_WORLD)])
    gwant = gan_snapshot(gstates[0])
    ggot = outs[0]["gan"]
    g0 = gan_snapshot(gan.init_state(gcfg, device, SEED), stepped=False)
    worst = {"loss": max(abs(outs[0]["gan_logs"][k].item() - x.item())
                         / max(abs(x.item()), 1e-30)
                         for k, x in glogs[0].items())}
    worst["grad"] = max(rel_l2(ggot[part][n], x)
                        for part in ("gen_grads", "disc_grads")
                        for n, x in gwant[part].items())
    worst["param"] = max(rel_l2(ggot[part][n] - g0[part][n],
                                x - g0[part][n])
                         for part in ("gen", "disc")
                         for n, x in gwant[part].items())
    check(worst["loss"] <= STEP_REL_TOL and worst["grad"] <= GRAD_REL_TOL
          and worst["param"] <= GRAD_REL_TOL,
          f"[20b] stage-3 dp step against the by-hand average: {worst}")
    nsr_bytes = sum(x.numel() * x.element_size()
                    for x in want["grads"].values() if x is not None) \
        + 4 * len(logs[0])
    gan_bytes = sum(x.numel() * x.element_size()
                    for part in ("gen_grads", "disc_grads")
                    for x in gwant[part].values()) \
        + sum(x.numel() * x.element_size() for k, x in gwant["gen"].items()
              if "running_" in k) + 4 * len(glogs[0])
    nsr_ms = [o["nsr_ms"] for o in outs]
    gan_ms = [o["gan_ms"] for o in outs]
    report(f"[20b] {DP_WORLD} gloo ranks on one card (spawned, cuda:0 "
           f"each): one dp step of each training at full width, the two "
           f"ranks' parameters, gradients and moments bit-identical; "
           f"against the shards computed in one process, averaged by "
           f"hand, then one update: NSR ({rays} rays a rank) losses within "
           f"{nsr_worst['loss']:.2e}, gradients {nsr_worst['grad']:.2e}, "
           f"updates {nsr_worst['param']:.2e} (relative L2); stage 1 "
           f"({patches} patches a rank) losses within {worst['loss']:.2e}, "
           f"gradients {worst['grad']:.2e}, updates {worst['param']:.2e}; "
           f"all-reduce bytes a step: NSR {nsr_bytes} ({n_active} levels "
           f"active), stage 1 {gan_bytes}; ms a step, host synchronised, "
           f"{DP_TIMED} steps, ranks 0 and 1 sharing the card (not a "
           f"scaling figure): NSR {nsr_ms[0]:.2f} / {nsr_ms[1]:.2f}, "
           f"stage 1 {gan_ms[0]:.2f} / {gan_ms[1]:.2f}")
    return {"nsr_ms": nsr_ms, "gan_ms": gan_ms, "nsr_bytes": nsr_bytes,
            "gan_bytes": gan_bytes}


def phase_dp_sweep(root: str, device, tmp: str) -> dict:
    """(c) run_sweep's recon and train_style stages for one uid over two
    gloo ranks on the card: rank 0 alone writes, the ranks end with the
    same parameters, each rank's launches are what its steps predict."""
    import shutil

    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.pipelines import stage2_recon, sweep
    from drawingspinup_torch.utils.synthetic import write_sphere_mv

    dp_root = os.path.join(root, "dp")
    src, dst = UidPaths(root, SWEEP_UIDS[0]), UidPaths(dp_root, DP_UID)
    write_sphere_mv(dp_root, DP_UID, size=RECON_SIZE)
    shutil.copytree(src.char_dir, dst.char_dir, dirs_exist_ok=True)
    for action in ("rest_pose",) + ACTIONS:
        for kind in ("color", "pos", "edge"):
            shutil.copytree(os.path.join(src.action_dir(action), kind),
                            os.path.join(dst.action_dir(action), kind))
    with open(os.path.join(dp_root, "uids.json"), "w") as f:
        json.dump([DP_UID], f)
    outs = spawn_ranks("sweep", root, tmp)
    check(outs[1]["attempts"] == [],
          f"[20c] rank 1 wrote {outs[1]['attempts'][:4]}")
    for o in outs:
        check(o["result"] == {"ok": [DP_UID], "failed": []},
              f"[20c] sweep result {o['result']}")
    bad = same_bits({"nsr": outs[0]["nsr"]}, {"nsr": outs[1]["nsr"]}) \
        + same_bits(outs[0]["gan"], outs[1]["gan"])
    check(not bad, f"[20c] the ranks' final parameters differ: {bad[:8]}")
    with open(os.path.join(dp_root, "sweep_log.jsonl")) as f:
        log = [(r["uid"], r["stage"]) for r in map(json.loads, f)]
    check(log == [(DP_UID, s) for s in DP_SWEEP_STAGES] + [(DP_UID, "done")],
          f"[20c] sweep log {log}")
    steps = recon_config().max_steps
    name = stage2_recon.export_name(steps, RECON_MC, RECON_FACES, True,
                                    True, False, True, True) + ".obj"
    check(os.path.exists(os.path.join(dst.mesh_dir, name))
          and os.listdir(os.path.join(dst.mesh_dir, "ckpt"))
          == [f"step_{steps}.pt"]
          and sweep.stage_done(dst, "train_style"),
          f"[20c] rank 0's outputs: {sorted(os.listdir(dst.mesh_dir))}")
    n_frames = len(ACTIONS) * FRAMES_PER_ACTION + 1
    for r, o in enumerate(outs):
        evals = o["field_evals"] if r == 0 else 0
        want = {"ric_conv_fwd": FWD_PER_STEP * TRAIN_BATCHES[0]
                + (RIC_PER_FRAME * n_frames if r == 0 else 0),
                "ric_conv_bwd": BWD_PER_STEP * TRAIN_BATCHES[0],
                "hashgrid_fwd": 2 * steps + (evals or 0),
                "hashgrid_bwd": steps, "pixel_rays": steps, "row_gather": 0,
                "mv_attention": 0}
        check(o["recon_steps"] == steps and (r or evals)
              and o["launches"] == want,
              f"[20c] rank {r} launches {o['launches']}, expected {want} "
              f"({steps} recon steps, {TRAIN_BATCHES[0]} stage-1 steps, "
              f"rank 0's export evaluations {evals} and {n_frames} eval "
              f"frames)")
    report(f"[20c] run_sweep of {', '.join(DP_SWEEP_STAGES)} for {DP_UID} "
           f"over {DP_WORLD} gloo ranks on one card (recon {steps} steps, "
           f"stage-3 --max-batches {TRAIN_BATCHES}): done on both ranks, "
           f"rank 0 alone wrote the OBJ, the checkpoints and the log (each "
           f"write under the data root raises on rank 1), the final NSR and "
           f"stage-2 parameters bit-identical across the ranks; launches "
           f"per rank as the steps predict: rank 0 {outs[0]['launches']}, "
           f"rank 1 {outs[1]['launches']}; wall {outs[0]['wall']:.1f} s")
    return {"launches": [o["launches"] for o in outs],
            "wall": outs[0]["wall"]}


def dp_mv_pipeline(device, dtype: str = "float32", steps: int = DP_MV_STEPS):
    """Stage 2a at full width (the yaml's UNet, VAE and CLIP), weights
    drawn from MV_SEED, ``steps`` denoise steps in ``dtype``. The joint
    (cross-domain) attentions' output projections, zero at init, are drawn
    too (kernel std 1/sqrt(fan-in), bias std 0.1, from MV_SEED + 1), so
    the split's ``domains`` fold moves the latents, as a trained
    checkpoint's would."""
    import torch

    from drawingspinup_torch.models.attention_mv import Attention
    from drawingspinup_torch.pipelines import stage2_mv as mv

    cfg = mv.MVPipelineConfig(num_inference_steps=steps,
                              compute_dtype=dtype)
    pipe = mv.MVPipeline.init_random(cfg, MV_SEED, device)
    gen = torch.Generator(device=device).manual_seed(MV_SEED + 1)
    joint = [m.to_out[0] for m in pipe.unet.modules()
             if isinstance(m, Attention) and m.zero_out]
    check(len(joint) > 0, "[20d] the UNet has no joint attention")
    with torch.no_grad():
        for lin in joint:
            for p, std in ((lin.weight, lin.weight.shape[1] ** -0.5),
                           (lin.bias, 0.1)):
                p.copy_(std * torch.randn(p.shape, generator=gen,
                                          device=device))
    return pipe


def mv_bf16_steps(pipe, root: str, device) -> dict:
    """DP_MV_TIMED bf16 denoise steps of ``pipe``'s weights on phase 15's
    first drawing, after one untimed pass: ms a step (host clock,
    synchronised), the K/V bytes this rank gathered a step (counted at
    ``RowSplit.gather_keys``) and the same counted from the transformer
    blocks' shapes: per folding attention, the local rows' tokens × 2C
    (K ⊕ V) in the compute dtype × (dp − 1). The latents' one gather after
    the loop is not K/V and is not counted."""
    import dataclasses

    import torch

    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.models.attention_mv import (
        RowSplit, TransformerMV2D,
    )
    from drawingspinup_torch.parallel import mesh
    from drawingspinup_torch.pipelines import stage2_mv as mv

    cfg = dataclasses.replace(pipe.cfg, compute_dtype="bfloat16",
                              num_inference_steps=DP_MV_TIMED)
    p16 = mv.MVPipeline(cfg, pipe.unet, pipe.vae, pipe.clip)
    image, _ = mv.load_input(UidPaths(root, MV_UID), cfg.image_size, device)
    embeds, cond = p16.encode_image(image)
    dp = mesh.mv_split(12, mesh.world_size())
    counted = {"gathered": 0, "shapes": 0}
    gather = RowSplit.gather_keys

    def counting(self, t, fold, num_views):
        counted["gathered"] += t.numel() * t.element_size() * (dp - 1)
        return gather(self, t, fold, num_views)

    def shapes(module, args, _out):
        n, c, h, w = args[0].shape
        folds = sum((b.fold is not None) + b.cd_attention_mid
                    + b.cd_attention_last for b in module.transformer_blocks)
        counted["shapes"] += folds * n * h * w * 2 * c * 2 * (dp - 1)

    p16.denoise(embeds, cond, generator=torch.Generator(
        device=device).manual_seed(MV_SEED))
    hooks = [m.register_forward_hook(shapes)
             for m in p16.unet_in(torch.bfloat16).modules()
             if isinstance(m, TransformerMV2D)]
    RowSplit.gather_keys = counting
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        p16.denoise(embeds, cond, generator=torch.Generator(
            device=device).manual_seed(MV_SEED))
        torch.cuda.synchronize()
        ms = 1e3 * (time.time() - t0) / DP_MV_TIMED
    finally:
        RowSplit.gather_keys = gather
        for h in hooks:
            h.remove()
    return {"ms": ms, "dp": dp,
            "kv_bytes": counted["gathered"] / DP_MV_TIMED,
            "kv_bytes_shapes": counted["shapes"] / DP_MV_TIMED}


def dp_rank_mv(root: str, device, rank: int, world: int) -> dict:
    """(d) on one rank: generate_uid in f32 with the batch split over the
    ranks into ``<root>/mv_split`` (rank 0 writes; every write there
    raises on rank 1), this rank's gathered latents, then the bf16 denoise
    steps timed."""
    from drawingspinup_torch.pipelines import stage2_mv as mv

    split_root = os.path.join(root, "mv_split")
    attempts = forbid_writes(split_root) if rank else []
    pipe = dp_mv_pipeline(device)
    seen = []
    denoise = pipe.denoise

    def recorded(*args, **kwargs):
        seen.append(denoise(*args, **kwargs))
        return seen[-1]

    pipe.denoise = recorded
    mv.generate_uid(split_root, MV_UID, pipe, seed=MV_SEED)
    return {"latents": host_copy(seen[0]), "attempts": attempts,
            "bf16": mv_bf16_steps(pipe, root, device)}


def phase_dp_mv(root: str, device, tmp: str) -> dict:
    """(d) stage 2a's batch split: an NCCL group of one rank against the
    plain path, then two gloo ranks on the card against one rank (this
    process) on the same draws."""
    import shutil

    import torch
    import torch.distributed as dist

    from drawingspinup_torch.core.contract import VIEWS, UidPaths
    from drawingspinup_torch.core.io import read_image_u8
    from drawingspinup_torch.parallel import mesh
    from drawingspinup_torch.pipelines import stage2_mv as mv

    one_root = os.path.join(root, "mv_one")
    split_root = os.path.join(root, "mv_split")
    for r in (one_root, split_root):
        shutil.copytree(UidPaths(root, MV_UID).char_dir,
                        UidPaths(r, MV_UID).char_dir)
    pipe = dp_mv_pipeline(device)
    image, _ = mv.load_input(UidPaths(one_root, MV_UID), pipe.cfg.image_size,
                             device)
    embeds, cond = pipe.encode_image(image)

    def latents():
        return pipe.denoise(embeds, cond, generator=torch.Generator(
            device=device).manual_seed(MV_SEED))

    plain = latents()
    rank, world, _ = mesh.init_dp(device, backend="nccl",
                                  init_method=f"file://{tmp}/nccl_mv_store")
    try:
        grouped = latents()
    finally:
        dist.destroy_process_group()
    check(world == 1 and torch.equal(plain, grouped),
          f"[20d] the denoise loop in an NCCL group of {world} rank differs "
          f"from the plain path")
    seen = []
    denoise = pipe.denoise

    def recorded(*args, **kwargs):
        seen.append(denoise(*args, **kwargs))
        return seen[-1]

    pipe.denoise = recorded
    mv.generate_uid(one_root, MV_UID, pipe, seed=MV_SEED)
    pipe.denoise = denoise
    check(torch.equal(seen[0], plain),
          "[20d] generate_uid's latents differ from the denoise loop's")
    one_latents = host_copy(seen[0])
    one16 = mv_bf16_steps(pipe, root, device)
    del pipe, seen, plain, grouped
    torch.cuda.empty_cache()

    outs = spawn_ranks("mv", root, tmp)
    check(torch.equal(outs[0]["latents"], outs[1]["latents"]),
          "[20d] the ranks' gathered latents differ")
    rel = rel_l2(outs[0]["latents"], one_latents)
    check(rel <= DP_MV_REL_L2,
          f"[20d] split latents against one rank: relative L2 {rel:.3e} > "
          f"{DP_MV_REL_L2:g}")
    check(outs[1]["attempts"] == [],
          f"[20d] rank 1 wrote {outs[1]['attempts'][:4]}")
    off, total, mask_px = 0, 0, 0
    for kind in ("normal", "color", "mask"):
        for v in VIEWS:
            a = read_image_u8(UidPaths(split_root, MV_UID).mv(kind, v))
            b = read_image_u8(UidPaths(one_root, MV_UID).mv(kind, v))
            check(a.shape == b.shape == (MV_OUT, MV_OUT, a.shape[-1]),
                  f"[20d] {kind}/{v}: shapes {a.shape}, {b.shape}")
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            if kind == "mask":
                mask_px += int((d > 0).sum())
            else:
                off += int((d > 1).sum())
                total += d.size
    check(off <= DP_MV_U8_SHARE * total and mask_px == 0,
          f"[20d] PNGs: {off} of {total} values more than 1 apart (limit "
          f"{DP_MV_U8_SHARE:.1%}), {mask_px} mask pixels differ")
    two16 = [o["bf16"] for o in outs]
    check(all(t["kv_bytes"] == t["kv_bytes_shapes"] > 0 for t in two16)
          and one16["kv_bytes"] == 0,
          f"[20d] K/V bytes gathered a step: counted at the gathers "
          f"{[t['kv_bytes'] for t in two16]}, from the shapes "
          f"{[t['kv_bytes_shapes'] for t in two16]}, one rank "
          f"{one16['kv_bytes']}")
    report(f"[20d] stage 2a split over {two16[0]['dp']} gloo ranks on one "
           f"card (full width, seeded, the joint attentions' output "
           f"projections drawn, {DP_MV_STEPS} f32 denoise steps, uid "
           f"{MV_UID}): NCCL group of 1 rank bit-identical to the plain "
           f"loop; the ranks' gathered latents bit-identical, relative L2 "
           f"{rel:.3e} from one rank on the same draws (limit "
           f"{DP_MV_REL_L2:g}); PNG values more than 1 apart {off} of "
           f"{total} ({off / total:.4%}), mask pixels differing {mask_px}; "
           f"rank 1 wrote nothing; bf16 ms a denoise step (host clock, "
           f"{DP_MV_TIMED} steps): one rank {one16['ms']:.2f}, two ranks "
           f"sharing the card {two16[0]['ms']:.2f} / {two16[1]['ms']:.2f} "
           f"(gloo gathers through the host; not a scaling figure); K/V "
           f"bytes each rank gathers a step (bf16, every folding attention): "
           f"{two16[0]['kv_bytes']:.0f}, the same as counted from the "
           f"transformer blocks' shapes")
    return {"ms_one": one16["ms"], "ms_two": [t["ms"] for t in two16],
            "kv_bytes": two16[0]["kv_bytes"], "rel_l2": rel,
            "u8_off": off / total}


def phase_dp(root: str, device) -> dict:
    """Phase 20: (a) NCCL at world size 1, (b) two gloo ranks on the card,
    (c) the latency sweep's training stages over those two ranks, (d)
    stage 2a's batch split."""
    tmp = os.path.join(root, "dp_ranks")
    os.makedirs(tmp)
    one = phase_dp_world1(root, device, tmp)
    two = phase_dp_two_ranks(root, device, tmp)
    sweep_run = phase_dp_sweep(root, device, tmp)
    mv_split = phase_dp_mv(root, device, tmp)
    return {"world1": one, "two": two, "sweep": sweep_run, "mv": mv_split}


def tail_root(root: str, name: str) -> str:
    """A fresh data root holding phase 17's two uids' inputs (drawing and
    views), without their meshes."""
    from drawingspinup_torch.bench import recon_tail

    return recon_tail.copy_inputs(root, os.path.join(root, name),
                                  SWEEP_UIDS)


def phase_recon_tail(root: str, device) -> dict:
    """Phase 21: recon_uid over phase 17's two uids, one turn in series
    and one with the export tails on a one-worker thread (the recon CLI's
    multi-uid path; ``drawingspinup_torch/bench/recon_tail.py``'s turn),
    then the CLI with one uid's tail failing. The walls are reported, not
    judged: the bench runs the alternating turns that decide."""
    import functools
    import shutil

    from drawingspinup_torch.bench import recon_tail
    from drawingspinup_torch.cli import recon as recon_cli
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.render import mesh_post

    overrides = [o for o in RECON_OVERRIDES
                 if not o.startswith("trainer.max_steps=")]
    ycfg, cfg = recon_tail.recon_cfg(TAIL_STEPS, overrides)
    runs = {}
    for run in ("serial", "overlapped"):
        zero_launches()
        runs[run] = recon_tail.run_turn(
            tail_root(root, f"tail_{run}"), SWEEP_UIDS, ycfg, cfg, device,
            run == "overlapped", mc=RECON_MC, faces=RECON_FACES,
            im_size=RECON_SIZE)
        runs[run]["launches"] = launch_counts()
    ser, ovl = runs["serial"], runs["overlapped"]
    check(ser["futures"] == 0 and ovl["futures"] == 2,
          f"[21] futures: serial {ser['futures']}, overlapped "
          f"{ovl['futures']}")
    check(ovl["objs"] == ser["objs"],
          "[21] the overlapped run's OBJs differ from the serial run's")
    check(ovl["launches"] == ser["launches"],
          f"[21] launches: serial {ser['launches']}, overlapped "
          f"{ovl['launches']}")

    # the CLI on both uids, resumed from the overlapped run's checkpoints,
    # the first uid's save_mesh raising
    froot = tail_root(root, "tail_failed")
    for uid, path in zip(SWEEP_UIDS, ovl["paths"]):
        shutil.copytree(os.path.join(os.path.dirname(path), "ckpt"),
                        os.path.join(UidPaths(froot, uid).mesh_dir, "ckpt"))
    lists = os.path.join(froot, "uids.json")
    thin = os.path.join(froot, "thin.json")
    with open(lists, "w") as f:
        json.dump(list(SWEEP_UIDS), f)
    with open(thin, "w") as f:
        json.dump([SWEEP_UIDS[1]], f)
    save = mesh_post.save_mesh

    @functools.wraps(save)
    def failing(path, *args, **kwargs):
        if os.sep + SWEEP_UIDS[0] + os.sep in path:
            raise OSError(f"forced failure writing {path}")
        return save(path, *args, **kwargs)

    out = io.StringIO()
    mesh_post.save_mesh = failing
    try:
        with contextlib.redirect_stdout(out):
            rc = recon_cli.main(["--root", froot, "--device", str(device),
                                 *overrides,
                                 f"trainer.max_steps={TAIL_STEPS}",
                                 "model.geometry.isosurface.resolution="
                                 f"{TAIL_FAIL_MC}",
                                 f"model.geometry.face_count={RECON_FACES}",
                                 f"dataset.uid_list_file={lists}",
                                 f"dataset.thinning_uid_list_file={thin}",
                                 f"dataset.imSize=[{RECON_SIZE}, "
                                 f"{RECON_SIZE}]"])
    finally:
        mesh_post.save_mesh = save
    sys.stderr.write(out.getvalue())
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    written_ok = len(line["written"]) == 1 and os.path.exists(
        line["written"][0]) and line["written"][0].startswith(
        UidPaths(froot, SWEEP_UIDS[1]).mesh_dir)
    check(rc == 1 and line.get("failed") == [SWEEP_UIDS[0]] and written_ok,
          f"[21] forced tail failure: exit {rc}, line {line}")

    def each(key, pick=lambda v: v):
        return " / ".join(f"{pick(runs[k][key]):.2f}" for k in runs)

    report(f"[21] recon tail, two uids ({', '.join(SWEEP_UIDS)}; "
           f"{TAIL_STEPS} steps, mc{RECON_MC}, {RECON_FACES} faces, the "
           f"second thinned), serial / overlapped (one turn each, not a "
           f"comparison: python -m drawingspinup_torch.bench.recon_tail "
           f"runs alternating turns): wall s {each('wall')}; the first "
           f"uid's tail s {each('tail_s', lambda v: v[0])}, of it beside "
           f"the second uid's recon call {each('hidden_s')}; the second "
           f"uid's ms a step {each('step_ms', lambda v: v[1])}; OBJs "
           f"byte-equal; the same launches ({ovl['launches']}); the recon "
           f"CLI with {SWEEP_UIDS[0]}'s save_mesh raising (mc{TAIL_FAIL_MC}, "
           f"resumed): exit code 1, failed {line['failed']}, "
           f"{SWEEP_UIDS[1]}'s OBJ written")
    return {"runs": {k: {x: runs[k][x] for x in ("wall", "step_ms",
                                                  "tail_s", "hidden_s")}
                     for k in runs},
            "launches": ovl["launches"]}


def phase_stage3_bf16(root: str, device) -> dict:
    """Phase 22: stage-3 compute_dtype bfloat16 against float32."""
    import dataclasses

    import torch

    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.kernels import ric_conv as rk
    from drawingspinup_torch.models.ric_tables import ric_shifted_weights
    from drawingspinup_torch.pipelines import stage3_data
    from drawingspinup_torch.pipelines import stage3_translate as st
    from drawingspinup_torch.train import gan

    paths = UidPaths(root, TRAIN_UID)
    data = keyframe(paths, 1, device)
    steps = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(stage_config(1), compute_dtype=dt)
        state = gan.init_state(cfg, device, SEED)
        g = torch.Generator(device=device).manual_seed(SEED)
        zero_launches()
        losses = [gan.train_step(cfg, state, data, g)["g_loss"]
                  for _ in range(BF16_STEPS)]
        torch.cuda.synchronize()
        launches = launch_counts()
        losses = torch.stack(losses).tolist()
        ms = host_ms(lambda: gan.train_step(cfg, state, data, g), 10)
        busy, n = device_profile(lambda: gan.train_step(cfg, state, data, g),
                                 3, os.path.join(root, f"bf16_prof_{dt}"))
        steps[dt] = {"ms": ms, "busy": busy, "launches": n, "losses": losses,
                     "kernels": launches}
    b16 = steps["bfloat16"]
    check(b16["kernels"]["ric_conv_fwd"] == FWD_PER_STEP * BF16_STEPS
          and b16["kernels"]["ric_conv_bwd"] == BWD_PER_STEP * BF16_STEPS,
          f"[22] bf16 steps' RIC launches {b16['kernels']}")
    first, last = np.mean(b16["losses"][:3]), np.mean(b16["losses"][-3:])
    check(all(math.isfinite(x) for x in b16["losses"]) and last < first,
          f"[22] bf16 g_loss over {BF16_STEPS} steps: {b16['losses']}")

    # the kernels on bf16-rounded inputs: the training path feeds them
    # x.float() of a bf16 activation and a bf16 cotangent cast up
    worst = {"fwd": 0.0, "bwd": 0.0}
    for k, (hw, c, o, _, _) in enumerate(TRAIN_SHAPES):
        g = torch.Generator(device=device).manual_seed(SEED + 300 + k)
        x = torch.randn((BATCH, hw, hw, c), generator=g, device=device
                        ).bfloat16().float()
        wk = torch.randn((9, c, o), generator=g, device=device) \
            / math.sqrt(9 * c)
        cot = torch.randn((BATCH, hw, hw, o), generator=g, device=device
                          ).bfloat16().float()
        swf = torch.from_numpy(ric_shifted_weights(hw, hw).copy()).to(device)
        need_dx = k > 0
        pairs = [("fwd", rk.ric_conv_fwd(x, wk, swf),
                  rk.ric_conv_reference(x, wk, swf), REL_TOL)]
        got = rk.ric_conv_bwd(x, wk, swf, cot, need_dx)
        want = rk.ric_conv_bwd_reference(x, wk, swf, cot, need_dx)
        pairs += [("bwd", a, b, BWD_REL_TOL) for a, b in zip(got, want)
                  if a is not None]
        for name, a, b, tol in pairs:
            err = (a - b).abs().max().item() / b.abs().max().item()
            check(math.isfinite(err) and err <= tol,
                  f"[22] RIC {name} on bf16-rounded inputs at (H,C,O)="
                  f"{(hw, c, o)}: max err {err:.3e} of the twin's largest "
                  f"> {tol:g}")
            worst[name] = max(worst[name], err)

    # a served 512² frame: the same weights in bf16 and in f32
    x_u8 = stage3_data.load_full_frame_u8(
        UidPaths(root, UID).action_dir(ACTIONS[0]), "0001.png", False)
    m32 = seeded_generator(1, device, x_u8)
    m16 = gan.build_generator(dataclasses.replace(
        st.make_config(1), compute_dtype="bfloat16"), device)
    m16.load_state_dict(m32.state_dict())
    frames = [gan.generate_full_rgba(m, x_u8, True, True, False)
              for m in (m32, m16)]
    d = np.abs(frames[0].astype(np.int16) - frames[1].astype(np.int16))
    share = float((d[..., :3] > 1).mean())
    d_max, d_mean = int(d[..., :3].max()), float(d[..., :3].mean())
    check(np.array_equal(frames[0][..., 3], frames[1][..., 3])
          and d_max <= BF16_U8_MAX and d_mean <= BF16_U8_MEAN,
          f"[22] served frame, bf16 vs f32: RGB max {d_max}, mean "
          f"{d_mean:.3f} u8 (limits {BF16_U8_MAX:g}, {BF16_U8_MEAN:g}), "
          f"alpha equal: "
          f"{np.array_equal(frames[0][..., 3], frames[1][..., 3])}")
    f32 = steps["float32"]
    report(f"[22] stage 3 in bf16 (config_stage1.yaml, {BATCH} x 32^2 "
           f"patches): ms a step (host clock, 10 steps) f32 {f32['ms']:.2f}"
           f", bf16 {b16['ms']:.2f}; device busy a step f32 "
           f"{f32['busy']:.2f} ms, bf16 {b16['busy']:.2f} ms; launches a "
           f"step f32 {f32['launches']:.0f}, bf16 {b16['launches']:.0f}; "
           f"RIC launches over {BF16_STEPS} bf16 steps "
           f"{b16['kernels']['ric_conv_fwd']} / "
           f"{b16['kernels']['ric_conv_bwd']}; bf16 g_loss {first:.4f} -> "
           f"{last:.4f} (mean of the first and last 3 of {BF16_STEPS}); RIC "
           f"kernels on bf16-rounded inputs at the {len(TRAIN_SHAPES)} "
           f"training shapes: forward within {worst['fwd']:.2e}, backward "
           f"{worst['bwd']:.2e} of the twins' largest value (limits "
           f"{REL_TOL:g}, {BWD_REL_TOL:g}); a served {FRAME}^2 frame, bf16 "
           f"vs f32: {share:.3%} of RGB values more than 1 apart, max "
           f"{d_max}, mean {d_mean:.3f} u8 (JAX's bf16 bounds: "
           f"{BF16_U8_MAX:g}, {BF16_U8_MEAN:g}), alpha equal")
    return {"launches": b16["kernels"], "f32": f32, "bf16": b16,
            "frame_share": share}


def tp_batch(device, dtype=None, rows=None):
    """Phase 23's batch, drawn as the dry run draws its own (x uniform, y =
    uniform > 0.5, seeds 0 and 1), NCHW, in ``dtype``; ``rows``: an order
    of its rows."""
    import torch

    x = np.random.default_rng(0).random((TP_BATCH, 4, TP_SIZE, TP_SIZE))
    y = np.random.default_rng(1).random((TP_BATCH, 1, TP_SIZE, TP_SIZE)) > .5
    return (torch.from_numpy(a.astype(np.float32)[rows or slice(None)]).to(
        device, dtype) for a in (x, y))


def tp_plain(device, dtype, steps: int = TP_STEPS, rows=None) -> dict:
    """The plain step (no mesh) at full width from the seeded weights:
    ``steps`` losses, the gradients and running statistics after step 1,
    the state and Adam moments after step 2 (host); ``rows`` reorders the
    batch, which changes only the order of the step's sums."""
    import torch

    from drawingspinup_torch.parallel import dryrun
    from drawingspinup_torch.train.lama import make_optimizer

    model = dryrun.seeded_generator(SEED).to(device, dtype)
    opt = make_optimizer(model, dryrun.LR)
    x, y = tp_batch(device, dtype, rows)
    out = {"losses": [float(dryrun.ffc_tp_train_step(model, opt, x, y))]}
    out["grads"] = {n: host_copy(p.grad.double())
                    for n, p in model.named_parameters()}
    out["stats"] = {n: host_copy(b.double())
                    for n, b in model.named_buffers()}
    for i in range(1, steps):
        out["losses"].append(float(dryrun.ffc_tp_train_step(model, opt, x,
                                                            y)))
        if i == 1:
            out["state"] = {k: host_copy(v)
                            for k, v in model.state_dict().items()}
            out["moments"] = {n: [host_copy(opt.state[p][k])
                                  for k in ("exp_avg", "exp_avg_sq")]
                              for n, p in model.named_parameters()}
    out["n_params"] = sum(p.numel() for p in model.parameters())
    return out


def phase_tp_world1(root: str, device, tmp: str) -> dict:
    """(a) an NCCL group of one rank: the ``make_mesh(1, 1)`` step at full
    width bit-identical to the plain step over two steps; ms a step and
    launches a step."""
    import torch
    import torch.distributed as dist

    from drawingspinup_torch.parallel import dryrun, mesh, tp
    from drawingspinup_torch.train.lama import make_optimizer

    plain = tp_plain(device, torch.float32)
    check(plain["n_params"] == TP_PARAMS,
          f"[23a] {plain['n_params']} parameters, not {TP_PARAMS}")
    rank, world, _ = mesh.init_dp(device, backend="nccl",
                                  init_method=f"file://{tmp}/nccl_tp_store")
    try:
        m = mesh.make_mesh(1, 1)
        model = dryrun.seeded_generator(SEED).to(device)
        tp.shard_params_tp(model, m)
        opt = make_optimizer(model, dryrun.LR)
        x, y = tp_batch(device)
        losses = [float(dryrun.ffc_tp_train_step(model, opt, x, y, m))
                  for _ in range(2)]
        state = model.state_dict()
        params = dict(model.named_parameters())
        same = losses == plain["losses"][:2] and all(
            torch.equal(state[k].cpu(), v) for k, v in plain["state"].items()
        ) and all(torch.equal(opt.state[params[n]][k].cpu(), v)
                  for n, vs in plain["moments"].items()
                  for k, v in zip(("exp_avg", "exp_avg_sq"), vs))
        ms = host_ms(lambda: dryrun.ffc_tp_train_step(model, opt, x, y, m),
                     TP_TIMED)
        busy, launches = device_profile(
            lambda: dryrun.ffc_tp_train_step(model, opt, x, y, m), 1,
            os.path.join(tmp, "tp1_trace"))
    finally:
        dist.destroy_process_group()
    check((rank, world) == (0, 1) and same,
          f"[23a] the mesh step in an NCCL group of {world} differs from the "
          f"plain step")
    return {"plain": plain, "ms": ms, "busy": busy, "launches": launches}


def dp_rank_tp(root: str, device, rank: int, world: int) -> dict:
    """(b) on one rank of a (1, world) mesh: TP_STEPS f32 steps at full
    width on this rank's shards; the gathered gradients and statistics of
    step 1,
    step 1's collectives and the shapes' prediction, ms a step, launches
    and device busy a step."""
    import torch

    from drawingspinup_torch.parallel import dryrun, mesh, tp
    from drawingspinup_torch.train.lama import make_optimizer

    m = mesh.make_mesh(1, world)
    model = dryrun.seeded_generator(SEED).to(device)
    axes = tp.shard_params_tp(model, m)
    opt = make_optimizer(model, dryrun.LR)
    x, y = tp_batch(device)
    tp.reset_traffic()
    losses = [float(dryrun.ffc_tp_train_step(model, opt, x, y, m))]
    traffic = dict(tp.TRAFFIC)
    params = dict(model.named_parameters())
    grads = tp.gather_named({n: p.grad for n, p in params.items()}, axes, m)
    stats = tp.gather_named(dict(model.named_buffers()), axes, m)
    losses += [float(dryrun.ffc_tp_train_step(model, opt, x, y, m))
               for _ in range(TP_STEPS - 1)]
    ms = host_ms(lambda: dryrun.ffc_tp_train_step(model, opt, x, y, m),
                 TP_TIMED)
    busy, launches = device_profile(
        lambda: dryrun.ffc_tp_train_step(model, opt, x, y, m), 1,
        os.path.join(root, f"tp2_trace_{rank}"))
    return {"losses": losses, "traffic": traffic,
            "predicted": dryrun.predicted_traffic(model, TP_BATCH, TP_SIZE,
                                                  world),
            "n_params": sum(p.numel() for p in params.values()),
            "grads": {n: host_copy(g.double()) for n, g in grads.items()},
            "stats": {n: host_copy(b.double()) for n, b in stats.items()},
            "ms": ms, "busy": busy, "launches": launches}


def phase_tp(root: str, device) -> dict:
    """Phase 23: the tensor-parallel FFC step (JAX's ``shard_params_tp``)
    at LaMa's full width: (a) NCCL at world size 1, (b) dp 1 × tp 2 on two
    gloo ranks sharing the card against the plain f32 and float64 steps,
    (c) the dry-run entry on two gloo ranks on the card."""
    import torch

    from drawingspinup_torch.parallel import dryrun

    tmp = os.path.join(root, "tp_ranks")
    os.makedirs(tmp)
    # (c) runs beside the untimed references, and ends before (a) and (b)
    t0 = time.time()
    dry = subprocess.Popen(
        [sys.executable, "-m", "drawingspinup_torch.parallel.dryrun",
         "--ranks", "2", "--device", "cuda:0", "--backend", "gloo"],
        cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        f64 = tp_plain(device, torch.float64, steps=1)
        # the plain f32 step's own rounding spread: the same step on its
        # rows in the other order (the same math) lands up to 1.66x
        # farther from float64 than in the drawn order on some leaves
        swapped = tp_plain(device, torch.float32, steps=1,
                           rows=list(range(TP_BATCH))[::-1])
        stdout, stderr = dry.communicate(timeout=700)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    dry_s = time.time() - t0
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("dryrun_multichip[") and ln.endswith(" ok")]
    check(dry.returncode == 0 and len(lines) == 4,
          f"[23c] the dry run: exit {dry.returncode}, {len(lines)} ok "
          f"lines; {stdout[-1500:]} {stderr[-3000:]}")
    one = phase_tp_world1(root, device, tmp)
    with torch.device("meta"):
        layers = dryrun.FFCResNetGenerator().model
    zero_grad = [f"model.{i}.bias" for i, m in enumerate(layers)
                 if isinstance(m, torch.nn.ConvTranspose2d)]
    outs = spawn_ranks("tp", root, tmp)
    for r, out in enumerate(outs):
        check(out["n_params"] == TP_PER_RANK,
              f"[23b] rank {r} holds {out['n_params']} parameters, not "
              f"{TP_PER_RANK}")
        check(out["traffic"] == out["predicted"],
              f"[23b] rank {r}: collectives {out['traffic']} against the "
              f"shapes' {out['predicted']}")
    dist = {}      # leaf: tp's distance, the plain f32 step's in each order
    for name, want in f64["grads"].items():
        if name in zero_grad:
            continue
        norm = float(want.norm())
        dist[name] = (max(float((o["grads"][name] - want).norm()) / norm
                          for o in outs),
                      *(float((p["grads"][name] - want).norm()) / norm
                        for p in (one["plain"], swapped)))
    spread = max(max(a, b) / max(min(a, b), TP_GRAD_FLOOR)
                 for _, a, b in dist.values())
    factor = max(1.25, spread)
    ratios = sorted(((d / max(a, b, TP_GRAD_FLOOR), n, d, max(a, b))
                     for n, (d, a, b) in dist.items()), reverse=True)
    print(f"[23b] the plain f32 step's spread between its row orders "
          f"{spread:.2f}; the leaves nearest the bound (ratio, leaf, tp, "
          f"plain): " + "; ".join(f"{r:.2f} {n} {d:.3e} {p:.3e}"
                                  for r, n, d, p in ratios[:8]))
    for r, name, d_tp, d_plain in ratios:
        check(d_tp <= max(factor * d_plain, TP_GRAD_FLOOR),
              f"[23b] gradient {name}: relative L2 {d_tp:.3e} from float64 "
              f"against {factor:.2f} × the plain f32 step's {d_plain:.3e} "
              f"(the larger of its two row orders)")
    worst = max(d for d, _, _ in dist.values())
    ratio = ratios[0][0]
    zero_max = max(float(o["grads"][n].abs().max()) for o in outs
                   for n in zero_grad)
    stat_worst = 0.0
    for name, want in f64["stats"].items():
        for o in outs:
            d = float((o["stats"][name] - want).norm() / want.norm())
            stat_worst = max(stat_worst, d)
    check(stat_worst <= TP_STAT_TOL,
          f"[23b] running statistics {stat_worst:.3e} from float64 (limit "
          f"{TP_STAT_TOL:g})")
    plain_losses = one["plain"]["losses"]
    for r, out in enumerate(outs):
        check(out["losses"][-1] < out["losses"][0],
              f"[23b] rank {r}: the loss did not fall over {TP_STEPS} "
              f"steps: {out['losses']} (the plain step's {plain_losses})")
    tr, pred = outs[0]["traffic"], outs[0]["predicted"]
    report(f"[23] tensor parallelism, the FFC generator at LaMa's full width "
           f"({TP_PARAMS} parameters), batch {TP_BATCH} of {TP_SIZE}² "
           f"(LaMa: 8 of 512²): (a) NCCL group of 1 rank, two steps "
           f"bit-identical to the plain step, {one['ms']:.2f} ms a step "
           f"(host clock, {TP_TIMED} steps), {one['launches']:.0f} launches "
           f"and {one['busy']:.2f} ms busy a step; (b) dp 1 × tp 2 on two "
           f"gloo ranks sharing the card: {TP_PER_RANK} parameters a rank, "
           f"losses {', '.join(f'{v:.5f}' for v in outs[0]['losses'])} "
           f"over {TP_STEPS} steps (the plain f32 step's "
           f"{', '.join(f'{v:.5f}' for v in plain_losses)}); "
           f"step-1 gradients at most {worst:.3e} relative L2 from float64 "
           f"(at most {ratio:.2f}× max(the plain f32 step's distance, the "
           f"larger of its two row orders, {TP_GRAD_FLOOR:g}); bound "
           f"{factor:.2f}×: 1.25 or the plain step's own spread between its "
           f"row orders, {spread:.2f}), the "
           f"zero-gradient biases {zero_max:.2e}; "
           f"running statistics {stat_worst:.3e}; ms a step "
           f"{outs[0]['ms']:.2f} / {outs[1]['ms']:.2f}, launches "
           f"{outs[0]['launches']:.0f} / {outs[1]['launches']:.0f} and busy "
           f"{outs[0]['busy']:.2f} / {outs[1]['busy']:.2f} ms a step (rank "
           f"0 / 1); a step per rank gathers {tr['gather_bytes']} bytes in "
           f"{tr['gathers']} all-gathers and all-reduces "
           f"{tr['all_reduce_bytes']} in {tr['all_reduces']} (the shapes "
           f"predict {pred['gather_bytes']} / {pred['gathers']} and "
           f"{pred['all_reduce_bytes']} / {pred['all_reduces']}); (c) the "
           f"dry run's four parts on two gloo ranks on the card ok in "
           f"{dry_s:.1f} s (beside the untimed float64 step): "
           + "; ".join(ln.split(": ", 1)[1] for ln in lines))
    return {"ms_tp1": one["ms"], "ms_tp2": [o["ms"] for o in outs],
            "traffic": tr, "dry_s": dry_s}


def launch_counts() -> dict:
    """Each hand-written kernel's launches since ``zero_launches``, by the
    kernels line's names, from core/profiling.py's counters."""
    from drawingspinup_torch.core import profiling

    c = profiling.counters()
    return {"ric_conv_fwd": c["ric.fwd.launch"],
            "ric_conv_bwd": c["ric.bwd.launch"],
            "hashgrid_fwd": c["hashgrid.fwd.launch"]
            + c["hashgrid.fwd_jac.launch"],
            "hashgrid_bwd": c["hashgrid.bwd.launch"],
            "pixel_rays": c["pixel_rays.launch"],
            "row_gather": c["row_gather.launch"],
            "mv_attention": c["mv.attn.launch"]}


def judge_golden_bounds(report_: dict, what: str) -> None:
    """tests/test_goldens.py's cross-run bounds on a fidelity report:
    stage-3 images >= 20 dB, every other image >= 30 dB, every mesh's
    chamfer <= 2.5e-2 and V/F within 10 %, the GIFs' frame counts equal."""
    stages = [k for k in report_ if k.startswith(("stage1", "stage2a",
                                                  "stage3"))]
    check(any(k.startswith("stage3") for k in stages),
          f"{what}: no stage-3 images in {sorted(report_)}")
    for stage in stages:
        r = report_[stage]
        floor = GOLDEN_STAGE3_DB if stage.startswith("stage3") \
            else GOLDEN_DB
        check(r["n"] > 0 and r["aggregate"]["psnr"] >= floor,
              f"{what}: {stage} {r['aggregate']} (n {r['n']}) below "
              f"{floor} dB")
    meshes = report_.get("stage2b_mesh", {}).get("files", {})
    check(bool(meshes), f"{what}: no mesh compared")
    for name, m in meshes.items():
        check(not m.get("missing") and m["chamfer"] <= GOLDEN_CHAMFER,
              f"{what}: mesh {name} {m}")
        for k in ("n_verts", "n_faces"):
            a, b = m[k]
            check(abs(a - b) <= GOLDEN_COUNT_TOL * b,
                  f"{what}: mesh {name} {k} {a} against {b}")
    gifs = report_.get("gif", {}).get("files", {})
    check(bool(gifs), f"{what}: no GIF compared")
    for name, m in gifs.items():
        check(not m.get("missing") and m["n_frames"][0] == m["n_frames"][1],
              f"{what}: GIF {name} {m}")


def golden_aggregates(report_: dict) -> str:
    """A fidelity report's per-stage aggregates on one line."""
    parts = []
    for stage, r in report_.items():
        if "aggregate" in r and r["aggregate"]:
            a = r["aggregate"]
            parts.append(f"{stage} psnr {a['psnr']:.2f} ssim "
                         f"{a['ssim']:.4f} perceptual {a['perceptual']:.4g}")
        elif stage == "stage2b_mesh":
            parts += [f"{n} chamfer {m['chamfer']:.3e} V {m['n_verts']} "
                      f"F {m['n_faces']}" for n, m in r["files"].items()]
        elif stage == "gif":
            parts += [f"{n} frames {m['n_frames']} psnr "
                      f"{m['aggregate'].get('psnr', float('nan')):.2f}"
                      for n, m in r["files"].items()]
    return "; ".join(parts)


@contextlib.contextmanager
def cpu_draws():
    """Every random draw of the toy flow's recon and style training made on
    the CPU and moved to the device: the NSR and GAN inits
    (``train/{nsr,gan}.py::init_state``), the NSR step's rays
    (``nsr.make_draws``) and the style step's patches
    (``gan.sample_patches``), each from a CPU generator of its own
    generator's seed. On the card those generators draw other numbers;
    with these, phase 24's card run and CPU run differ only by the
    devices' arithmetic and the kernels against their plain versions."""
    import torch
    from torch.utils import _pytree

    from drawingspinup_torch.pipelines import stage3_data
    from drawingspinup_torch.train import gan, nsr

    saved = (nsr.init_state, gan.init_state, nsr.make_draws,
             gan.sample_patches)
    shadows = {}

    def on_cpu(generator):
        # the device generator is kept, so that its id names it alone
        return shadows.setdefault(id(generator), (generator, torch.Generator(
        ).manual_seed(generator.initial_seed())))[1]

    def nsr_state(cfg, seed, device="cpu"):
        def moved(t):
            # a copy to the device is no leaf; the optimizer needs leaves
            return t.detach().to(device).requires_grad_(t.requires_grad) \
                if isinstance(t, torch.Tensor) else t

        params = _pytree.tree_map(moved, saved[0](cfg, seed, "cpu").params)
        return nsr.TrainState(params, nsr.make_optimizer(cfg).init(params),
                              0)

    def gan_state(cfg, device, seed=0):
        state, cpu = saved[1](cfg, device, seed), saved[1](cfg, "cpu", seed)
        for mod, ref in ((state.gen, cpu.gen), (state.disc, cpu.disc),
                         (state.vgg, cpu.vgg)):
            mod.load_state_dict(ref.state_dict())
        return state

    def make_draws(cfg, n_views, h, w, generator, device):
        draws = saved[2](cfg, n_views, h, w, on_cpu(generator), "cpu")
        return nsr.Draws(*(t.to(device) for t in draws))

    def sample_patches(data, generator, batch, size):
        g = on_cpu(generator)
        i1, i2 = (torch.randint(0, data.n_valid, (batch,), generator=g)
                  for _ in range(2))
        dev = data.valid_yx.device
        return stage3_data.cut_patches(data, data.valid_yx[i1.to(dev)],
                                       data.valid_yx[i2.to(dev)], size)

    nsr.init_state, gan.init_state = nsr_state, gan_state
    nsr.make_draws, gan.sample_patches = make_draws, sample_patches
    try:
        yield
    finally:
        (nsr.init_state, gan.init_state, nsr.make_draws,
         gan.sample_patches) = saved


def phase_golden(root: str, device) -> dict:
    """The toy golden flow on the card and on the CPU, judged by the port's
    fidelity CLI; the judge at production sizes on phase 17's first uid.
    Returns the card flow's kernel launches."""
    import shutil

    import torch

    from drawingspinup_torch.cli import fidelity
    from drawingspinup_torch.core.contract import UidPaths
    from drawingspinup_torch.core.io import read_obj
    from drawingspinup_torch.pipelines import stage3_translate
    from drawingspinup_torch.train import gan
    from drawingspinup_torch.utils.quality import chamfer_distance
    from drawingspinup_torch.utils.synthetic import (
        TOY_GAN, TOY_STYLE_BATCHES, run_toy_flow,
    )

    card_root = os.path.join(root, "golden_card")
    cpu_root = os.path.join(root, "golden_cpu")
    with contextlib.redirect_stdout(sys.stderr):
        zero_launches()
        with cpu_draws():
            _, card_s = run_toy_flow(card_root, GOLDEN_UID, device)
        torch.cuda.synchronize()
        launches = launch_counts()
        with cpu_draws():
            _, cpu_s = run_toy_flow(cpu_root, GOLDEN_UID, "cpu")
    for k in ("hashgrid_fwd", "hashgrid_bwd", "pixel_rays"):
        check(launches[k] > 0, f"golden flow: {k} never launched "
                               f"({launches})")
    check(launches["row_gather"] == 0,
          f"golden flow: the row gather launched ({launches})")

    # stage 3 once more on the CPU, on the card's renders: 120 recon steps
    # turn the devices' last-bit differences into meshes as far apart as
    # other draws do, and renders of two such meshes part stage 3 by more
    # than its bound; on the same renders it holds the style training alone
    st3_root = os.path.join(root, "golden_cpu_stage3")
    shutil.copytree(card_root, st3_root, ignore=shutil.ignore_patterns(
        "res_stage*", "logs_stage*", "gif"))
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr), cpu_draws():
        stage3_translate.train_stage(st3_root, GOLDEN_UID, 1,
                                     cfg=gan.GANConfig(**TOY_GAN),
                                     max_batches=TOY_STYLE_BATCHES,
                                     device="cpu")
    cpu_s["train_style_on_card_renders"] = time.time() - t0

    t0 = time.time()
    vs_cpu = fidelity.build_report(card_root, cpu_root, GOLDEN_UID, device)
    torch.cuda.synchronize()
    judge_s = time.time() - t0
    same_renders = fidelity.build_report(card_root, st3_root, GOLDEN_UID,
                                         device)
    vs_goldens = fidelity.build_report(card_root, GOLDENS_TREE, GOLDEN_UID,
                                       device)

    def secs(d):
        return ", ".join(f"{k} {v:.2f}" for k, v in d.items()) \
            + f" (total {sum(d.values()):.2f})"

    report(f"[24] toy golden flow (run_toy_flow, port's seeded inits): card "
           f"vs CPU: " + golden_aggregates(vs_cpu)
           + f"; seconds per stage on the card: {secs(card_s)}; on the CPU: "
           f"{secs(cpu_s)}; fidelity (card vs CPU) {judge_s:.2f} s; kernel "
           f"launches in the card's flow "
           + ", ".join(f"{k} {v}" for k, v in launches.items()))
    report(f"[24] stage 3 on the card's renders, card vs CPU (the gated "
           f"stage-3 images; the flows' own stage-3 images above are not "
           f"gated): " + golden_aggregates(
               {k: v for k, v in same_renders.items()
                if k.startswith("stage3")}))
    report(f"[24] toy golden flow, card vs the committed goldens (not "
           f"gated: the goldens started from JAX's init, which this machine "
           f"cannot draw): " + golden_aggregates(vs_goldens))
    judge_golden_bounds(
        {**{k: v for k, v in vs_cpu.items() if not k.startswith("stage3")},
         **{k: v for k, v in same_renders.items() if k.startswith("stage3")}},
        "golden flow, card vs CPU")

    # the judge at production sizes: phase 17's first uid against a byte
    # copy of its own tree
    uid = SWEEP_UIDS[0]
    copy_root = os.path.join(root, "judge_copy")
    shutil.copytree(os.path.join(root, uid), os.path.join(copy_root, uid))
    torch.cuda.synchronize()
    t0 = time.time()
    same = fidelity.build_report(root, copy_root, uid, device)
    torch.cuda.synchronize()
    prod_s = time.time() - t0
    n_images = 0
    for stage, r in same.items():
        if stage.startswith("stage") and "aggregate" in r:
            n_images += r["n"]
            for name, m in r["files"].items():
                check(m.get("psnr") == float("inf")
                      and m.get("perceptual") == 0.0,
                      f"judge of a byte copy: {stage}/{name} {m}")
    meshes = same.get("stage2b_mesh", {}).get("files", {})
    gifs = same.get("gif", {}).get("files", {})
    check(bool(meshes), f"judge of a byte copy: no mesh in {sorted(same)}")
    for name, m in meshes.items():
        # JAX's chamfer samples 20 000 vertices of each side from one
        # generator in turn, so a larger mesh against itself reads the
        # sampling's own distance, not 0: the same value as the mesh's
        # chamfer against its own vertices
        v, _, _ = read_obj(os.path.join(UidPaths(root, uid).mesh_dir, name))
        check(m["chamfer"] == chamfer_distance(v, v)
              and m.get("color_mse", 0.0) == 0.0
              and m["n_verts"][0] == m["n_verts"][1]
              and m["n_faces"][0] == m["n_faces"][1],
              f"judge of a byte copy: mesh {name} {m}")
    check(bool(gifs) and all(m["aggregate"].get("psnr") == float("inf")
                             for m in gifs.values()),
          f"judge of a byte copy: GIFs {gifs}")
    check(any(k.startswith("stage2a") for k in same)
          and any(k.startswith("stage3") for k in same),
          f"judge of a byte copy: stages {sorted(same)}")

    report(f"[24] fidelity at production sizes: {uid} against a byte copy "
           f"of its tree, {n_images} images over "
           f"{sum(1 for k in same if k.startswith('stage'))} stages, "
           f"{len(meshes)} OBJ, {len(gifs)} GIFs: every PSNR inf, every "
           f"perceptual distance and vertex-colour MSE 0, the chamfer the "
           f"sampling's own ("
           + ", ".join(f"{m['chamfer']:.3e} at {m['n_verts'][0]} vertices"
                       for m in meshes.values())
           + f"); {prod_s:.2f} s")
    return launches


def kernels_line(per_shape, serving_launches, train_shapes, fwd_launches,
                 bwd_launches, hg_uniform, hg_rays, gather, gather_main,
                 pixel, recon_launches, sweep_launches, dp_launches,
                 bf16_launches, tail_launches, golden_launches,
                 mv_attn) -> dict:
    """The ``kernels`` JSON object from the phases' results: per kernel its
    launches on the main paths (``launches``: the stage-3 training path for
    the RIC kernels, the recon CLI for the rest; ``launches_sweep``: phase
    17's sweep of two uids; ``launches_dp_ranks``: each rank's in phase
    20's sweep over two ranks; ``launches_bf16``: phase 22's bf16 stage-1
    steps; ``launches_recon_tail``: phase 21's overlapped run of two uids;
    ``launches_golden``: phase 24's toy golden flow on the card; the
    stage-2a attention kernel's ``launches``: phase 16a's uid),
    error, times, bound and yardstick; the hash
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
    }, {
        "name": "mv_attention", "route": "cuda", "source": MV_ATTN_SOURCE,
        "replaces": MV_ATTN_REPLACES, "launches": mv_attn["launches"],
        "max_ulps": mv_attn["max_ulps"], "ms": mv_attn["ms"],
        "plain_ms": mv_attn["plain_ms"], "bound_ms": mv_attn["bound_ms"],
        "bound_by": "operations", "library_ms": mv_attn["library_ms"],
        "timed": "ms a uid: every core of one bf16 UNet call at "
                 "batch 12, times its calls a uid (75 steps), phase 16a "
                 "medians; plain: f32 SDPA on the upcast tensors; library: "
                 f"SDPA on the same bf16 tensors; {TIMED}",
        "device_ms": mv_attn["device_ms"],
        "library_device_ms": mv_attn["library_device_ms"],
        "shapes": mv_attn["rows"],
    }]}
    for k in line["kernels"]:
        k["launches_sweep"] = sweep_launches[k["name"]]
        k["launches_dp_ranks"] = [r[k["name"]] for r in dp_launches]
        k["launches_bf16"] = bf16_launches[k["name"]]
        k["launches_recon_tail"] = tail_launches[k["name"]]
        k["launches_golden"] = golden_launches[k["name"]]
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
    seconds = {}

    def timed(name: str, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t0
        return out

    timed("1", phase_versions)
    timed("2", phase_build)
    per_shape = timed("3", phase_kernel_vs_plain, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serving_launches = timed("4", phase_main_path, root, device)
        timed("5", phase_whole_frame, root, device)
        train_shapes = timed("6", phase_bwd_vs_plain, device)
        fwd_launches, bwd_launches = timed("7", phase_training, root, device)
        timed("8", phase_step_vs_plain, root, device)
        hg_uniform = timed("9u", phase_hashgrid_vs_plain, device,
                           uniform_points(device), "uniform")
        gather, gather_main = timed("10", phase_row_gather, device)
        pixel = timed("10p", phase_pixel_rays, device)
        recon_launches = timed("11", phase_recon, root, device)
        hg_rays = timed("9r", phase_hashgrid_vs_plain, device,
                        step_points(root, device), "ray-ordered")
        timed("12", phase_nsr_step_vs_plain, root, device)
        timed("13", phase_export_vs_plain, root, device)
        timed("14", phase_renders, root, device)
        timed("15", phase_stage1, root, device)
        timed("16", phase_mv, root, device)
        timed("16i", phase_isnet, root, device)
        mv_attn = timed("16a", phase_mv_attention, device)
        sweep_run = timed("17", phase_sweep, root, device)
        timed("18", phase_lama_train, root, device)
        timed("19", phase_lama_regular, root, device)
        dp_run = timed("20", phase_dp, root, device)
        tail_run = timed("21", phase_recon_tail, root, device)
        bf16_run = timed("22", phase_stage3_bf16, root, device)
        timed("23", phase_tp, root, device)
        golden_launches = timed("24", phase_golden, root, device)

    report("[t] seconds per phase (host clock): " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    report(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s "
           f"(the builds included)")
    print(json.dumps(kernels_line(
        per_shape, serving_launches, train_shapes, fwd_launches, bwd_launches,
        hg_uniform, hg_rays, gather, gather_main, pixel, recon_launches,
        sweep_run["launches"], dp_run["sweep"]["launches"],
        bf16_run["launches"], tail_run["launches"], golden_launches,
        mv_attn)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

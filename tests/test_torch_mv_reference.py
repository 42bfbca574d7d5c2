"""The port's stage 2a against the benchmark's plain reference
(``benchmark/reference/mv.py``, which imports nothing of the port) on the
CPU, at the stage-2a cell cut to a tiny size (``benchmark/tests/
mv_tiny.py``), on the benchmark's seeded weights: every bias, norm and
joint output projection drawn, so each fold adds to the output.

  * The CLIP embedding, the condition latents, one UNet output, one DDIM
    update and the decoded u8 images, each within its stated tolerance.
  * The cell's comparison (its loop's ``Session``, the look for a card and
    the harness's module guard left out: this suite loads JAX): the
    program within the cell's limits; the control and each planted fault
    past at least one.
  * One tiny uid's counters and spans: ``mv.unet.call`` = steps, each fold
    16 × steps (the published block layout), and the unit ``mv.uid`` over
    ``mv.encode``, a ``mv.step`` a step and ``mv.decode``.
"""
import dataclasses
import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, mv_inputs
from benchmark.loops import mv_loop
from benchmark.reference import mv as ref
from benchmark.tests.mv_tiny import CELL, ROOT, TINY_CONFIG, TINY_MIX
from drawingspinup_torch.core import profiling
from drawingspinup_torch.ops import diffusion as D
from drawingspinup_torch.pipelines import stage2_mv
from torch_threads import one_torch_thread  # noqa: F401

SEED = 2 ** 31 + 4321
STEPS = TINY_CONFIG["num_inference_steps"]


def rel(got, want) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


@pytest.fixture(scope="module")
def tiny():
    """The cell's configuration at the tiny size, its weights, a drawing
    and the port's pipeline on those weights (the UNet in f32)."""
    cfg = {**harness.find(ROOT, "configs", "wonder3d_mv"), **TINY_CONFIG}
    pcfg = mv_loop.pipeline_config(cfg)
    w = mv_inputs.weights(cfg, SEED, "cpu")
    mods = stage2_mv.build_modules(pcfg, torch.device("cpu"))
    for part, m in zip(("unet", "vae", "clip"), mods):
        m.load_state_dict(w[part], strict=True)
    pipe = stage2_mv.MVPipeline(
        dataclasses.replace(pcfg, compute_dtype="float32"), *mods)
    drawing = mv_inputs.drawings(cfg, 1, SEED, "cpu")[0]
    return cfg, w, pipe, drawing


def test_encodings_match_the_reference(tiny):
    """f32 on both sides. CLIP: summation orders alone (SDPA against the
    written-out softmax) leave ~4e-7. The condition latents: the port's
    VAE keeps torch's GroupNorm, whose folded mean cancels where a group's
    mean² ≫ its variance (one channel a group here), ~3e-5 from float64,
    where the reference's centred norm reads ~1e-6."""
    cfg, w, pipe, drawing = tiny
    embeds, cond = pipe.encode_image(drawing)
    r_embeds, r_cond = ref.encode(w["clip"], w["vae"], drawing, cfg)
    assert rel(embeds, r_embeds) < 1e-5
    assert rel(cond, r_cond) < 2e-4


def test_unet_output_and_update_match_the_reference(tiny):
    """One UNet call at an early timestep on latents of the spread a
    trajectory reaches there: f32 on both sides, the port's SDPA and
    GroupNorm against the written-out forms. The benchmark's selective
    attention (logits spread ~4) makes the call ill-conditioned in f32:
    each side lies ~1-4e-5 from the reference in float64, so the port is
    held within 1e-4 of the f32 reference and no farther from float64 than
    twice the f32 reference. The DDIM update of the reference's output
    with a noise draw, eta 1: the port's float64 table rounded to f32
    against diffusers' f32 table, ~1e-6 of the step's change (limit
    1e-5)."""
    cfg, w, pipe, drawing = tiny
    embeds, cond = pipe.encode_image(drawing)
    g = torch.Generator().manual_seed(1)
    lat = 3.0 * torch.randn((12, 4, 8, 8), generator=g)
    noise = torch.randn((12, 4, 8, 8), generator=g)
    ts = ref.timesteps(cfg)
    labels = torch.as_tensor(stage2_mv.sincos(
        stage2_mv.camera_task_embeddings(cfg["views"])))
    with torch.no_grad():
        eps = pipe.unet(torch.cat([lat, cond.expand(12, -1, -1, -1)], 1),
                        ts[1], embeds.expand(12, -1, -1), labels)
    r_eps = ref.predict_noise(w["unet"], lat, ts[1], embeds, cond, cfg)
    r64 = ref.predict_noise({k: v.double() for k, v in w["unet"].items()},
                            lat.double(), ts[1], embeds.double(),
                            cond.double(), cfg)
    assert rel(eps, r_eps) < 1e-4
    assert rel(eps, r64) < 2 * rel(r_eps, r64) + 1e-7
    nxt = D.ddim_step(pipe.cfg.ddim, pipe.acp, r_eps, ts[1], ts[2], lat,
                      eta=cfg["eta"], noise=noise)
    r_nxt = ref.ddim_step(cfg, ref.alphas_cumprod(cfg), r_eps, ts[1], lat,
                          noise)
    assert float((nxt - r_nxt).norm() / (r_nxt - lat).norm()) < 1e-5


def test_decoded_images_match_the_reference(tiny):
    """Decode, bicubic to 96², u8: f32 on both sides, so a value differs
    only where it lies within rounding of a quantisation step: at most 1
    LSB, on ~6e-5 of the values (limit 1e-3)."""
    cfg, w, pipe, _ = tiny
    lat = 6.0 * torch.randn((12, 4, 8, 8),
                            generator=torch.Generator().manual_seed(2))
    got = pipe.decode_u8(lat).cpu()
    d = (got.short() - ref.images_u8(w["vae"], lat, cfg).short()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3


def _readings(kind):
    cell = harness.Cell(ROOT, CELL, TINY_CONFIG,
                        {**TINY_MIX, "fault": kind} if kind in mv_loop.FAULTS
                        else TINY_MIX)
    with tempfile.TemporaryDirectory() as work:
        sess = cell.session(SEED, "cpu", work, control=kind == "control")
        sess.setup()
        win = sess.window(0.05)
        sess.free()
        return win, sess.check(), cell.cell["limits"]


@pytest.mark.parametrize("kind", ("program", "control") + mv_loop.FAULTS)
def test_comparison_passes_the_program_and_fails_the_rest(kind):
    win, readings, limits = _readings(kind)
    assert win["failed"] == 0 and win["units"] >= 1
    assert set(readings) == set(limits)
    over = {k for k, v in readings.items() if v > limits[k]}
    if kind == "program":
        assert not over, readings
    else:
        assert over, readings


def test_one_uid_counts_and_spans(tiny):
    cfg, _, pipe, drawing = tiny
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = pipe.images_u8(drawing, cfg["views"],
                                 torch.Generator().manual_seed(3))
        c = profiling.counters()
        recs = profiling.spans()
    finally:
        profiling.reset()
    assert out.shape == (12, 96, 96, 3) and out.dtype == torch.uint8
    assert c["mv.unet.call"] == STEPS
    assert [c[f"mv.attn.{k}"] for k in ("views", "domains", "cross")] \
        == [16 * STEPS] * 3
    (uid,) = [r for r in recs if r.name == "mv.uid"]
    assert uid.unit == uid.id and all(r.unit == uid.id for r in recs)
    children = sorted((r for r in recs if r.parent == uid.id),
                      key=lambda r: r.start_ns)
    assert [r.name for r in children] == \
        ["mv.encode"] + ["mv.step"] * STEPS + ["mv.decode"]
    assert sum(r.name == "mv.attn" for r in recs) == 3 * 16 * STEPS

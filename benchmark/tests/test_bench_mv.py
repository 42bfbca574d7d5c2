"""The stage-2a cell's own pieces: ``mv_work.py``'s counts against a hand
count and against torch's FLOP counter on the port's UNet at a tiny shape;
the cell's three per-layer readers at their bounds on hand-made contexts
and silent where there is nothing to read; and whole tiny runs of the
cell through the harness on the CPU (the look for a card skipped): the
program correct, the control and each fault of the loop not."""
import time

import pytest
import torch

from benchmark import harness, mv_work, work
from benchmark.loops import mv_loop
from benchmark.tests.mv_tiny import CELL, ROOT, TINY_CONFIG, TINY_MIX
from benchmark.tests.conftest import SEED

FULL = harness.find(ROOT, "configs", "wonder3d_mv")
TINY = {**FULL, **TINY_CONFIG}


def test_attention_cores_by_hand():
    """Tiny: 32 channels at 8², 4², 2², 1² latents, 6 views, 12 images."""
    want = []
    for side in (8, 8, 4, 4, 2, 2, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8):
        s = side * side
        want += [mv_work.Core("views", 2, 6 * s, 6 * s, 32),
                 mv_work.Core("domains", 6, 2 * s, 2 * s, 32),
                 mv_work.Core("cross", 12, s, 1, 32)]
    assert mv_work.attention_cores(TINY) == want
    a = mv_work.Core("views", 2, 384, 384, 32)
    assert mv_work.core_flops(a) == 4 * 2 * 384 * 384 * 32
    assert mv_work.core_bytes(a) == 2 * (2 * 384 * 32) * 4
    # the published widths: 16 blocks, the 32² views fold 96.6 GFLOP a call
    cores = mv_work.attention_cores(FULL)
    assert len(cores) == 48
    assert cores[0] == mv_work.Core("views", 2, 6144, 6144, 320)
    assert mv_work.core_flops(cores[0]) == pytest.approx(96.64e9, rel=1e-3)
    step = sum(mv_work.core_flops(a) for a in cores)
    assert step == pytest.approx(0.7344e12, rel=1e-3)
    # the folds are bound by their operations, the cross-attention cores
    # (one key) by their bytes
    assert mv_work.core_bound_s(cores[0]) == mv_work.core_flops(
        cores[0]) / mv_work.BF16_FLOPS
    cross = cores[2]
    assert cross == mv_work.Core("cross", 12, 1024, 1, 320)
    assert mv_work.core_bound_s(cross) == 2 * 12 * 320 * 2 * 1025 \
        / work.HBM_BYTES_PER_S
    assert mv_work.uid_attention_bound_s(FULL) == pytest.approx(
        75 * sum(mv_work.core_bound_s(a) for a in cores))


def test_unet_flops_equal_torch_counter():
    """The port's UNet at the tiny shape, one forward at batch 12: every
    convolution and linear map torch's FLOP counter sees, and no more; the
    attention cores (the counter does not see the CPU's SDPA) by hand
    above."""
    from torch.utils.flop_counter import FlopCounterMode

    from drawingspinup_torch.models.unet_mv2d import UNetMV2D

    pcfg = mv_loop.pipeline_config(TINY)
    unet = UNetMV2D(pcfg.unet).eval()
    x = torch.randn(12, 8, 8, 8)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        unet(x, 500, torch.randn(12, 1, 32), torch.randn(12, 10))
    cores = sum(mv_work.core_flops(a) for a in mv_work.attention_cores(TINY))
    assert mv_work.unet_flops(TINY) - cores == fc.get_total_flops()
    assert mv_work.uid_unet_flops(TINY) == 4 * mv_work.unet_flops(TINY)


class _Rec:
    def __init__(self, name, id_, unit):
        self.name, self.id, self.unit = name, id_, unit


def test_readers_at_the_bound(monkeypatch):
    """Each new reader reads 100 % at its bound (the idle share 0) on a
    hand-made context, and None where there is nothing to read."""
    from drawingspinup_torch.core import profiling

    read = lambda n, ctx: harness.reader(ROOT, n)(ctx)     # noqa: E731
    flops = mv_work.uid_unet_flops(FULL)
    window = {"units": 4, "seconds": 4 * flops / mv_work.BF16_FLOPS}
    trace = {"units": 1, "busy_s": window["seconds"] / 4, "launches": 10}
    ctx = {"config": FULL, "window": window, "trace": trace}
    assert read("unet_mfu.uid", ctx) == pytest.approx(100.0)
    assert read("device_idle_pct.uid", ctx) == pytest.approx(0.0)
    trace["busy_s"] = 0.0
    assert read("device_idle_pct.uid", ctx) is None

    # two traced uids under the profiler, the reader takes the last one:
    # its 48 cores' device times sum to the uid's bound
    bound = mv_work.uid_attention_bound_s(FULL)
    recs, times = [], {}
    for u in (1, 100):
        recs += [_Rec("mv.attn", u + i + 1, u) for i in range(48)]
        recs.append(_Rec("mv.uid", u, u))
        times.update({u + i + 1: (bound if u == 100 else 1.0) / 48
                      for i in range(48)})
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    monkeypatch.setattr(profiling, "device_times", lambda: times)
    trace["units"] = 1
    assert read("mv_attn_roofline.uid", ctx) == pytest.approx(100.0)
    monkeypatch.setattr(profiling, "device_times", lambda: {})
    assert read("mv_attn_roofline.uid", ctx) is None
    monkeypatch.delattr(profiling, "device_times")
    assert read("mv_attn_roofline.uid", ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read("mv_attn_roofline.uid", ctx) is None


def _run(**kw):
    torch.set_num_threads(2)
    return harness.run(ROOT, CELL, SEED, 0.05, False, time.perf_counter(),
                       device="cpu", config_overrides=TINY_CONFIG, **kw)


def test_program_is_correct():
    r = _run(mix_overrides=TINY_MIX)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", mv_loop.FAULTS)
def test_faults_are_not_correct(fault):
    r = _run(mix_overrides={**TINY_MIX, "fault": fault})
    assert not r["correct"], r["checks"]


def test_control_is_not_correct():
    r = _run(mix_overrides=TINY_MIX, control=True)
    assert not r["correct"], r["checks"]

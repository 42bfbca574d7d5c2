"""``core/profiling.py``, the port's one tracing system: spans nest by
thread and take the process's unit; with no profiler recording they only
add to their aggregates; under ``torch.profiler`` each is a
``user_annotation`` range of the Chrome trace on the store's clock; the
counters; a device-timed span's event pair; and the spans of frame serving
and of the GAN step where the work happens. The card-marked tests hold the
RIC kernels' spans and launch counters, and a device-timed span's time, on
CUDA. No JAX here, so that the card runs this file too."""
import contextlib
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from drawingspinup_torch.core import profiling
from drawingspinup_torch.pipelines.stage3_data import KeyframeData
from drawingspinup_torch.train import gan, gan_parallel

SMALL = dict(filters=(4, 8, 8, 8, 8, 4), batch_size=2, patch_size=16)
SERVE = ("serve.upload", "serve.forward", "serve.quantise", "serve.readback")
STEP = ("gan.sample", "gan.d_update", "gan.d_opt", "gan.g_update",
        "gan.g_opt")


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_by_thread_and_take_the_unit(monkeypatch):
    """Parents come from the span's own thread; the unit from the frame
    open in the process, on any thread (as on the autograd engine's, which
    inherits the profiler's state: stood in for here, as a plain thread
    does not); closing the frame closes it."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    seen = {}

    def engine_thread():
        with profiling.span("worker"):
            with profiling.span("worker.inner"):
                pass

    with profiling.span("outside"):
        pass
    with profiling.span("serve.frame", unit=True):
        with profiling.span("a"):
            with profiling.span("a.b"):
                pass
            t = threading.Thread(target=engine_thread)
            t.start()
            t.join(timeout=30)
            seen["alive"] = t.is_alive()
        with profiling.span("serve.frame", unit=True):  # inner: no unit
            pass
    with profiling.span("after"):
        pass
    assert not seen["alive"]
    r = {k: v[0] for k, v in _by_name(profiling.spans()).items()}
    frame = _by_name(profiling.spans())["serve.frame"]
    outer = [f for f in frame if f.unit == f.id]
    assert len(frame) == 2 and len(outer) == 1
    unit = outer[0].id
    assert r["outside"].unit is None and r["after"].unit is None
    assert r["outside"].parent is None and outer[0].parent is None
    assert r["a"].parent == unit and r["a.b"].parent == r["a"].id
    assert [f.parent for f in frame if f.id != unit] == [unit]
    # the other thread: its own stack, the process's unit
    assert r["worker"].parent is None
    assert r["worker.inner"].parent == r["worker"].id
    assert r["worker"].thread != r["a"].thread == r["a.b"].thread
    assert {r[k].unit for k in ("a", "a.b", "worker", "worker.inner")} \
        == {unit}
    for rec in profiling.spans():
        assert rec.start_ns <= rec.end_ns


@pytest.mark.parametrize("name, unit", [("serve.frame", False),
                                        ("recon.anything", True)])
def test_the_caller_declares_the_unit(name, unit, monkeypatch):
    """A span opens the process's unit by its ``unit`` flag, never by its
    name: ``serve.frame`` without the flag is a plain span, any name with
    it is a unit."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    with profiling.span(name, unit=unit):
        with profiling.span("inner"):
            pass
    r = {rec.name: rec for rec in profiling.spans()}
    want = r[name].id if unit else None
    assert r[name].unit == want and r["inner"].unit == want
    assert r["inner"].parent == r[name].id


@pytest.mark.parametrize("sync", [False, True])
def test_aggregate_and_ring_with_the_profiler_off(sync, monkeypatch):
    """Count, total, min, max, last and a ring of the last RING durations;
    no record, no range and no unit without a recording profiler."""
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    n = profiling.RING + 5
    for _ in range(n):
        with profiling.span("x", sync=sync):
            pass
    with profiling.span("serve.frame", unit=True):
        pass
    st = profiling.timings()["x"]
    ring = profiling.samples("x")
    assert st["count"] == n and len(ring) == profiling.RING
    assert st["min_s"] <= min(ring) <= max(ring) <= st["max_s"]
    assert st["last_s"] == ring[-1]
    assert st["total_s"] >= sum(ring)
    assert profiling.total("x") == st["total_s"]
    assert profiling.total("never") == 0.0 and profiling.samples("y") == []
    assert profiling.spans() == []
    assert "x" in profiling.report() and profiling.report("y") == ""


def test_spans_are_ranges_of_the_chrome_trace(tmp_path):
    """Each record is a user_annotation of the exported trace, of the same
    name, starting within 1 ms of the store's start."""
    with _recording() as prof:
        with profiling.span("gan.step", unit=True):
            with profiling.span("gan.d_update"):
                torch.ones(64).sum()
            with profiling.span("gan.d_opt"):
                torch.ones(64).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    recs = profiling.spans()
    assert {r.name for r in recs} == {"gan.step", "gan.d_update",
                                      "gan.d_opt"}
    for r in recs:
        starts = [e["ts"] * 1e3 + base for e in ranges.get(r.name, ())]
        assert len(starts) == 1, r.name
        assert abs(starts[0] - r.start_ns) < 1e6, r.name


def test_counters_reset_and_the_store_cap(monkeypatch):
    """Counters are always on and read 0 where never counted; past the
    store's cap records are dropped and counted; reset clears it all."""
    profiling.count("k")
    profiling.count("k", 4)
    c = profiling.counters()
    assert c["k"] == 5 and c["never"] == 0
    c["k"] = 0
    assert profiling.counters()["k"] == 5           # a copy
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with _recording():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3
    assert profiling.counters()[profiling.DROPPED] == 2
    assert profiling.timings()["s"]["count"] == 5
    profiling.reset()
    assert profiling.counters() == {} and profiling.spans() == []
    assert profiling.timings() == {}


def test_device_timed_span_only_under_a_profiler(monkeypatch):
    """``span(name, device=True)`` makes an event pair only while a
    profiler records (a stand-in clock here, as this host has no card), and
    ``device_times`` resolves it by the record's id; with none it makes no
    event and no record, and the record keeps its fields."""
    class Clock:
        made = 0

        def __init__(self):
            Clock.made += 1
            self.at = Clock.made

        def elapsed_time(self, end):
            return 2.0 * (end.at - self.at)        # ms

    monkeypatch.setattr(profiling, "_event", Clock)
    with profiling.span("mv.attn", device=True):
        pass
    assert Clock.made == 0 and profiling.spans() == []
    assert profiling.device_times() == {}
    assert profiling.timings()["mv.attn"]["count"] == 1
    with _recording():
        with profiling.span("mv.attn", device=True):
            with profiling.span("inner"):
                pass
    assert Clock.made == 2
    r = {rec.name: rec for rec in profiling.spans()}
    assert profiling.device_times() == {r["mv.attn"].id: 2e-3}
    assert r["inner"].parent == r["mv.attn"].id
    assert profiling.SpanRecord._fields == ("name", "start_ns", "end_ns",
                                            "id", "parent", "unit",
                                            "thread")
    profiling.reset()
    assert profiling.device_times() == {}


def _frame(size, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (size, size, 7), dtype=np.uint8)


def test_generate_full_rgba_records_one_frame():
    """A small GeneratorJ_RIC (eval) on the CPU: one serve.frame unit, its
    four children in order, and the 21 RIC forwards inside serve.forward,
    none of them launching a kernel."""
    torch.manual_seed(0)
    model = gan.build_generator(gan.GANConfig(**SMALL), "cpu",
                                torch.Generator().manual_seed(0))
    x = _frame(16, 1)
    with _recording():
        out = gan.generate_full_rgba(model, x, True, True, True)
    assert out.shape == (16, 16, 4) and out.dtype == np.uint8
    recs = profiling.spans()
    by = _by_name(recs)
    (frame,) = by["serve.frame"]
    assert frame.unit == frame.id
    children = sorted((r for r in recs if r.parent == frame.id),
                      key=lambda r: r.start_ns)
    assert tuple(r.name for r in children) == SERVE
    assert all(r.unit == frame.id for r in recs)
    parents = {r.id: r.parent for r in recs}
    names = {r.id: r.name for r in recs}

    def ancestors(r):
        p = r.parent
        while p is not None:
            yield names[p]
            p = parents[p]

    assert len(by["ric.fwd"]) == 21
    assert all("serve.forward" in ancestors(r) for r in by["ric.fwd"])
    assert "ric.fwd.launch" not in by
    assert profiling.counters()["ric.fwd.launch"] == 0
    assert profiling.timings()["serve.frame"]["count"] == 1


def _keyframe(size, device="cpu"):
    g = torch.Generator().manual_seed(3)
    yy, xx = torch.meshgrid(torch.arange(size), torch.arange(size),
                            indexing="ij")
    mask = ((yy - size // 2) ** 2 + (xx - size // 2) ** 2
            < (size // 3) ** 2).float()
    valid = torch.nonzero(mask > 0)
    return KeyframeData(
        pre=(torch.rand((size, size, 6), generator=g) * 2 - 1).to(device),
        post=(torch.rand((size, size, 3), generator=g) * 2 - 1).to(device),
        mask=mask.to(device), valid_yx=valid.to(device),
        n_valid=len(valid))


@pytest.mark.parametrize("step", ["train_step", "dp_step"])
def test_gan_step_records_its_phases(step):
    """One GAN step on the CPU (GeneratorJ_RIC), through ``train_step`` and
    through the data-parallel step at world 1: one gan.step unit, its five
    children in order, and the RIC backward inside it."""
    cfg = gan.GANConfig(resnet_blocks=1, **SMALL)
    state = gan.init_state(cfg, "cpu", seed=0)
    data = _keyframe(24)
    fn = gan_parallel.make_train_step_dp(cfg, 1) if step == "dp_step" \
        else lambda *a: gan.train_step(cfg, *a)
    with _recording():
        logs = fn(state, data, torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in logs.values())
    recs = profiling.spans()
    by = _by_name(recs)
    (unit,) = by["gan.step"]
    assert unit.unit == unit.id
    children = sorted((r for r in recs if r.parent == unit.id),
                      key=lambda r: r.start_ns)
    assert tuple(r.name for r in children) == STEP
    assert all(r.unit == unit.id for r in recs)
    assert by["ric.bwd"] and len(by["ric.fwd"]) >= len(by["ric.bwd"])
    g_update = next(r for r in children if r.name == "gan.g_update")
    assert all(g_update.start_ns <= r.start_ns <= r.end_ns
               <= g_update.end_ns for r in by["ric.bwd"])
    assert profiling.counters()["ric.bwd.launch"] == 0


@pytest.mark.cuda
def test_ric_spans_and_launches_on_the_card():
    """On CUDA: every ric.fwd holds one ric.fwd.launch, every ric.bwd its
    dz, dx (where the input takes a gradient) and dwk parts, and the launch
    counters equal the spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = gan.GANConfig(**SMALL)
    state = gan.init_state(cfg, dev, seed=0)
    data = _keyframe(24, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    gan.train_step(cfg, state, data, gen)       # builds the kernels
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        gan.train_step(cfg, state, data, gen)
        torch.cuda.synchronize()
    recs = profiling.spans()
    by = _by_name(recs)
    (unit,) = by["gan.step"]
    assert all(r.unit == unit.id for r in recs)
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r.name)
    assert all(kids.get(r.id) == ["ric.fwd.launch"] for r in by["ric.fwd"])
    for r in by["ric.bwd"]:
        assert sorted(kids[r.id]) in (["ric.bwd.dwk", "ric.bwd.dx",
                                       "ric.bwd.dz"],
                                      ["ric.bwd.dwk", "ric.bwd.dz"])
    c = profiling.counters()
    assert c["ric.fwd.launch"] == len(by["ric.fwd"]) == 22
    assert c["ric.bwd.launch"] == len(by["ric.bwd"]) == 21



@pytest.mark.cuda
def test_device_timed_span_on_the_card():
    """On CUDA a device-timed span around a matmul reads the card's time:
    positive, and within the profiler's own record of the kernel's time
    plus launch gaps (under 10 ms for a 2048² product)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn((2048, 2048), device="cuda")
    a @ a
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profiling.span("mv.attn", device=True):
            a @ a
    (rec,) = profiling.spans()
    t = profiling.device_times()[rec.id]
    assert 0 < t < 10e-3

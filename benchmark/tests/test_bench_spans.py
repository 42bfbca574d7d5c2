"""The readers of the program's span store: on a store made by hand they
take the traced window's frames alone (the last ``units`` ``serve.frame``
units), and read None where the program records nothing, or keeps no store
at all, as a program older than the store does. On the card: the kernels
launched inside the ``ric.fwd`` ranges of a traced frame are the RIC
forward that ``benchmark/tracing.py`` reads by name, so that the spans and
the kernels share one clock."""
import json
import types

import pytest
import torch

from benchmark import harness, tracing
from benchmark.tests.conftest import ROOT
from drawingspinup_torch.core import profiling

FRAME_METRICS = {"frame_upload_ms.serve": "serve.upload",
                 "frame_dispatch_ms.serve": "serve.forward",
                 "frame_readback_ms.serve": "serve.readback"}


class Store:
    """SpanRecords made by hand, a frame at a time."""

    def __init__(self):
        self.records, self.next_id = [], 1

    def _new(self, name, start, end, parent, unit):
        rid = self.next_id
        self.next_id += 1
        self.records.append(profiling.SpanRecord(
            name, start, end, rid, parent, unit, 1))
        return rid

    def frame(self, t0, parts, ric_ns=()):
        """A serve.frame from ``t0`` (ns) whose children last
        ``parts[name]`` ns each, in the frame's order, and RIC forwards of
        ``ric_ns`` inside serve.forward. Records are kept in closing order,
        as the program keeps them."""
        unit = self.next_id
        self.next_id += 1
        t = t0
        for name in ("serve.upload", "serve.forward", "serve.quantise",
                     "serve.readback"):
            if name == "serve.forward":
                for d in ric_ns:
                    self._new("ric.fwd", t, t + d, None, unit)
            self._new(name, t, t + parts.get(name, 0), unit, unit)
            t += parts.get(name, 0)
        self.records.append(profiling.SpanRecord(
            "serve.frame", t0, t, unit, None, unit, 1))


def _read(name, store, units, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(store.records))
    return harness.reader(ROOT, name)({"trace": {"units": units}})


@pytest.mark.parametrize("metric", sorted(FRAME_METRICS))
def test_frame_readers_take_the_window_median(metric, monkeypatch):
    """One warm-up frame of 50 ms, then three window frames of 1, 3 and 2
    ms under the metric's span (the middle one in two spans): the median
    of the window's per-frame sums, 2 ms; a span outside any frame is not
    read."""
    span = FRAME_METRICS[metric]
    s = Store()
    s.frame(0, {span: 50_000_000})
    for i, ms in enumerate((1, 3, 2)):
        s.frame((i + 1) * 10 ** 8, {span: ms * 10 ** 6})
    # the middle frame's span split in two: its sum still reads 3 ms
    mid = next(r for r in s.records if r.name == "serve.frame"
               and r.start_ns == 2 * 10 ** 8)
    s.records.append(profiling.SpanRecord(span, 0, 0, 999, mid.id, mid.id,
                                          1))
    s.records.append(profiling.SpanRecord(span, 0, 10 ** 9, 1000, None,
                                          None, 1))
    assert _read(metric, s, 3, monkeypatch) == pytest.approx(2.0)
    assert _read(metric, s, 4, monkeypatch) == pytest.approx(2.5)


def test_ric_fwd_host_reader_takes_the_window_median(monkeypatch):
    """The median single ric.fwd duration of the window's frames, in µs;
    the warm-up frame's are left out."""
    s = Store()
    s.frame(0, {"serve.forward": 10 ** 6}, ric_ns=[900_000] * 5)
    s.frame(10 ** 8, {"serve.forward": 10 ** 6},
            ric_ns=[40_000, 50_000, 60_000])
    s.frame(2 * 10 ** 8, {"serve.forward": 10 ** 6},
            ric_ns=[70_000, 80_000])
    assert _read("ric_fwd_host_us.serve", s, 2, monkeypatch) \
        == pytest.approx(60.0)


@pytest.mark.parametrize("metric", sorted(FRAME_METRICS)
                         + ["ric_fwd_host_us.serve"])
def test_span_readers_read_none_without_spans(metric, monkeypatch):
    """None on an empty store, on frames without the span (the plain
    generator has no ric.fwd), and where the program has no store."""
    assert _read(metric, Store(), 20, monkeypatch) is None
    s = Store()
    s.frame(0, {})
    s.records = [r for r in s.records
                 if r.name in ("serve.frame", "serve.quantise")]
    assert _read(metric, s, 20, monkeypatch) is None
    # a program without the store
    monkeypatch.setattr("drawingspinup_torch.core.profiling",
                        types.SimpleNamespace())
    assert harness.reader(ROOT, metric)({"trace": {"units": 20}}) is None


@pytest.mark.cuda
def test_ric_fwd_spans_hold_the_kernels_read_by_name(tmp_path):
    """A traced 512² frame of a full-width GeneratorJ_RIC: the device time
    of the kernels launched (by correlation id) inside ric.fwd ranges is
    the RIC forward time the trace's reduction reads by kernel name,
    within 1 %, and the ranges are the store's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from drawingspinup_torch.train import gan

    dev = torch.device("cuda")
    model = gan.build_generator(gan.GANConfig(), dev,
                                torch.Generator(dev).manual_seed(0))
    x = np.random.default_rng(0).integers(0, 256, (512, 512, 7),
                                          dtype=np.uint8)
    gan.generate_full_rgba(model, x, True, True, False)     # builds
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.WINDOW):
            gan.generate_full_rgba(model, x, True, True, False)
            torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = tracing.summarize(events, 1)["ric_fwd_s"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = [e for e in xs if e.get("cat") == "user_annotation"
              and e["name"] == "ric.fwd"]
    assert len(ranges) == 21
    assert len([r for r in profiling.spans() if r.name == "ric.fwd"]) == 21

    def inside(e):
        return any(r["tid"] == e["tid"]
                   and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]
                   for r in ranges)

    launched = {e["args"]["correlation"] for e in xs
                if e.get("cat", "").startswith(tracing.CUDA_API)
                and "correlation" in e.get("args", {}) and inside(e)}
    by_span = sum(e["dur"] for e in xs if e.get("cat") in tracing.DEVICE_CATS
                  and e.get("args", {}).get("correlation") in launched) * 1e-6
    assert by_name > 0
    assert by_span == pytest.approx(by_name, rel=1e-2)

"""The measuring path: without a card, and in a directory that holds only
``BENCHMARK.json`` and the benchmark's files, a run exits with another
code than 0 and prints no result; the trace's reduction and the per-layer
readers on a trace made by hand; the cells on the card."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, tracing, work
from benchmark.tests.conftest import ROOT, SEED

ARGS = ["--workload", "style2_plain.serve", "--seed", str(SEED),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = _run(ROOT, env)
    _no_result(proc)
    assert "needs 1 CUDA device" in proc.stderr


def test_fewer_cards_than_the_cell_asks(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert harness.main(ARGS, 0.0, ROOT) != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(str(tmp_path)))


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_reduction():
    """A window of 100 µs: a forward RIC kernel (10 µs), a backward node on
    another thread whose launch starts a GEMM (20 µs) and a copy (5 µs), a
    plain kernel (15 µs); the host in an op during the first gap."""
    ev = [_x(tracing.WINDOW, "user_annotation", 1000, 100),
          _x("aten::conv", "cpu_op", 1000, 12),
          _x("autograd::engine::evaluate_function: RICConvFunctionBackward",
             "cpu_op", 1030, 40, tid=2),
          _x("cudaLaunchKernel", "cuda_runtime", 1001, 1, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 1031, 1, tid=2,
             correlation=2),
          _x("cudaMemcpyAsync", "cuda_runtime", 1035, 1, tid=2,
             correlation=3),
          _x("cudaLaunchKernel", "cuda_runtime", 1060, 1, correlation=4),
          _x("void ric_conv_fwd_kernel<64, 4>", "kernel", 1010, 10,
             correlation=1),
          _x("void ric_conv_bwd_gemm_kernel<true>", "kernel", 1040, 20,
             correlation=2),
          _x("Memcpy DtoD", "gpu_memcpy", 1060, 5, correlation=3),
          _x("elementwise", "kernel", 1070, 15, correlation=4),
          _x("late", "kernel", 1200, 5, correlation=9)]
    s = tracing.summarize(ev, units=2)
    assert s["launches"] == 4
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["ric_fwd_s"] == pytest.approx(10e-6)
    assert s["ric_bwd_s"] == pytest.approx(25e-6)
    idle = dict(s["idle_gaps"])
    assert idle["aten::conv"] == pytest.approx(10e-6)      # 1000-1010
    # 1020-1040 and 1065-1070: the backward node on the engine's thread
    assert idle["autograd::engine::evaluate_function: "
                "RICConvFunctionBackward"] == pytest.approx(25e-6)
    assert sum(idle.values()) == pytest.approx(50e-6)
    assert s["device_ops"][0] == ["void ric_conv_bwd_gemm_kernel<true>",
                                  pytest.approx(20e-6)]


def test_readers_on_a_trace_at_the_bound():
    """A traced RIC time equal to the bound reads 100 %; none read 0 where
    there is nothing to read."""
    cfg = harness.find(ROOT, "configs", "style1_ric")
    fwd, bwd = work.ric_launches(cfg, 40, 32, True)
    serve, _ = work.ric_launches(cfg, 1, 512, False)
    trace = {"units": 3, "launches": 3000, "busy_s": 0.03, "window_s": 0.1,
             "ric_fwd_s": 3 * work.ric_fwd_bound_ms(fwd) * 1e-3,
             "ric_bwd_s": 3 * work.ric_bwd_bound_ms(bwd) * 1e-3}
    ctx = {"config": cfg, "trace": trace,
           "window": {"units": 100, "seconds": 4.0}}
    read = lambda n: harness.reader(ROOT, n)(ctx)      # noqa: E731
    assert read("ric_fwd_roofline.train") == pytest.approx(100.0)
    assert read("ric_bwd_roofline.train") == pytest.approx(100.0)
    assert read("launches_per_step.train") == pytest.approx(1000.0)
    # busy 10 ms a step against the measured window's 40 ms a step
    assert read("device_idle_pct.train") == pytest.approx(75.0)
    assert read("step_mfu.train") == pytest.approx(
        100 * work.train_step_flops(cfg) * 25 / 165e12)
    trace["ric_fwd_s"] = 3 * work.ric_fwd_bound_ms(serve) * 1e-3 * 2
    assert read("ric_fwd_roofline.serve") == pytest.approx(50.0)
    trace.update(ric_fwd_s=0.0, ric_bwd_s=0.0, busy_s=0.0, launches=0)
    for name in ("ric_fwd_roofline.train", "ric_bwd_roofline.train",
                 "ric_fwd_roofline.serve", "device_idle_pct.train",
                 "launches_per_step.train"):
        assert read(name) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.spec(ROOT)["workloads"]])
def test_cell_on_the_card(cell):
    """Each cell whole on the card, traced: correct, with every per-layer
    metric its files list."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    r = harness.run(ROOT, cell, SEED, 2.0, True, time.perf_counter())
    assert r["correct"], r["checks"]
    want = {m["name"] for m in harness.per_layer(harness.spec(ROOT), cell)}
    assert set(r["metrics"]) == want

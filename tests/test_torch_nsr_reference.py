"""The stage-2b benchmark cell on the CPU: the port's NSR step against the
benchmark's plain reference (``benchmark/reference/nsr.py``), the cell's
comparison on the program, its control and its faults, the step's spans
and band counters, and the hash-grid kernels' byte counts.

Tiny sizes: 64 rays of 8 + 8 samples (64 probe points), 4 levels of at
most 2^10 rows (base resolution 8, scale 1.5: one dense level, three
hashed), MLPs 16 wide, six 32² views of a sphere (the step) or of the
synthetic character (the cell). Tolerances, each with its reason:
  * f32: the weighted loss terms within relative 1e-5 (measured 6e-7:
    summation order, the closed-form jacobian against autograd's); each
    leaf's gradient within relative L2 1e-3 of the larger of the leaf's
    and the median leaf's norm (measured 2.7e-4 on a hashed table: the
    table gradient's fixed-point terms); each leaf's update by stage 3's
    norm gap within 5e-3 (measured 8e-4: Adam divides by √ν, so elements
    whose gradient is near zero amplify round-off, and their relative L2
    reads 0.13);
  * bf16 tables and compute: the cell's measures (the weighted terms'
    worst relative gap, 1 − the cosine of the whole gradients, stage 3's
    norm gap of the updates) within 0.3, 3e-3 and 0.03 (measured 0.14,
    3.6e-4 and 0.009: the bf16 SDF's absolute error near the surface,
    amplified by inv_s and by the sparsity term's exp(-100|sdf|)).
"""
import ast
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness, nsr_work
from benchmark.loops import recon_loop
from benchmark.reference import nsr as ref
from drawingspinup_torch.core import profiling
from drawingspinup_torch.core.config import load_config
from drawingspinup_torch.pipelines import stage2_recon
from drawingspinup_torch.train import nsr
from drawingspinup_torch.utils.synthetic import sphere_dataset
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "neus_ortho.train"
SEED = 2 ** 31 + 24
TINY = {"image_size": 32, "train_num_rays": 64, "n_coarse": 8, "n_fine": 8,
        "n_random_pts": 64, "max_steps": 30,
        "grid": {"n_levels": 4, "n_features_per_level": 2,
                 "log2_hashmap_size": 10, "base_resolution": 8,
                 "per_level_scale": 1.5, "include_xyz": True,
                 "start_level": 2, "start_step": 0, "update_steps": 10,
                 "dense_cell_rows": True},
        "sdf_mlp": {"n_neurons": 16, "n_hidden_layers": 1,
                    "sphere_init": True, "sphere_init_radius": 0.5,
                    "weight_norm": True},
        "radiance_mlp": {"n_neurons": 16, "n_hidden_layers": 2,
                         "output_activation": "sigmoid"}}
TINY_MIX = {"warmup_steps": 6, "checked_within": 6, "checked_steps": 6}


def _config(dtype="float32", **kw):
    cfg = {**harness.find(REPO, "configs", "neus_ortho"), **TINY, **kw}
    cfg["table_dtype"] = cfg["compute_dtype"] = dtype
    return cfg


def _gaps(dtype):
    """One port step and the reference's from the same state and draws,
    after 5 steps from the seeded init on a 32² sphere: per weighted loss
    term the relative gap, per leaf the gradient's and the update's
    relative L2 gap and stage 3's norm gap, each over the larger of the
    leaf's and the median leaf's reference norm, and 1 − the cosine of the
    whole gradients."""
    cfg = _config(dtype)
    ncfg = recon_loop.nsr_config(cfg)
    data = sphere_dataset(6, 32, hull=True)
    state = nsr.init_state(ncfg, 7)
    opt = nsr.make_optimizer(ncfg)
    g = torch.Generator().manual_seed(8)
    for k in range(6):
        s = recon_loop.schedule_step(cfg, k)
        state.step = state.opt_state.count = s
        n_active = ncfg.sdf.grid.current_level(s)
        draws = nsr.make_draws(ncfg, 6, 32, 32, g, "cpu")
        before = {n: p.detach().clone() for n, p in
                  nsr.named_leaves(state.params)}
        mu = {n: v.clone() for n, v in state.opt_state.mu.items()}
        nu = {n: v.clone() for n, v in state.opt_state.nu.items()}
        logs = nsr.train_step(ncfg, opt, state, data, draws, n_active)
    want = ref.train_step(cfg, before, mu, nu, s, s, n_active, data,
                          draws._asdict())
    names = sorted(want["grads"])
    leaves = dict(nsr.named_leaves(state.params))
    out = {"loss": {t: abs(float(logs[t]) * cfg["loss"][w]
                           - want["terms"][t]) / abs(want["terms"][t])
                    for t, w in ref.TERMS}}
    got = torch.cat([leaves[n].grad.double().reshape(-1) for n in names])
    exp = torch.cat([want["grads"][n].double().reshape(-1) for n in names])
    out["grad_cos"] = float(1 - got @ exp / (got.norm() * exp.norm()))
    for kind, got, exp in (
            ("grad", {n: leaves[n].grad.float() for n in names},
             want["grads"]),
            ("change", {n: leaves[n].detach().float() - before[n].float()
                        for n in names},
             {n: want["params"][n].to(before[n].dtype).float()
              - before[n].float() for n in names})):
        floor = float(np.median([float(exp[n].norm()) for n in names]))
        out[kind] = {n: float((got[n] - exp[n]).norm())
                     / max(float(exp[n].norm()), floor) for n in names}
        out[kind + "_norm"] = {n: abs(float(got[n].norm())
                                      - float(exp[n].norm()))
                               / max(float(exp[n].norm()), floor)
                               for n in names}
    return out


def test_config_is_the_programs_yaml():
    """The benchmark's configuration builds the step that the program's
    yaml builds."""
    cfg = harness.find(REPO, "configs", "neus_ortho")
    yaml = load_config(os.path.join(REPO, cfg["program_config"]))
    assert recon_loop.nsr_config(cfg) == \
        stage2_recon.nsr_config_from_yaml(yaml)
    assert cfg["reduced"] == []


def test_schedule_rotates_the_band_phases():
    cfg = harness.find(REPO, "configs", "neus_ortho")
    grid = recon_loop.nsr_config(cfg).sdf.grid
    steps = [recon_loop.schedule_step(cfg, k) for k in range(3000)]
    assert steps[:6] == [0, 1000, 2000, 1, 1001, 2001]
    assert sorted(steps) == list(range(3000))
    bands = [grid.current_level(s) for s in steps]
    assert bands[:3] == [4, 5, 6] and bands.count(5) == 1000


def test_f32_step_matches_the_reference():
    gaps = _gaps("float32")
    assert max(gaps["loss"].values()) < 1e-5, gaps["loss"]
    assert max(gaps["grad"].values()) < 1e-3, gaps["grad"]
    assert max(gaps["change_norm"].values()) < 5e-3, gaps["change_norm"]


def test_bf16_step_near_the_reference():
    gaps = _gaps("bfloat16")
    assert max(gaps["loss"].values()) < 0.3, gaps["loss"]
    assert gaps["grad_cos"] < 3e-3, gaps["grad_cos"]
    assert max(gaps["change_norm"].values()) < 0.03, gaps["change_norm"]


@pytest.mark.parametrize("kind", ["program", "control", "no_eikonal",
                                  "fine_no_grad"])
def test_check_on_the_program_control_and_faults(kind, monkeypatch):
    """The cell whole at the tiny sizes in f32 (its limits as the card's
    cell sets them): correct on the program, not on the control (MLP
    inputs through float8_e4m3fn) or either planted fault. This process
    holds JAX (the tests' conftest), which a benchmark run refuses:
    ``benchmark/tests`` test that guard."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    mix = dict(TINY_MIX, **({"fault": kind} if kind in recon_loop.FAULTS
                            else {}))
    r = harness.run(REPO, CELL, SEED, 0.05, False, time.perf_counter(),
                    device="cpu", control=kind == "control",
                    config_overrides=_config(), mix_overrides=mix)
    assert r["correct"] == (kind == "program"), r["checks"]
    assert r["metrics"]["images_per_s"]["value"] > 0
    assert [c[2] for c in r["detail"]["checked"]] == [2, 3, 4] * 2


def test_step_spans_and_band_counters():
    """``nsr.step`` is the unit of its six parts; one ``nsr.band.<n>``
    count a step, rotating 2/3/4 at the tiny band (4/5/6 at the
    published one)."""
    cfg = _config()
    ncfg = recon_loop.nsr_config(cfg)
    data = sphere_dataset(6, 16, hull=True)
    state, opt = nsr.init_state(ncfg, 3), nsr.make_optimizer(ncfg)
    g = torch.Generator().manual_seed(4)
    before, n0 = profiling.counters(), len(profiling.spans())
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for k in range(3):
            s = recon_loop.schedule_step(cfg, k)
            state.step = s
            nsr.train_step(ncfg, opt, state, data,
                           nsr.make_draws(ncfg, 6, 16, 16, g, "cpu"),
                           ncfg.sdf.grid.current_level(s))
    counted = profiling.counters() - before
    assert {k: v for k, v in counted.items() if k.startswith("nsr.band.")} \
        == {"nsr.band.2": 1, "nsr.band.3": 1, "nsr.band.4": 1}
    records = profiling.spans()[n0:]
    units = [r for r in records if r.name == "nsr.step"]
    assert len(units) == 3 and all(r.unit == r.id for r in units)
    parts = ("nsr.rays", "nsr.coarse", "nsr.fine", "nsr.loss",
             "nsr.backward", "nsr.update")
    for u in units:
        inside = [r.name for r in records if r.parent == u.id]
        assert sorted(inside) == sorted(parts)
        assert all(r.unit == u.id for r in records if r.parent == u.id)


def test_hashgrid_work_and_roofline_reader():
    """The byte counts on points placed by hand, the kernels' seconds from
    a trace's events by name, and the reader at the bound (100 %), at half
    of it (a kernel not found counts neither bytes nor time) and with
    nothing to read."""
    levels = [(r, ref.is_dense(TINY["grid"], r))
              for r in ref.resolutions(TINY["grid"])]
    assert levels == [(8, True), (12, False), (18, False), (27, False)]
    one = torch.tensor([[0.51, 0.52, 0.53]])
    two = torch.tensor([[0.51, 0.52, 0.53], [0.52, 0.53, 0.54]])
    assert nsr_work.touched_rows(one, levels, 1, True, 1024) == 8
    assert nsr_work.touched_rows(two, levels, 1, True, 1024) == 8
    assert nsr_work.touched_rows(two, levels, 2, True, 1024) == 16
    assert nsr_work.encode_work(2, 8, 4, 2, 1, 2, 2, True) == (
        24 + 8 * 2 * 2 + 4 * 2 * 4 * 2 * 2, 4 * 2 * 1 * 8 * 6)
    grads = nsr_work.table_grad_work(2, 729, 2, 1, 2, 2, True)
    assert grads == {"scale": (4 * 2 * 1 * 2 * 2, 0),
                     "scatter": (24, 2 * 1 * 8 * 24),
                     "convert": (729 * 2 * 2, 0)}
    work = {"fwd": 1e6, "fwd_jac": 4e6, "bwd_scale": 1e6,
            "bwd_scatter": 1e6, "bwd_convert": 3e6}
    names = {"fwd": "void (anonymous namespace)::hashgrid_fwd_kernel<2, "
                    "__nv_bfloat16, __nv_bfloat16, false>(float const*",
             "fwd_jac": "void (anonymous namespace)::hashgrid_fwd_kernel<2, "
                        "__nv_bfloat16, __nv_bfloat16, true>(float const*",
             "bwd_scale": "void (anonymous namespace)::"
                          "hashgrid_bwd_scale_kernel<2, __nv_bfloat16, true>",
             "bwd_scatter": "void (anonymous namespace)::"
                            "hashgrid_bwd_scatter_kernel<2, __nv_bfloat16, "
                            "true>",
             "bwd_convert": "void (anonymous namespace)::"
                            "hashgrid_bwd_convert_kernel<2, __nv_bfloat16>"}
    # each kernel in two launches at the bound, a copy and another kernel
    events = [{"ph": "X", "cat": "kernel", "name": names[k], "dur": d}
              for k, v in work.items()
              for d in (0.25e6 * v / nsr_work.HBM_BYTES_PER_S,
                        0.75e6 * v / nsr_work.HBM_BYTES_PER_S)]
    events += [{"ph": "X", "cat": "gpu_memcpy", "name": names["fwd"],
                "dur": 5.0},
               {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
                "dur": 7.0}]
    secs = nsr_work.kernel_seconds(events)
    assert secs == pytest.approx({k: v / nsr_work.HBM_BYTES_PER_S
                                  for k, v in work.items()})
    read = harness.reader(REPO, "hashgrid_roofline.recon")
    ctx = {"window": {"hashgrid": {"bytes": work, "seconds": secs,
                                   "steps": 3}}}
    assert read(ctx) == pytest.approx(100.0)
    ctx["window"]["hashgrid"]["seconds"] = dict(
        {k: 2 * v for k, v in secs.items()}, fwd=0.0)
    assert read(ctx) == pytest.approx(50.0)
    ctx["window"]["hashgrid"]["seconds"] = dict.fromkeys(secs, 0.0)
    assert read(ctx) is None
    assert read({"window": {"hashgrid": {}}}) is None


def test_benchmark_modules_load_no_jax():
    """The cell's modules load no JAX and nothing of the JAX package; the
    reference imports nothing of the port."""
    code = ("import sys\n"
            "import benchmark.loops.recon_loop, benchmark.nsr_work\n"
            "import benchmark.recon_inputs, benchmark.reference.nsr\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
            "              'drawingspinup_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    with open(os.path.join(REPO, "benchmark", "reference", "nsr.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "typing", "numpy", "torch"}

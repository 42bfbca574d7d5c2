"""PyTorch port, the batch sweep: ``core/metrics.py``,
``pipelines/sweep.py`` and ``cli/sweep.py`` against the JAX package's
originals on the CPU.

  * the JSONL logger writes the original's lines;
  * ``stage_done`` equals JAX's on the same trees, stage by stage as a
    uid's outputs appear (a finished style training is each package's own
    final checkpoint: ``model_99999.pt`` here, JAX's ``model_99999``);
  * two tiny drawing uids and a broken one through the port's stage CLIs
    with ``--device cpu`` (stage 1 at a narrow width, the mv contract
    filled by the sphere fixture as the goldens do, recon at a tiny
    budget): the log holds JAX's stage-major order, the broken uid fails at
    stage 1 and the others complete; a resumed run skips every stage of
    the finished uids; uid-major order as JAX's;
  * the CLI's flags: --mode and --pin-chip as JAX checks them,
    CUDA_VISIBLE_DEVICES set by --pin-chip, --mode latency (the default
    without --pin-chip) over two GPUs without torchrun raising with the
    torchrun line.
"""

import json
import os

import pytest
import torch

from drawingspinup_tpu.core import UidPaths as JPaths
from drawingspinup_tpu.core import metrics as jmetrics
from drawingspinup_tpu.pipelines import sweep as jsweep
from drawingspinup_torch.cli import sweep as tcli
from drawingspinup_torch.core import device as device_setup
from drawingspinup_torch.core import metrics as tmetrics
from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.pipelines import sweep as tsweep
from drawingspinup_torch.utils.synthetic import (
    write_drawing_uid, write_sphere_mv,
)
from torch_native_guard import ensure_jax_native
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREDICT = [os.path.join(REPO, "drawingspinup_torch", "configs",
                        "lama-fourier.yaml"),
           "generator.ngf=8", "generator.n_downsampling=2",
           "generator.n_blocks=1", "--size", "64", "--batch-size", "1"]
RECON = ["trainer.max_steps=30", "system.constant_steps=10",
         "dataset.imSize=[64, 64]", "model.train_num_rays_fixed=128",
         "model.geometry.isosurface.resolution=48",
         "model.geometry.face_count=1000",
         "model.geometry.xyz_encoding_config.n_levels=4",
         "model.geometry.xyz_encoding_config.log2_hashmap_size=12",
         "model.geometry.xyz_encoding_config.base_resolution=8",
         "model.geometry.xyz_encoding_config.start_level=4",
         "model.geometry.mlp_network_config.n_neurons=16",
         "model.texture.mlp_network_config.n_neurons=16"]
STAGES = ("stage1", "mv", "recon")


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library, built under a lock if another worker's
    build raced this one's."""
    ensure_jax_native()


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metrics_logger_is_the_original(tmp_path):
    rec = {"uid": "a", "stage": "recon", "seconds": 1.5, "ts": 3.0,
           "t": torch.tensor(2.5), "nested": {"v": [torch.tensor(1), 2]}}
    for mod, name in ((tmetrics, "t.jsonl"), (jmetrics, "j.jsonl")):
        logger = mod.MetricsLogger(str(tmp_path / "d" / name))
        logger.log(**rec)
        logger.log(uid="b", stage="FAILED", ts=4.0, error="x")
    assert (tmp_path / "d" / "t.jsonl").read_text() == \
        (tmp_path / "d" / "j.jsonl").read_text()


def _touch(path, content=b"x"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(content)


def test_stage_done_equals_jax(tmp_path):
    """Each step adds one stage's outputs (or a partial one) to a uid's
    tree; after each, every stage's verdict agrees with JAX's."""
    root = str(tmp_path)
    t, j = UidPaths(root, "u"), JPaths(root, "u")
    logs = [os.path.join(t.mesh_dir, f"logs_stage{k}_mask_pos")
            for k in (1, 2)]
    steps = [
        lambda: None,
        lambda: _touch(t.inpainted),
        lambda: _touch(t.mv("color", "front")),
        lambda: os.makedirs(t.mesh_dir),
        lambda: _touch(os.path.join(t.mesh_dir, "it3000-mc512-f5_r.obj")),
        lambda: os.makedirs(os.path.join(t.render_dir, "rest_pose")),
        lambda: os.makedirs(os.path.join(t.render_dir, "walk", "res_stage1")),
        lambda: _touch(os.path.join(t.render_dir, "walk", "res_stage1",
                                    "0.png")),
        lambda: _touch(os.path.join(t.render_dir, "rest_pose", "res_stage2",
                                    "0.png")),
        # stage 1's final checkpoints only: not done in either
        lambda: (_touch(os.path.join(logs[0], "model_99999.pt")),
                 _touch(os.path.join(logs[0], "model_99999"))),
        lambda: (_touch(os.path.join(logs[1], "model_99999.pt")),
                 _touch(os.path.join(logs[1], "model_99999"))),
        lambda: os.makedirs(t.gif_dir),
        lambda: _touch(t.gif("walk")),
    ]
    seen = set()
    for step in steps:
        step()
        verdicts = {s: tsweep.stage_done(t, s) for s in tsweep.STAGES}
        assert verdicts == {s: jsweep.stage_done(j, s)
                            for s in jsweep.STAGES}
        seen |= {s for s, v in verdicts.items() if v}
    assert seen == set(tsweep.STAGES)
    # JAX's checkpoint alone is not the port's
    for d in logs:
        os.remove(os.path.join(d, "model_99999.pt"))
    assert not tsweep.stage_done(t, "train_style")
    assert jsweep.stage_done(j, "train_style")


def _counted(fns, calls):
    def wrap(stage, fn):
        def run(uid):
            calls.append((uid, stage))
            fn(uid)
        return run
    return {s: wrap(s, fn) for s, fn in fns.items()}


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """Two tiny drawing uids and one without a drawing, swept once through
    the port's stage CLIs on the CPU; (root, uid list, result, calls)."""
    root = str(tmp_path_factory.mktemp("sweep"))
    for uid in ("a", "b"):
        write_drawing_uid(root, uid, size=64)
    uids = os.path.join(root, "uids.json")
    with open(uids, "w") as f:
        json.dump(["a", "broken", "b"], f)
    fns = tcli.stage_functions(root, "cpu", predict_args=PREDICT,
                               recon_overrides=RECON)
    fns["mv"] = lambda uid: write_sphere_mv(root, uid, size=64)
    calls = []
    result = tsweep.run_sweep(root, uids, _counted(
        {s: fns[s] for s in STAGES}, calls))
    return root, uids, result, calls, fns


def test_sweep_on_cpu_logs_jaxs_order(swept, tmp_path):
    root, uids, result, calls, _ = swept
    assert result == {"ok": ["a", "b"], "failed": ["broken"]}
    log = _log(os.path.join(root, "sweep_log.jsonl"))
    got = [(r["uid"], r["stage"]) for r in log]

    # JAX's sweep over stand-ins that fail where the port's stages failed
    def stand_in(stage):
        def fn(uid):
            if uid == "broken":
                raise RuntimeError("no drawing")
        return fn
    jax_log = str(tmp_path / "jax_log.jsonl")
    jsweep.run_sweep(root, uids, {s: stand_in(s) for s in STAGES},
                     resume=False, log_path=jax_log)
    assert got == [(r["uid"], r["stage"]) for r in _log(jax_log)]
    assert got[:2] == [("a", "stage1"), ("broken", "FAILED")]
    assert got[-2:] == [("a", "done"), ("b", "done")]
    assert calls == [(u, s) for s in STAGES for u in ("a", "broken", "b")
                     if s == "stage1" or u != "broken"]
    for r in log:
        if r["stage"] not in ("FAILED", "done"):
            assert r["seconds"] > 0 and "ts" in r
    for uid in ("a", "b"):
        p = UidPaths(root, uid)
        assert os.path.exists(p.inpainted)
        objs = [f for f in os.listdir(p.mesh_dir) if f.endswith(".obj")]
        assert objs == ["it30-mc48-f1000_c_r_s_cbp.obj"]
        for s in STAGES:
            assert tsweep.stage_done(p, s) == jsweep.stage_done(
                JPaths(root, uid), s) == True  # noqa: E712


def test_resumed_sweep_skips_every_done_stage(swept):
    root, uids, _, _, fns = swept
    calls = []
    log = os.path.join(root, "resume.jsonl")
    result = tsweep.run_sweep(root, uids, _counted(
        {s: fns[s] for s in STAGES}, calls), log_path=log)
    assert result == {"ok": ["a", "b"], "failed": ["broken"]}
    assert calls == [("broken", "stage1")]
    assert [(r["uid"], r["stage"]) for r in _log(log)] == [
        ("broken", "FAILED"), ("a", "done"), ("b", "done")]


def test_uid_major_order_is_jaxs(tmp_path):
    root = str(tmp_path)
    uids = os.path.join(root, "uids.json")
    with open(uids, "w") as f:
        json.dump(["x", "bad", "y", "z"], f)

    def fns(calls):
        def make(stage):
            def fn(uid):
                calls.append((uid, stage))
                if (uid, stage) == ("bad", "recon"):
                    raise ValueError("broken mesh")
            return fn
        return {s: make(s) for s in ("stage1", "recon", "gif")}

    runs = []
    for mod in (tsweep, jsweep):
        calls = []
        log = os.path.join(root, f"{mod.__name__.split('.')[0]}.jsonl")
        res = mod.run_sweep(root, uids, fns(calls), shard_index=0,
                            num_shards=1, resume=False, log_path=log,
                            stage_major=False)
        runs.append((res, calls,
                     [(r["uid"], r["stage"]) for r in _log(log)]))
    assert runs[0] == runs[1]
    assert runs[0][0]["failed"] == ["bad"]
    # sharding: every second uid
    res = tsweep.run_sweep(root, uids, fns([]), shard_index=1, num_shards=2,
                           resume=False, log_path=os.path.join(root, "s"))
    assert res == {"ok": ["z"], "failed": ["bad"]}


def test_cli_flags(tmp_path, monkeypatch):
    root = str(tmp_path)
    uids = tmp_path / "uids.json"
    uids.write_text('["u"]')
    base = ["--root", root, "--uids", str(uids), "--device", "cpu"]
    for bad in (["--mode", "throughput"],
                ["--mode", "latency", "--pin-chip", "0"],
                ["--stages", "stage1,nonsense"]):
        with pytest.raises(SystemExit):
            tcli.main(base + bad)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert tcli.main(base + ["--stages", "gif", "--pin-chip", "3",
                             "--mode", "throughput"]) == 0
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"
    rec = _log(os.path.join(root, "sweep_log.jsonl"))
    assert [(r["uid"], r["stage"]) for r in rec] == [("u", "gif"),
                                                     ("u", "done")]
    # latency over two visible GPUs without torchrun names torchrun's line
    monkeypatch.setattr(device_setup, "setup",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    line = ("python -m torch.distributed.run --nproc-per-node 2 -m "
            "drawingspinup_torch.cli.sweep --mode latency --root")
    for extra in (["--mode", "latency"], []):
        with pytest.raises(RuntimeError, match=line):
            tcli.main(base[:4] + extra)

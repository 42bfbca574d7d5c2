"""PyTorch port: data parallelism over ``torch.distributed``
(``parallel/mesh.py``, ``train/{nsr,gan}_parallel.py``, the dp paths of
``recon_uid``, ``train_stage`` and the latency sweep) against the JAX
package's dp steps on the conftest's virtual CPU devices.

The port's ranks are processes spawned from ``tests/torch_dp_worker.py``
(torch only, one thread each), joined over gloo through a ``FileStore``
in the test's directory; every join has a timeout, so a hung rank fails
its test. JAX runs ``nsr_parallel`` / ``gan_parallel.make_train_step_dp``
on ``make_mesh(n, dp=n)``; rank i gets JAX device i's draws, re-created
from ``jax.random.split(key, n)[i]`` as the single-step tests re-create
them. Tolerances, those of the single-step tests:
  * NSR (``tests/test_torch_nsr.py::test_train_step_matches_jax``): f32
    losses within relative 1e-4, gradients, updates and Adam moments within
    relative L2 1e-4; bf16 losses 1e-2, MLP gradients relative L2 5e-2,
    the bf16 table gradients no farther from the f32-compute gradient of
    the same draws than 1.25 x JAX's. In bf16 the updates and moments are
    not compared: from JAX's own old moments they follow the gradients,
    and bf16 rounding alone moves a small leaf's second moment by up to
    2.5e-2 from JAX's (measured, ``texture.mlp.layers.1.b``, whose port
    gradient is the nearer to f32: 2.3e-2 against JAX's 4.3e-2). JAX's
    averaged gradient is read back from its first moment,
    ``(mu' - 0.9 mu) / 0.1`` in float64 (~1e-6 relative);
  * stage 3 (``tests/test_torch_train.py::test_train_step_matches_jax``):
    losses rtol 1e-4, Adam's first moment within 1e-4 of each leaf's
    largest value, the averaged batch statistics at 1e-5, new parameters
    within 2·lr everywhere and 1e-6 on ≥ 99 % of elements;
  * bit-identity: every rank's parameters after a step, and at world size
    1 the dp steps against the plain steps.
"""

import dataclasses
import json
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

from drawingspinup_tpu.core import UidPaths as JPaths
from drawingspinup_tpu.parallel.mesh import make_mesh, replicated
from drawingspinup_tpu.pipelines import stage2_recon as js2
from drawingspinup_tpu.pipelines import stage3_data as jdata
from drawingspinup_tpu.train import gan as jgan
from drawingspinup_tpu.train import gan_parallel as jgan_dp
from drawingspinup_tpu.train import nsr as jnsr
from drawingspinup_tpu.train import nsr_parallel as jnsr_dp
from drawingspinup_torch.cli import sweep as tcli
from drawingspinup_torch.core import device as device_setup
from drawingspinup_torch.core import io as tio
from drawingspinup_torch.parallel import mesh
from drawingspinup_torch.pipelines import stage3_data as tdata
from drawingspinup_torch.pipelines import stage3_translate as tst
from drawingspinup_torch.train import gan as tgan
from drawingspinup_torch.train import nsr as tnsr
from drawingspinup_torch.utils import jax_params
from drawingspinup_torch.utils.synthetic import write_sphere_mv
import torch_dp_worker
from test_torch_nsr import N_ACTIVE, configs, jax_draws, rel, t
from test_torch_recon import TINY_OVERRIDES
from test_torch_train import (
    HIGHEST, SMALL, _assert_step_update, _keyframe, _np_tree,
    _write_pair_uid,
)
from torch_native_guard import ensure_jax_native
from torch_threads import one_torch_thread  # noqa: F401

JOIN_S = 240            # a rank that has not ended by then fails the test
NSR_RAYS = 128          # 64 a rank at world 2, 43 at world 3 (129 total)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture
def start_ranks():
    """``start(task, world, tmp)`` starts ``world`` ranks of ``task`` and
    returns ``run(inputs)`` → each rank's output; the test computes the
    inputs while the ranks start. A rank still alive at the end is
    killed."""
    procs = []

    def start(task: str, world: int, tmp):
        ctx = multiprocessing.get_context("spawn")
        mine = [ctx.Process(target=torch_dp_worker.run,
                            args=(task, r, world, str(tmp), JOIN_S))
                for r in range(world)]
        procs.extend(mine)
        for p in mine:
            p.start()

        def run(inputs) -> list:
            path = os.path.join(tmp, f"in_{task}.pt")
            torch.save(inputs, path + ".part")
            os.replace(path + ".part", path)
            for p in mine:
                p.join(JOIN_S)
            hung = [p for p in mine if p.is_alive()]
            assert not hung, f"{task}: {len(hung)} rank(s) still running"
            assert [p.exitcode for p in mine] == [0] * world, task
            return [torch.load(os.path.join(tmp, f"out_{task}_{r}.pt"),
                               weights_only=False) for r in range(world)]
        return run

    yield start
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def assert_ranks_equal(outs, *keys):
    """Every rank's tensors under ``keys`` bit-identical to rank 0's."""
    for key in keys:
        for out in outs[1:]:
            for n, v in outs[0][key].items():
                w = out[key][n]
                assert (v is None and w is None) or torch.equal(v, w), \
                    (key, n)


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sphere"))
    write_sphere_mv(root, "s", size=64)
    jd = js2.load_ortho_data(JPaths(root, "s"), im_size=64)
    td = {k: t(v) for k, v in jd.items()}
    td["pixels"] = tnsr.pack_pixels(td)
    return jd, td


# ------------------------------------------------------------ mesh.py --

def test_per_rank_is_jaxs_ceil(capsys):
    """JAX's ceil and its note (nsr_parallel.py:35-40)."""
    assert mesh.per_rank(2048, 6, "nsr dp", "train_num_rays") == 342
    assert capsys.readouterr().out == (
        "[nsr dp] train_num_rays 2048 not divisible by dp=6: using "
        "342/device (2052 total)\n")
    assert mesh.per_rank(40, 8, "gan dp", "batch_size") == 5
    assert mesh.per_rank(3, 8, "gan dp", "batch_size") == 1
    assert capsys.readouterr().out.count("not divisible") == 1


def test_without_a_group_is_one_rank():
    """No process group: one rank, nothing averaged, rank 0's values."""
    x = torch.arange(4.0)
    mesh.all_mean_([x, None])
    assert torch.equal(x, torch.arange(4.0))
    assert (mesh.world_size(), mesh.rank(), mesh.is_main()) == (1, 0, True)
    assert mesh.broadcast({"a": 1}) == {"a": 1}
    assert mesh.on_main(lambda: 7) == 7
    assert mesh.rank_seed(5) == 5
    assert mesh.rank_seed(5, 1) == 5 + mesh.RANK_SEED_STRIDE


# ---------------------------------------------------------------- NSR --

def _jax_moment_grad(mu_new, mu_old):
    return (np.asarray(mu_new, np.float64)
            - 0.9 * np.asarray(mu_old, np.float64)) / 0.1


@pytest.mark.parametrize("world,tdt", [(2, "float32"), (2, "bfloat16"),
                                       (3, "float32")])
def test_nsr_dp_step_matches_jax(world, tdt, sphere, tmp_path,
                                 start_ranks):
    """Two JAX dp steps, then the third from the converted state: JAX's
    ``nsr_parallel`` step against the port's ranks, each on JAX device i's
    draws (``NSR_RAYS`` does not divide by 3)."""
    run = start_ranks(f"nsr-{world}-{tdt}", world, tmp_path)
    jd, td = sphere
    jc, tc = (dataclasses.replace(c, train_num_rays=NSR_RAYS)
              for c in configs(tdt, tdt))
    tx = jnsr.make_optimizer(jc)
    jmesh = make_mesh(world, dp=world)
    step_dp = jnsr_dp.make_train_step_dp(jc, tx, jmesh, n_active=N_ACTIVE)
    # placed as the step's outputs are, so that its one compile serves all
    state, jd = jax.device_put(
        (jnsr.init_state(jc, jax.random.PRNGKey(0)), jd), replicated(jmesh))
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        key, k = jax.random.split(key)
        state, _ = step_dp(state, jd, k)
    key, k = jax.random.split(key)
    new, jlogs = step_dp(state, jd, k)

    per = -(-NSR_RAYS // world)
    shard = dataclasses.replace(jc, train_num_rays=per)
    keys = jax.random.split(k, world)
    host = jax.device_get(state.params)
    mu, nu, count = jax_params.nsr_opt_state(state.opt_state)
    tc32 = dataclasses.replace(configs()[1], train_num_rays=NSR_RAYS)
    outs = run({
        "cfg": tc, "params": jax_params.nsr_params(host), "mu": mu,
        "nu": nu, "count": count, "step": int(state.step), "data": td,
        "draws": [jax_draws(shard, keys[i], 6, 64, 64)
                  for i in range(world)],
        "n_active": N_ACTIVE,
        "ref_cfg": None if tdt == "float32" else tc32})
    assert_ranks_equal(outs, "params", "grads", "mu", "nu")
    out = outs[0]
    assert out["count"] == 3

    f32 = tdt == "float32"
    loss_tol, grad_tol = (1e-4, 1e-4) if f32 else (1e-2, 5e-2)
    for name, v in jlogs.items():
        assert out["logs"][name] == pytest.approx(float(v), rel=loss_tol), \
            name
    jmu, jnu, jcount = jax_params.nsr_opt_state(new.opt_state)
    assert jcount == 3
    old = dict(tnsr.named_leaves(host))
    jnew = dict(tnsr.named_leaves(jax.device_get(new.params)))
    for n, p in out["params"].items():
        jg = _jax_moment_grad(jmu[n], mu[n])
        g = out["grads"][n]
        if n.startswith("geometry.table.") and int(n[-1]) >= N_ACTIVE:
            assert g is None and not np.any(jg), n          # locked level
            assert torch.equal(p, jax_params._tensor(old[n])), n
            continue
        if not f32 and n.startswith("geometry.table."):
            # against the f32-compute gradient of the same draws
            want = out["ref_grads"][n].numpy()
            assert rel(g, want) <= 1.25 * rel(jg, want), n
            continue
        assert rel(g, jg) <= grad_tol, (n, rel(g, jg))
        if f32:
            step_j = np.asarray(jnew[n], np.float32) - np.asarray(
                old[n], np.float32)
            step_t = p.numpy() - np.asarray(old[n], np.float32)
            assert rel(step_t, step_j) <= 1e-4, n
            assert rel(out["mu"][n], jmu[n]) <= 1e-4, n
            assert rel(out["nu"][n], jnu[n]) <= 1e-4, n


# ------------------------------------------------------------ stage 3 --

def _gan_dicts(jstate):
    return {"gen": jax_params.to_state_dict(_np_tree(jstate.g_params),
                                            _np_tree(jstate.g_stats)),
            "disc": jax_params.to_state_dict(_np_tree(jstate.d_params)),
            "vgg": jax_params.to_state_dict(_np_tree(jstate.vgg_params))}


def test_gan_dp_step_matches_jax(tmp_path, start_ranks):
    """One ``gan_parallel`` step at world 2 against the port's two ranks,
    rank i on JAX device i's patches."""
    world = 2
    run = start_ranks("gan", world, tmp_path)
    cfg = jgan.GANConfig(generator="GeneratorJ_RIC", ric_variant="fused",
                         **SMALL)
    jstate = jgan.init_state(cfg, jax.random.PRNGKey(3))
    data, key = _keyframe(4), jax.random.PRNGKey(5)
    per = cfg.batch_size // world
    with HIGHEST():
        step = jgan_dp.make_train_step_dp(cfg, make_mesh(world, dp=world))
        jnew, jlogs = step(jstate, data, key)
        keys = jax.random.split(key, world)
        batches = [{k: torch.from_numpy(np.array(v)) for k, v in
                    jdata.sample_patches(data, keys[i], per,
                                         cfg.patch_size).items()}
                   for i in range(world)]
    tcfg = tgan.GANConfig(**dataclasses.asdict(cfg))
    outs = run({
        "cfg": tcfg, "state": _gan_dicts(jstate), "batches": batches})
    assert_ranks_equal(outs, "gen", "disc", "exp_avg")
    out = outs[0]
    for k in tgan.LOSS_NAMES:
        np.testing.assert_allclose(out["logs"][k], float(jlogs[k]),
                                   rtol=1e-4, err_msg=k)
    mu = jax_params.to_state_dict(_np_tree(jnew.g_opt[0].mu))
    assert sorted(mu) == sorted(out["exp_avg"])
    for k, got in out["exp_avg"].items():
        want = mu[k].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(),
                                                   1e-12), err_msg=k)
    stats = jax_params.to_state_dict({}, _np_tree(jnew.g_stats))
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(out["gen"][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    port = tgan.init_state(tcfg, "cpu")
    port.gen.load_state_dict(out["gen"])
    port.disc.load_state_dict(out["disc"])
    _assert_step_update("G", port.gen, jnew.g_params, cfg.lr)
    _assert_step_update("D", port.disc, jnew.d_params, cfg.lr)


# ------------------------------------------------------------ world 1 --

def test_dp_steps_at_world_one_are_the_plain_steps(sphere, tmp_path,
                                                   start_ranks):
    """One rank in a gloo group: two dp steps of each training (the
    all-reduce included) bit-identical to two plain steps on the same
    draws and batches."""
    _, td = sphere
    tc = dataclasses.replace(configs()[1], train_num_rays=NSR_RAYS)
    g = torch.Generator().manual_seed(0)
    st = tnsr.init_state(tc, 0)
    draws = [tnsr.make_draws(tc, 6, 64, 64, g, "cpu") for _ in range(2)]
    gcfg = tgan.GANConfig(generator="GeneratorJ_RIC", **SMALL)
    gs = tgan.init_state(gcfg, "cpu", seed=3)
    kf = _keyframe(4)
    data = tdata.KeyframeData(
        *(torch.from_numpy(np.array(x)) for x in kf[:3]),
        torch.from_numpy(np.array(kf.valid_yx, np.int64)),
        n_valid=len(kf.valid_yx))
    batches = [tdata.sample_patches(data, g, gcfg.batch_size,
                                    gcfg.patch_size) for _ in range(2)]
    (out,) = start_ranks("world1", 1, tmp_path)({
        "nsr_cfg": tc, "params": st.params, "mu": st.opt_state.mu,
        "nu": st.opt_state.nu, "count": 0, "step": 0, "data": td,
        "draws": draws, "n_active": N_ACTIVE, "gan_cfg": gcfg,
        "gan_state": {k: getattr(gs, k).state_dict()
                      for k in ("gen", "disc", "vgg")},
        "batches": batches})
    assert out["same"] and all(out["same"].values()), out["same"]


# --------------------------------------------- the pipelines' dp paths --

def _small_yaml(tmp_path, stage: int) -> str:
    text = open(tst.DEFAULT_STAGE_CFGS[stage]).read()
    for a, b in (("filters: [32, 64, 128, 128, 128, 64]",
                  "filters: [8, 16, 16, 16, 16, 8]"),
                 ("resnet_blocks: 7", "resnet_blocks: 1"),
                 ("batch_size: 40", "batch_size: 4"),
                 ("patch_size: 32", "patch_size: 16"),
                 ("log_interval: 1000", "log_interval: 2")):
        assert a in text
        text = text.replace(a, b)
    path = tmp_path / f"stage{stage}.yaml"
    path.write_text(text)
    return str(path)


def test_latency_sweep_over_two_ranks(tmp_path, start_ranks):
    """``run_sweep`` of recon and train_style over two CPU ranks through
    the stage CLIs (recon at the tiny overrides of
    tests/test_torch_recon.py, stage 3 at a small yaml, 4 batches a
    stage): rank 0 writes the OBJ, the checkpoints, the evals and the log,
    rank 1 writes nothing (each write under the root raises there); both
    ranks end with bit-identical parameters; a resumed sweep runs nothing
    and a resumed recon re-exports on both ranks alike."""
    run = start_ranks("sweep", 2, tmp_path)
    root = tmp_path / "data"
    paths = _write_pair_uid(str(root), 16, 16, seed=8)
    write_sphere_mv(str(root), "u", size=64)
    uids = str(root / "uids.json")
    with open(uids, "w") as f:
        json.dump(["u"], f)
    outs = run({
        "root": str(root), "uid": "u", "uids": uids,
        "recon_overrides": TINY_OVERRIDES,
        "train_args": tuple(("--config", _small_yaml(tmp_path, s),
                             "--max-batches", "4") for s in (1, 2))})
    assert outs[1]["attempts"] == []
    for out in outs:
        assert out["first"] == {"ok": ["u"], "failed": []}
        assert out["resumed_sweep"] == {"ok": ["u"], "failed": []}
        assert out["recon_stats"]["world"] == 2
        assert out["recon_stats"]["steps"] == 120
        assert out["resumed_recon_steps"] == 0
        assert not out["resumed_recon_trained"]
    assert outs[0]["recon_stats"]["log"] == outs[1]["recon_stats"]["log"]
    assert_ranks_equal(outs, "recon_params", "gan")
    mesh_dir = paths.mesh_dir
    name = "it120-mc64-f3000_c_r_s_cbp.obj"
    assert sorted(os.listdir(mesh_dir)) == sorted([
        "blender_render", "ckpt", "logs_stage1_mask_pos",
        "logs_stage2_mask_pos", name])
    assert os.listdir(os.path.join(mesh_dir, "ckpt")) == ["step_120.pt"]
    for s in (1, 2):
        assert sorted(os.listdir(os.path.join(
            mesh_dir, f"logs_stage{s}_mask_pos"))) == [
            "model_00002.pt", "model_00004.pt", "model_99999.pt",
            "train_losses.json"]
    assert tio.read_image_u8(os.path.join(
        paths.action_dir("rest_pose"), "res_stage2_mask_pos",
        "0001.png")).shape == (16, 16, 4)
    with open(root / "sweep_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [(r["uid"], r["stage"]) for r in log] == [
        ("u", "recon"), ("u", "train_style"), ("u", "done"), ("u", "done")]


def test_latency_sweep_without_torchrun_names_its_line(tmp_path,
                                                       monkeypatch):
    """More than one visible GPU and no torchrun: the latency sweep raises
    with the ``torch.distributed.run`` line, the user's flags kept."""
    uids = tmp_path / "uids.json"
    uids.write_text('["u"]')
    monkeypatch.setattr(device_setup, "setup",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError) as e:
        tcli.main(["--mode", "latency", "--root", str(tmp_path), "--uids",
                   str(uids), "--stages", "recon"])
    assert str(e.value).endswith(
        "python -m torch.distributed.run --nproc-per-node 4 -m "
        f"drawingspinup_torch.cli.sweep --mode latency --root {tmp_path} "
        f"--uids {uids} --stages recon")
    # under torchrun, throughput mode is refused
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        tcli.main(["--mode", "throughput", "--pin-chip", "0", "--root",
                   str(tmp_path), "--uids", str(uids)])

"""PyTorch port: stage 2a's batch split over ranks
(``pipelines/stage2_mv.py::batch_split``, ``models/attention_mv.py::RowSplit``,
``parallel/mesh.py::mv_split``) against JAX's ``_mv_batch_sharding`` on the
conftest's 8 virtual CPU devices.

The tiny pipeline of ``tests/test_torch_stage2a_pipeline.py`` (UNet
32/64/64/64, the full SD VAE, 64² input, 3 steps, f32, JAX's init params
converted by ``utils/jax_params.py::mv_params``, JAX's draws) runs split
over 2 and 3 gloo ranks, spawned from ``tests/torch_dp_worker.py`` (one
torch thread each, a ``FileStore`` in the test's directory, a join
timeout), at guidance 1 and 3, on two sets of weights: JAX's init
(``init``: the joint, cross-domain, attentions' output projections zero,
so the ``domains`` fold adds nothing) and the same with those projections
drawn (``drawn``, ``draw_joint_out``: the ``domains`` fold moves every
output):
  * every rank's gathered latents bit-identical to rank 0's;
  * ``drawn``: the images within relative L2 1e-5 of the port's
    one-process run, for the ``views`` and the ``views_sparse`` folds (the
    queries of a fold attend per row on a split, in row groups on one
    process: the same sums in other GEMM shapes; measured on the CPU
    ≤ 1.9e-6);
  * ``init``: no farther (max abs) from JAX's one-device run than 1.25 ×
    JAX's own sharded run (dp = 6) lies from it;
  * ``drawn``: the split run in float64 within 1e-9 (max abs) of the
    port's one-process float64 run, and the split's f32 images no farther
    from that float64 run than 1.25 × JAX's sharded f32 run, in max abs
    and in relative L2;
  * ``mv_split``'s divisor rule equal to ``_mv_batch_sharding``'s for
    batch 12 on 1-8 devices;
  * the mv CLI on two ranks in float64: rank 1 writes nothing; the
    decoded images within 1e-9 of the one-process CLI's, and the PNGs and
    masks byte-equal but for values whose float64 result lies within 1e-9
    of a u8 rounding boundary (reported).

In one process, each fold's split attention (``RowSplit`` with the
all-gather stood in by every rank's rows concatenated in rank order) is
held to the one-rank fold on the same rows, for every world up to 8 with
and without guidance.
"""

import multiprocessing
import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drawingspinup_tpu.models.unet_mv2d import UNetMVConfig
from drawingspinup_tpu.pipelines import stage2_mv as jmv
from drawingspinup_torch.cli import mv as cli_mv
from drawingspinup_torch.core.io import read_image_u8
from drawingspinup_torch.models import attention_mv as tattn
from drawingspinup_torch.models import unet_mv2d as tunet
from drawingspinup_torch.parallel import mesh
from drawingspinup_torch.pipelines import stage2_mv as tmv
from drawingspinup_torch.utils.jax_params import mv_params
from drawingspinup_torch.utils.synthetic import write_drawing_uid
import torch_dp_worker
from mv_parity import distances, jax_noises, rel_l2
from test_torch_stage2a_pipeline import (
    STEPS, TINY_UNET, jax_init, run_jax, torch_pipeline,
)
from torch_threads import one_torch_thread  # noqa: F401

JOIN_S = 240            # a rank that has not ended by then fails the test
WORLDS = (2, 3)
GUIDANCES = (1.0, 3.0)
WEIGHTS = ("init", "drawn")
SPLIT_TOL = 1e-5        # split against the port's one-process run, rel L2
JAX_FACTOR = 1.25       # split vs JAX's one-device run, against JAX's split
F64_ATOL = 1e-9         # split against one process, both in float64


def torch_config(guidance: float, sparse: bool = False,
                 dtype: str = "float32"):
    unet = tunet.UNetMVConfig(**TINY_UNET, sparse_mv_attention=sparse)
    return tmv.MVPipelineConfig(
        unet=unet, num_inference_steps=STEPS, image_size=64, out_size=64,
        compute_dtype=dtype, guidance_scale=guidance)


def draw_joint_out(params, seed: int):
    """``params`` with the joint attentions' ``to_out`` kernels (std
    1/sqrt(fan-in)) and biases (std 0.1) drawn from ``seed`` in place of
    their zero init; also the number of arrays drawn."""
    rng = np.random.default_rng(seed)
    drawn = [0]

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = walk(v, path + (k,))
            elif path[-1:] == ("to_out",) and any(
                    p.startswith("attn_joint") for p in path):
                std = 0.1 if k == "bias" else 1 / np.sqrt(v.shape[0])
                out[k] = (std * rng.standard_normal(v.shape)).astype(
                    np.float32)
                drawn[0] += 1
            else:
                out[k] = v
        return out

    tree = walk(params, ())
    return tree, drawn[0]


def spawn(task: str, world: int, tmp: str):
    """Start ``world`` ranks of ``task``; returns ``(send, collect)``:
    ``send(inputs)`` hands the ranks their inputs, ``collect()`` joins them
    and returns each rank's output. A rank still alive at the end is
    killed."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dp_worker.run,
                         args=(task, r, world, tmp, JOIN_S))
             for r in range(world)]
    for p in procs:
        p.start()

    def send(inputs) -> None:
        path = os.path.join(tmp, f"in_{task}.pt")
        torch.save(inputs, path + ".part")
        os.replace(path + ".part", path)

    def collect() -> list:
        try:
            for p in procs:
                p.join(JOIN_S)
            assert not [p for p in procs if p.is_alive()], \
                f"{task}: a rank still runs"
            assert [p.exitcode for p in procs] == [0] * world, task
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"out_{task}_{r}.pt"),
                           weights_only=False) for r in range(world)]

    return send, collect


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The split runs on 2 and 3 ranks (started first: the ranks import
    torch while JAX compiles; given their inputs before JAX's side is
    computed, and joined last), JAX's one-device and sharded runs, and the
    port's one-process runs, keyed (weights, guidance, sparse): ``init``
    is JAX's init (the joint projections zero), ``drawn`` the same with
    them drawn; ``init`` runs the ``views`` fold only; ``drawn`` runs the
    ``views`` fold in float64 too (keyed with a fourth item, "float64")."""
    tmp = str(tmp_path_factory.mktemp("mv_split"))
    starts = {w: spawn(f"mv-{w}", w, tmp) for w in WORLDS}
    jcfg = jmv.MVPipelineConfig(unet=UNetMVConfig(**TINY_UNET),
                                num_inference_steps=STEPS, image_size=64,
                                out_size=64, compute_dtype="float32")
    init = jax_init(jcfg, jax.random.PRNGKey(5))
    drawn, n_drawn = draw_joint_out(init, seed=9)
    assert n_drawn == 2 * 16    # kernel and bias of the 16 attn_joint_mid
    params = {"init": init, "drawn": drawn}
    img = np.random.default_rng(6).random((64, 64, 3)).astype(np.float32)
    noises = jax_noises(0, (12, 8, 8, 4), STEPS)
    cfgs = {(w, g, sparse): torch_config(g, sparse)
            for w in WEIGHTS for g in GUIDANCES for sparse in (False, True)
            if w == "drawn" or not sparse}
    cfgs.update({("drawn", g, False, "float64"):
                 torch_config(g, dtype="float64") for g in GUIDANCES})
    unet = mv_params(drawn)["unet"]
    over = {"drawn": {k: v for k, v in unet.items() if "attn_joint" in k}}
    # every world's inputs at once: the ranks run while JAX's side and the
    # port's one-process runs are computed here
    for send, _ in starts.values():
        send({"cfgs": cfgs, "state": mv_params(init), "unet_over": over,
              "image": img, "noises": noises})
    jax_runs = {}
    for w in WEIGHTS:
        jpipe = jmv.MVPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                            params[w]))
        for g in GUIDANCES:
            sharded = run_jax(jpipe, jcfg, img, guidance_scale=g)
            assert jpipe.last_sample_dp == 6
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jmv, "_mv_batch_sharding", lambda batch: None)
                one = run_jax(jpipe, jcfg, img, guidance_scale=g)
            jax_runs[w, g] = (np.concatenate(one), np.concatenate(sharded))
    port = {}
    for key, cfg in cfgs.items():
        pipe = torch_pipeline(cfg, params[key[0]])
        if cfg.compute_dtype == "float64":
            pipe = tmv.MVPipeline(cfg, *(m.double() for m in (
                pipe.unet, pipe.vae, pipe.clip)))
        port[key] = np.concatenate(pipe(img, noises=noises))
    split = {w: collect() for w, (_, collect) in starts.items()}
    return split, jax_runs, port


def images(out) -> np.ndarray:
    return np.concatenate(out["images"])


@pytest.mark.parametrize("devices", range(1, 9))
def test_divisor_rule_is_jaxs(devices, monkeypatch):
    every = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda: every[:devices])
    sh = jmv._mv_batch_sharding(12)
    want = 1 if sh is None else sh[0].mesh.shape["dp"]
    assert mesh.mv_split(12, devices) == want


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_bit_identical(runs, world):
    outs = runs[0][world]
    assert len(outs[0]) == 8
    for key in outs[0]:
        for out in outs[1:]:
            assert torch.equal(out[key]["latents"], outs[0][key]["latents"])
            np.testing.assert_array_equal(images(out[key]),
                                          images(outs[0][key]))
        assert outs[0][key]["latents"].shape == (12, 4, 8, 8)


@pytest.mark.parametrize("sparse", [False, True], ids=["views", "sparse"])
@pytest.mark.parametrize("guidance", GUIDANCES)
@pytest.mark.parametrize("world", WORLDS)
def test_split_matches_one_process(runs, world, guidance, sparse):
    """On the drawn joint projections: the ``domains`` fold is split too."""
    got = images(runs[0][world][0][("drawn", guidance, sparse)])
    want = runs[2][("drawn", guidance, sparse)]
    assert got.shape == want.shape == (12, 64, 64, 3)
    assert rel_l2(got, want) <= SPLIT_TOL, rel_l2(got, want)


@pytest.mark.parametrize("guidance", GUIDANCES)
@pytest.mark.parametrize("world", WORLDS)
def test_split_no_farther_from_jax_than_jaxs_split(runs, world, guidance):
    """On JAX's init params (the joint projections zero): max abs from
    JAX's one-device run ≤ 1.25 × JAX's sharded run's."""
    one, sharded = runs[1]["init", guidance]
    got = images(runs[0][world][0][("init", guidance, False)])
    d_port = float(np.abs(got - one).max())
    d_jax = float(np.abs(sharded - one).max())
    print(f"world {world} guidance {guidance}: split vs JAX one-device "
          f"{d_port:.3e}, JAX sharded vs one-device {d_jax:.3e}")
    assert d_port <= JAX_FACTOR * d_jax, (d_port, d_jax)


@pytest.mark.parametrize("guidance", GUIDANCES)
@pytest.mark.parametrize("world", WORLDS)
def test_split_with_joint_weights_tracks_jaxs_split(runs, world, guidance):
    """On the drawn joint projections, where the ``domains`` fold mixes the
    halves, with float64 as the yardstick: the split run in float64 within
    1e-9 of the port's one-process float64 run (the split computes the same
    sums), and the split's f32 images no farther from that float64 run
    than 1.25 × JAX's sharded f32 run, in max abs and in relative L2.

    The bound this test held before (the split's max abs from JAX's
    sharded run against 1.25 × the port's one-process run's from JAX's
    one-device run) compared two f32 distances that both sit inside
    host-dependent f32 rounding, magnified at the tiny UNet's 1×1 level
    (``test_torch_stage2a_pipeline.py::test_tiny_pipeline_matches_jax``):
    on a Xeon with AVX-512 and AMX it failed at world 3, guidance 1, by
    1.934e-5 against 1.25 × 1.517e-5."""
    got = images(runs[0][world][0][("drawn", guidance, False)])
    got64 = images(runs[0][world][0][("drawn", guidance, False, "float64")])
    one64 = runs[2][("drawn", guidance, False, "float64")]
    sharded = runs[1]["drawn", guidance][1]
    assert got64.dtype == one64.dtype == np.float64
    d64 = distances(got64, one64)[0]
    d_split, d_jax = distances(got, one64), distances(sharded, one64)
    print(f"world {world} guidance {guidance}: split vs one process in "
          f"float64 {d64:.3e}; f32 to float64 (max abs, rel L2): split "
          f"{d_split}, JAX sharded {d_jax}")
    assert d64 <= F64_ATOL, d64
    for p, j in zip(d_split, d_jax):
        assert 0 < p <= JAX_FACTOR * j, (d_split, d_jax)


def test_mv_cli_on_two_ranks(tmp_path, monkeypatch):
    """``cli/mv.py --tiny --device cpu`` on two gloo ranks, the pipeline in
    float64 (``torch_dp_worker.py::mv_float64``, here and in the ranks):
    rank 1 writes nothing; the decoded images within 1e-9 of the
    one-process CLI's; the 18 PNGs byte-equal to its, but for values whose
    float64 result (``x·255 + 0.5``) lies within 1e-9 of an integer, the
    u8 rounding boundary (counted and reported).

    The ±1 u8 that this test allowed in f32 broke on a Xeon with AVX-512
    and AMX (3 u8 apart on the front colour view): f32 rounding moves with
    the host's instruction set; float64 sums in another order do not."""
    root = str(tmp_path / "split")
    one = str(tmp_path / "one")
    argv = ["--uid", "toy", "--tiny", "--device", "cpu", "--steps", "2",
            "--size", "64", "--out-size", "96", "--seed", "1"]
    send, collect = spawn("mvcli", 2, str(tmp_path))
    for r in (root, one):
        write_drawing_uid(r, "toy", size=64)
    send({"root": root, "argv": ["--root", root, *argv], "float64": True})
    outs = collect()
    assert outs[0]["dp"] == outs[1]["dp"] == 2
    assert [o["wrote"] for o in outs] == [1, 0]             # rank 0 wrote
    assert outs[1]["attempts"] == [] and outs[1]["decoded"] == []
    decoded = []
    torch_dp_worker.mv_float64(monkeypatch.setattr, decoded)
    assert cli_mv.main(["--root", one, *argv]) == 0
    (split_q,), (one_q,) = outs[0]["decoded"], decoded
    assert split_q.dtype == one_q.dtype == np.float64
    d64 = float(np.abs(split_q - one_q).max()) / 255.0
    assert d64 <= F64_ATOL, d64
    near = np.abs(one_q - np.round(one_q)) <= 255.0 * F64_ATOL
    n = len(tmv.VIEWS)
    flipped = 0
    for kind in ("normal", "color", "mask"):
        for i, v in enumerate(tmv.VIEWS):
            got = read_image_u8(tmv.UidPaths(root, "toy").mv(kind, v))
            want = read_image_u8(tmv.UidPaths(one, "toy").mv(kind, v))
            assert got.shape == want.shape and got.shape[:2] == (96, 96)
            differ = got != want
            if kind == "mask":
                assert not differ.any(), (kind, v)
                continue
            edge = near[i if kind == "normal" else n + i]
            assert not (differ & ~edge).any(), (kind, v)
            flipped += int(differ.sum())
    print(f"mv CLI, split vs one process in float64: decoded images "
          f"{d64:.3e} apart; {int(near.sum())} values within 1e-9 of a u8 "
          f"boundary, {flipped} of them rounded apart")


@pytest.mark.parametrize("guidance", [False, True], ids=["cond", "guided"])
@pytest.mark.parametrize("world", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("fold", ["views", "views_sparse", "domains"])
def test_split_fold_matches_one_rank(fold, world, guidance, monkeypatch):
    """One attention with ``kv_fold=fold`` on each rank's rows of
    ``batch_split`` (its gather stood in by every rank's K ⊕ V rows in rank
    order, as ``all_gather`` returns them) equals the one-rank fold of the
    whole batch on those rows, in float64; ranks past dp do not denoise."""
    nv2, views, c = 12, 6, 16
    batch = 2 * nv2 if guidance else nv2
    gen = torch.Generator().manual_seed(world)
    attn = tattn.Attention(c, heads=2).double()
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=p.dtype))
    x = torch.randn(batch, 5, c, generator=gen, dtype=torch.float64)
    want = attn(x, kv_fold=fold, num_views=views)
    kv = torch.cat([attn.to_k(x), attn.to_v(x)], dim=-1)
    dp = mesh.mv_split(nv2, world)
    monkeypatch.setattr(mesh, "world_size", lambda: world)
    monkeypatch.setattr(mesh, "dp_group", lambda n: "group")
    layout = []
    for r in range(world):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        layout.append(tmv.batch_split(nv2, guidance))
    assert [ok for ok, _ in layout] == [r < dp for r in range(world)]
    splits = [s for ok, s in layout if ok]
    assert sorted(g for s in splits for g in s.rows) == list(range(batch))
    gathered = torch.cat([kv[list(s.rows)] for s in splits])

    def all_gather_rows(t, group):
        assert group == "group" and t.shape == (batch // dp, 5, 2 * c)
        return gathered

    monkeypatch.setattr(mesh, "all_gather_rows", all_gather_rows)
    for s in splits:
        rows = list(s.rows)
        got = attn(x[rows], kv_fold=fold, num_views=views, split=s)
        torch.testing.assert_close(got, want[rows], rtol=1e-12, atol=1e-12)

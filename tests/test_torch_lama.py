"""PyTorch port, stage-1 training (LaMa): the BiCar renderer and data,
the trainer and its CLI, against the JAX package on the CPU.

  * ``render/bicar.py``: ``batch_render`` over OBJs with vertex colours
    (the repo's bar mesh, a sphere), one without colours and a missing
    uid: the same uids done and every PNG byte-equal to JAX's from one
    seed;
  * ``pipelines/stage1_data.py``: ``BiCarDataset`` batches bit-equal to
    JAX's from one seed (crops 64 of 72 and 128 of 144), and
    ``contour_band`` / ``freestyle_contour`` equal;
  * ``train/lama.py``: from one JAX ``LamaState`` converted by
    ``utils/jax_params.py::lama_state``, three ``train_step``s on the same
    batches with both packages in float64: every loss within relative
    1e-5 of JAX's; the new parameters, batch statistics and Adam moments
    within atol = rtol = 1e-5 × each leaf's largest value, the counts
    equal; one f32 step: losses within 1e-5, and every gradient no farther
    from float64 than 1.25 × JAX's f32 gradient is;
    ``adversarial_weight > 0`` raises ``NotImplementedError`` in the port,
    and JAX's step raises ``ScopeCollectionNotFound`` (the JAX fault the
    port does not copy);
  * ``cli/train_lama.py`` at tiny width (``--render`` first) writes
    ``step_N.pt``, which ``cli/predict.py`` loads strictly and predicts
    with.
"""

import functools
import json
import os

import flax.errors
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drawingspinup_tpu.models import ffc as jffc
from drawingspinup_tpu.ops import fourier as jfourier
from drawingspinup_tpu.pipelines import stage1_data as jdata
from drawingspinup_tpu.render import bicar as jbicar
from drawingspinup_tpu.train import lama as jlama
from drawingspinup_torch.cli import predict, train_lama
from drawingspinup_torch.core.io import read_image_u8, write_obj
from drawingspinup_torch.pipelines import stage1_data as tdata
from drawingspinup_torch.render import bicar as tbicar
from drawingspinup_torch.train import lama as tlama
from drawingspinup_torch.utils.jax_params import ffc_params, lama_state
from drawingspinup_torch.utils.synthetic import (bar_mesh, sphere_mesh,
                                                 write_bicar_objs,
                                                 write_drawing_uid)
from mv_parity import F64
from torch_native_guard import ensure_jax_native
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(ngf=8, n_downsampling=2, n_blocks=1)
YAML = os.path.join(REPO, "drawingspinup_torch", "configs",
                    "lama-fourier.yaml")


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library (bicar's rasterizer), built under a lock if
    another worker's build raced this one's."""
    ensure_jax_native()


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    """An OBJ root: ``bar`` (the rig fixture's bar mesh, coloured by
    height), ``ball.obj`` (a sphere) and ``plain`` (no colours); the uid
    list names a missing uid too."""
    root = tmp_path_factory.mktemp("objs")
    v, f = bar_mesh()[:2]
    col = np.stack([v[:, 2] / 2, 0.5 + 0 * v[:, 2], 1 - v[:, 2] / 2], -1)
    write_obj(str(root / "bar" / "model.obj"), v, f, vertex_colors=col)
    sv, sf = sphere_mesh()
    write_obj(str(root / "ball.obj"), sv, sf,
              vertex_colors=(sv / 1.2 + 0.5).clip(0, 1))
    write_obj(str(root / "plain" / "model.obj"), sv, sf)
    uids = root / "uids.json"
    uids.write_text(json.dumps(["bar", "missing", "ball", "plain"]))
    return root


@pytest.fixture(scope="module")
def rendered(objs, tmp_path_factory):
    """Both packages' renders of ``objs``, seed 3."""
    out = {}
    for name, mod in (("jax", jbicar), ("torch", tbicar)):
        d = tmp_path_factory.mktemp(name)
        out[name] = (str(d), mod.batch_render(str(objs), str(d),
                                              str(objs / "uids.json"),
                                              seed=3))
    return out


def test_bicar_pngs_are_byte_equal(rendered):
    (jroot, jdone), (troot, tdone) = rendered["jax"], rendered["torch"]
    assert tdone == jdone == ["bar", "ball", "plain"]
    for uid in tdone:
        names = sorted(os.listdir(os.path.join(jroot, uid)))
        assert names == sorted(os.listdir(os.path.join(troot, uid))) == \
            sorted(["rgba.png"] + [f"contour_{k}.png" for k in range(6)])
        for n in names:
            with open(os.path.join(jroot, uid, n), "rb") as a, \
                    open(os.path.join(troot, uid, n), "rb") as b:
                assert a.read() == b.read(), (uid, n)
        rgba = read_image_u8(os.path.join(troot, uid, "rgba.png"))
        assert rgba.shape == (512, 512, 4) and (rgba[..., 3] > 0).mean() > 0.01


@pytest.mark.parametrize("crop,load", [(64, 72), (128, 144)])
def test_dataset_batches_are_bit_equal(rendered, objs, crop, load):
    troot = rendered["torch"][0]
    uids = os.path.join(troot, "uids.json")
    with open(uids, "w") as f:
        json.dump(rendered["torch"][1], f)
    it = [mod.BiCarDataset(troot, uids, "train", seed=5, crop_size=crop,
                           load_size=load).batches(3)
          for mod in (jdata, tdata)]
    for _ in range(3):
        want, got = next(it[0]), next(it[1])
        assert got["input"].shape == (3, crop, crop, 4)
        for k in ("input", "gt"):
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_contour_helpers_are_the_originals():
    yy, xx = np.mgrid[0:80, 0:80]
    mask = (np.hypot(yy - 40, xx - 38) < 27).astype(np.float32)
    np.testing.assert_array_equal(tdata.contour_band(mask, 3),
                                  jdata.contour_band(mask, 3))
    for t in (2, 9):
        np.testing.assert_array_equal(
            tdata.freestyle_contour(mask, t, np.random.default_rng(t)),
            jdata.freestyle_contour(mask, t, np.random.default_rng(t)))
    assert (tdata.TRAIN_SPLIT, tdata.N_CONTOUR_VARIANTS) == \
        (jdata.TRAIN_SPLIT, jdata.N_CONTOUR_VARIANTS)
    assert (tbicar.ORTHO_SCALE, tbicar.RES) == (jbicar.ORTHO_SCALE,
                                                jbicar.RES)


def _batches(rendered, n):
    troot, done = rendered["torch"]
    uids = os.path.join(troot, "uids.json")
    with open(uids, "w") as f:
        json.dump(done, f)
    it = tdata.BiCarDataset(troot, uids, "train", seed=11, crop_size=64,
                            load_size=72).batches(2)
    return [next(it) for _ in range(n)]


@pytest.fixture
def jax_float64(monkeypatch):
    """JAX in float64 throughout: x64 on, and the FourierUnit's and the DFT
    matmuls' fixed f32 (casts, ``preferred_element_type``, the cached DFT
    matrices) read as float64. Nothing in the JAX package changes."""
    caches = (jfourier._dft_w, jfourier._dft_h, jfourier._idft_w)
    monkeypatch.setattr(jffc, "jnp", F64(jnp, jnp.float64))
    monkeypatch.setattr(jfourier, "jnp", F64(jnp, jnp.float64))
    monkeypatch.setattr(jfourier, "np", F64(np, np.float64))
    for c in caches:
        c.cache_clear()
    with jax.enable_x64(True):
        yield
    for c in caches:
        c.cache_clear()


# the transposed convolutions' biases feed a train-mode batch norm: their
# exact gradient is 0, and each package moves them by its own rounding
ZERO_GRAD = ("model.6.bias", "model.9.bias")


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if np.asarray(a).dtype == np.float32
                        else jnp.asarray(a), tree)


def test_train_step_matches_jax(rendered, jax_float64):
    """Three steps from one converted LamaState on the same batches, both
    packages in float64 (JAX's FFTs too), so that each step's own
    arithmetic is compared and not the f32 rounding, which the network's
    ill-conditioned gradients amplify (``test_f32_step_is_as_accurate``):
    every loss within relative 1e-5; the new parameters, batch statistics
    and Adam moments within atol = rtol = 1e-5 × each leaf's largest value
    (the two ZERO_GRAD biases: both packages leave them below 1e-9, their
    moments below 1e-15), the counts equal."""
    cfg = jlama.LamaTrainConfig(batch_size=2, **TINY)
    jstate = _f64(jlama.init_state(cfg, jax.random.PRNGKey(0), size=64))
    tcfg = tlama.LamaTrainConfig(batch_size=2, **TINY)
    state = lama_state(jax.tree.map(np.asarray, jstate), tcfg,
                       dtype=torch.float64)
    key = jax.random.PRNGKey(1)
    for i, batch in enumerate(_batches(rendered, 3)):
        key, k = jax.random.split(key)
        jstate, jlogs = jlama.train_step(
            cfg, jstate, {n: jnp.asarray(a, jnp.float64)
                          for n, a in batch.items()}, k)
        state, logs = tlama.train_step(tcfg, state, batch)
        assert logs["bce"].dtype == torch.float64
        for n in ("g_loss", "bce", "dice", "d_loss"):
            np.testing.assert_allclose(float(logs[n]), float(jlogs[n]),
                                       rtol=1e-5, err_msg=f"step {i} {n}")
    assert state.step == int(jstate.step) == 3
    jn = jax.tree.map(np.asarray, jstate)
    gen = state.generator
    sd = gen.state_dict()
    want = ffc_params(jn.g_params, jn.g_stats)
    assert sd.keys() == want.keys()
    adam = jn.g_opt[0]
    mu, nu = ffc_params(adam.mu), ffc_params(adam.nu)
    params = dict(gen.named_parameters())
    for k, v in want.items():
        if k in ZERO_GRAD:
            assert max(np.abs(v.numpy()).max(),
                       float(sd[k].abs().max())) < 1e-9, k
            continue
        _close(sd[k].numpy(), v.numpy(), k)
        if k in params:
            st = state.g_opt.state[params[k]]
            assert float(st["step"]) == int(adam.count) == 3
            _close(st["exp_avg"].numpy(), mu[k].numpy(), "mu " + k)
            _close(st["exp_avg_sq"].numpy(), nu[k].numpy(), "nu " + k)
    for k in ZERO_GRAD:
        st = state.g_opt.state[params[k]]
        assert max(np.abs(mu[k].numpy()).max(),
                   float(st["exp_avg"].abs().max())) < 1e-15, k
    # the discriminator and its optimizer: built, untouched, as in JAX
    dsd = state.discriminator.state_dict()
    for k, v in ffc_params(jn.d_params).items():
        np.testing.assert_array_equal(dsd[k].numpy(), v.numpy(), err_msg=k)
    assert int(jn.d_opt[0].count) == 0 and all(
        float(st["step"]) == 0 and not st["exp_avg"].any()
        for st in state.d_opt.state.values())


def test_f32_step_is_as_accurate(rendered):
    """One f32 step from one converted LamaState, the gradients read back
    from the Adam moments (mu = 0.1 · g): the losses within relative 1e-5
    of JAX's; against the same step in float64 (the port's), every
    gradient and moved batch statistic of the port within max(1.25 ×
    JAX's f32 distance, 1e-5) in relative L2. Some leaves are
    ill-conditioned (a bias before a train-mode batch norm sums terms that
    nearly cancel): JAX's f32 step puts them up to ~2e-2 from float64, the
    port's ~3e-4."""
    batch = _batches(rendered, 1)[0]
    cfg = jlama.LamaTrainConfig(batch_size=2, **TINY)
    jstate = jlama.init_state(cfg, jax.random.PRNGKey(0), size=64)
    jnew, jlogs = jlama.train_step(
        cfg, jstate, {n: jnp.asarray(a) for n, a in batch.items()},
        jax.random.PRNGKey(1))
    tcfg = tlama.LamaTrainConfig(batch_size=2, **TINY)
    init = jax.tree.map(np.asarray, jstate)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        state = lama_state(init, tcfg, dtype=dtype)
        state, logs = tlama.train_step(tcfg, state, batch)
        runs[dtype] = (state, logs)
    state, logs = runs[torch.float32]
    for n in ("g_loss", "bce", "dice"):
        np.testing.assert_allclose(float(logs[n]), float(jlogs[n]),
                                   rtol=1e-5, err_msg=n)
    jn = jax.tree.map(np.asarray, jnew)

    def leaves(st):
        """The step's gradients (from mu) and the moved statistics."""
        out = {k: st.g_opt.state[p]["exp_avg"].double().numpy() / 0.1
               for k, p in st.generator.named_parameters()}
        out.update({k: b.double().numpy()
                    for k, b in st.generator.named_buffers()})
        return out

    ours, ref = leaves(state), leaves(runs[torch.float64][0])
    theirs = {k: v.numpy().astype(np.float64) / 0.1
              for k, v in ffc_params(jn.g_opt[0].mu).items()}
    theirs.update({k: v.numpy().astype(np.float64)
                   for k, v in ffc_params({}, jn.g_stats).items()})
    assert ours.keys() == ref.keys() == theirs.keys()
    worst = {}
    for k, want in ref.items():
        if k in ZERO_GRAD:
            continue
        norm = np.linalg.norm(want)
        d_ours = np.linalg.norm(ours[k] - want) / norm
        d_theirs = np.linalg.norm(theirs[k] - want) / norm
        assert d_ours <= max(1.25 * d_theirs, 1e-5), (k, d_ours, d_theirs)
        worst[k] = d_theirs
    assert max(worst.values()) > 1e-3     # the ill-conditioned leaves


def test_adversarial_weight_raises(rendered):
    """The port refuses the adversarial branch; JAX's fails on its
    discriminator's missing batch statistics (ROADMAP.md, queue 3)."""
    batch = _batches(rendered, 1)[0]
    cfg = jlama.LamaTrainConfig(batch_size=2, adversarial_weight=0.1, **TINY)
    jstate = jlama.init_state(cfg, jax.random.PRNGKey(0), size=64)
    with pytest.raises(flax.errors.ScopeCollectionNotFound,
                       match="batch_stats"):
        jlama.train_step(cfg, jstate,
                         {n: jnp.asarray(a) for n, a in batch.items()},
                         jax.random.PRNGKey(1))
    tcfg = tlama.LamaTrainConfig(batch_size=2, adversarial_weight=0.1, **TINY)
    state = tlama.init_state(tcfg, torch.Generator().manual_seed(0), size=64,
                             device="cpu")
    with pytest.raises(NotImplementedError, match="queue 3"):
        tlama.train_step(tcfg, state, batch)


def test_init_state_draws_from_the_generator():
    cfg = tlama.LamaTrainConfig(**TINY)
    a, b, c = (tlama.init_state(cfg, torch.Generator().manual_seed(s),
                                size=64, device="cpu") for s in (0, 0, 1))
    sa, sb, sc = (s.generator.state_dict() for s in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["model.1.ffc.convl2l.weight"],
                           sc["model.1.ffc.convl2l.weight"])
    assert a.generator.training and a.step == 0
    with pytest.raises(ValueError, match="multiple"):
        tlama.init_state(cfg, torch.Generator(), size=66, device="cpu")


def test_train_lama_cli_then_predict(tmp_path, monkeypatch, capsys):
    """Render, train two steps at tiny width, and predict with the saved
    generator through ``pretrained.path`` (a strict load)."""
    monkeypatch.setattr(tlama, "LamaTrainConfig",
                        functools.partial(tlama.LamaTrainConfig, **TINY))
    data, out = tmp_path / "data", tmp_path / "run"
    names = write_bicar_objs(str(tmp_path / "objs"), 3, seed=2)
    uids = tmp_path / "uids.json"
    uids.write_text(json.dumps(names[:2]))
    rc = train_lama.main(["--data-root", str(data), "--uid-json", str(uids),
                          "--out", str(out),
                          "--steps", "2", "--batch-size", "2", "--size", "64",
                          "--render", str(tmp_path / "objs"),
                          "--render-limit", "2",
                          "--device", "cpu", "--seed", "4"])
    assert rc == 0
    saved = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert saved == {"saved": str(out / "step_2.pt")}
    assert sorted(os.listdir(data)) == names[:2]
    root = str(tmp_path / "drawings")
    write_drawing_uid(root, "toy")
    overrides = [f"generator.{k}={v}" for k, v in TINY.items()]
    assert predict.main([YAML, *overrides, f"pretrained.path={saved['saved']}",
                         "--uid", "toy", "--root", root, "--size", "64",
                         "--device", "cpu"]) == 0
    png = read_image_u8(os.path.join(root, "toy", "char",
                                     "ffc_resnet_inpainted.png"))
    assert png.shape == (64, 64, 4)
    state = torch.load(saved["saved"], weights_only=True)
    assert "model.1.ffc.convl2l.weight" in state and not any(
        k.endswith("num_batches_tracked") for k in state)

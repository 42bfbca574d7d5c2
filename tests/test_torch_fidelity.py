"""PyTorch port, the fidelity judge: ``drawingspinup_torch/utils/quality.py``
and ``drawingspinup_torch/cli/fidelity.py`` against the JAX package's
``utils/quality.py`` and ``cli/fidelity.py`` on the CPU.

  * the host functions (PSNR, SSIM, the chamfer, the mesh and GIF
    comparisons, the GIF reader), copied from JAX's: equal values on
    seeded inputs, within 1e-12 where scipy's order could differ;
  * the perceptual distance with JAX's random VGG (``PRNGKey(12345)``)
    written to an npz in ``scripts/export_vgg19_npz.py``'s layout and
    given to both sides: within relative 1e-5; the batched distances of a
    directory equal to the one-pair ones (relative 1e-6);
  * both CLIs on the committed goldens against a copy with seeded noise on
    its PNGs, one OBJ's vertices moved and one GIF frame changed, both
    given that npz: the same keys, the same numbers within relative 1e-6
    and the perceptual distances within 1e-5. JAX's CLI sets
    ``DSU_VGG19_NPZ`` from ``--vgg-npz`` but its ``compare_stage_outputs``
    never reads it, so its perceptual distances stay on its random VGG,
    which is what the npz holds; the port's reads the npz;
  * the port's CLI without an npz reports ``degraded_weights``;
  * no module of the port, nor ``chip_smoke.py``, imports JAX or the JAX
    package (the fresh-process import of every module is
    ``tests/test_torch_stage3.py::test_port_imports_no_jax``).
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

import golden_pipeline as gp
from drawingspinup_tpu.cli import fidelity as jfidelity
from drawingspinup_tpu.core import weights_policy as jwp
from drawingspinup_tpu.utils import quality as jq
from drawingspinup_torch.cli import fidelity as tfidelity
from drawingspinup_torch.core import weights_policy as twp
from drawingspinup_torch.core.io import (
    read_image_u8, read_obj, write_gif, write_image, write_obj,
)
from drawingspinup_torch.utils import quality as tq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS_TREE = os.path.dirname(os.path.join(gp.GOLDENS_ROOT, gp.GOLDEN_UID))
REL = 1e-6
PERCEPTUAL_REL = 1e-5


def _close(got, want, rel, what):
    assert got == want or abs(got - want) <= rel * max(abs(want), 1e-30), \
        (what, got, want)


def assert_same_report(got, want, perceptual=PERCEPTUAL_REL, path="report"):
    """The same keys at every level, equal strings and integers, floats
    within ``REL`` relative and ``perceptual`` values within ``perceptual``
    (not compared when it is None)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            if k == "perceptual" and perceptual is None:
                continue
            assert_same_report(got[k], want[k], perceptual, f"{path}.{k}")
            if k == "perceptual":
                _close(got[k], want[k], perceptual, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_report(g, w, perceptual, f"{path}[{i}]")
    elif isinstance(want, float) and not path.endswith(".perceptual"):
        assert isinstance(got, float), (path, got)
        _close(got, want, REL, path)
    elif not isinstance(want, float):
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """JAX's random VGG (``quality._vgg``: ``PRNGKey(12345)``) as an npz of
    ``features.N.weight`` (OIHW) and ``features.N.bias``."""
    _, params = jq._vgg()
    arrays = {}
    for conv_i, ti in enumerate((0, 2, 5)):
        p = params["params"][f"vggconv{conv_i}"]
        arrays[f"features.{ti}.weight"] = np.asarray(
            p["kernel"]).transpose(3, 2, 0, 1)
        arrays[f"features.{ti}.bias"] = np.asarray(p["bias"])
    path = str(tmp_path_factory.mktemp("vgg") / "vgg19_jax_random.npz")
    np.savez(path, **arrays)
    return path


def test_psnr_and_ssim_are_jaxs():
    rng = np.random.default_rng(0)
    for shape in ((24, 20), (24, 20, 3)):
        a = rng.random(shape)
        b = np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1)
        assert tq.psnr(a, b) == jq.psnr(a, b)
        assert tq.psnr(a, a) == jq.psnr(a, a) == float("inf")
        _close(tq.ssim(a, b), jq.ssim(a, b), 1e-12, shape)
        _close(tq.ssim(a, b, max_val=2.0, sigma=0.8),
               jq.ssim(a, b, max_val=2.0, sigma=0.8), 1e-12, shape)


def test_chamfer_and_compare_mesh_are_jaxs(tmp_path):
    rng = np.random.default_rng(1)
    va, vb = rng.random((300, 3)), rng.random((250, 3))
    for n in (20000, 100):            # all points, and a sample of each
        _close(tq.chamfer_distance(va, vb, n_sample=n),
               jq.chamfer_distance(va, vb, n_sample=n), 1e-12, n)
    faces = rng.integers(0, 250, (40, 3))
    pa, pb = str(tmp_path / "a.obj"), str(tmp_path / "b.obj")
    write_obj(pa, va.astype(np.float32), faces,
              vertex_colors=rng.random((300, 3)))
    write_obj(pb, vb.astype(np.float32), faces[:30],
              vertex_colors=rng.random((250, 3)))
    for n in (20000, 100):
        got, want = tq.compare_mesh(pa, pb, n), jq.compare_mesh(pa, pb, n)
        assert sorted(got) == sorted(want) == [
            "chamfer", "color_mse", "n_faces", "n_verts"]
        assert got["n_verts"] == want["n_verts"] == (300, 250)
        assert got["n_faces"] == want["n_faces"] == (40, 30)
        for k in ("chamfer", "color_mse"):
            _close(got[k], want[k], 1e-12, k)
    write_obj(pb, vb.astype(np.float32), faces)       # no colours
    assert "color_mse" not in tq.compare_mesh(pa, pb)


def test_gif_reader_and_compare_gif_are_jaxs(tmp_path):
    rng = np.random.default_rng(2)
    frames = [rng.random((16, 20, 3)) for _ in range(5)]
    pa, pb = str(tmp_path / "a.gif"), str(tmp_path / "b.gif")
    write_gif(pa, frames)
    write_gif(pb, [np.clip(f + 0.1 * (i == 2), 0, 1)
                   for i, f in enumerate(frames[:4])])
    for p in (pa, pb):
        got, want = tq.read_gif_frames(p), jq.read_gif_frames(p)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got, want = tq.compare_gif(pa, pb), jq.compare_gif(pa, pb)
    assert got["n_frames"] == want["n_frames"] == (5, 4)
    assert_same_report(got, want, perceptual=None)


def test_perceptual_distance_with_one_vgg(vgg_npz):
    """The same VGG weights on both sides: relative 1e-5; a directory's
    batched pairs (two shapes) equal to one pair at a time."""
    rng = np.random.default_rng(3)
    pairs = []
    for shape in ((40, 40, 3), (40, 40, 3), (24, 32, 3), (40, 40, 3)):
        a = rng.random(shape).astype(np.float32)
        pairs.append((a, np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1)))
    one = [tq.perceptual_distance(a, b, vgg_npz=vgg_npz, device="cpu")
           for a, b in pairs]
    for (a, b), got in zip(pairs, one):
        _close(got, jq.perceptual_distance(a, b, vgg_npz=vgg_npz),
               PERCEPTUAL_REL, a.shape)
    batched = tq.perceptual_distances(pairs, vgg_npz=vgg_npz, device="cpu")
    for got, want in zip(batched, one):
        _close(got, want, REL, "batched")
    assert tq.perceptual_distance(pairs[0][0], pairs[0][0], vgg_npz=vgg_npz,
                                  device="cpu") == 0.0


def _perturbed_goldens(dst: str) -> None:
    """A copy of the goldens' tree with seeded noise on every PNG, one OBJ's
    vertices moved and one GIF frame changed."""
    shutil.copytree(GOLDENS_TREE, dst)
    rng = np.random.default_rng(4)
    uid_dir = os.path.join(dst, gp.GOLDEN_UID)
    for d, _, files in sorted(os.walk(uid_dir)):
        for name in sorted(files):
            path = os.path.join(d, name)
            if name.endswith(".png"):
                a = read_image_u8(path).astype(np.float32) / 255.0
                noisy = np.clip(a + 0.03 * rng.standard_normal(a.shape), 0, 1)
                write_image(path, noisy[..., 0] if a.shape[-1] == 1
                            else noisy)
    mesh_dir = os.path.join(uid_dir, "mesh")
    obj = sorted(f for f in os.listdir(mesh_dir) if f.endswith(".obj"))[0]
    v, f, c = read_obj(os.path.join(mesh_dir, obj))
    v = v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
    write_obj(os.path.join(mesh_dir, obj), v, f, vertex_colors=c)
    gif = os.path.join(uid_dir, "gif", "rest_pose.gif")
    frames = [np.asarray(fr * 255 + 0.5, np.uint8)
              for fr in tq.read_gif_frames(gif)]
    frames[len(frames) // 2] = 255 - frames[len(frames) // 2]
    write_gif(gif, frames)


def test_both_clis_give_one_report(vgg_npz, tmp_path, monkeypatch):
    theirs = str(tmp_path / "theirs")
    _perturbed_goldens(theirs)
    # set (empty), so that JAX's CLI, which sets it by setdefault, leaves
    # it as it is, and the test leaves it as it found it
    monkeypatch.setenv("DSU_VGG19_NPZ", "")
    argv = ["--ours", GOLDENS_TREE, "--theirs", theirs, "--uid",
            gp.GOLDEN_UID, "--vgg-npz", vgg_npz]
    reports = {}
    for name, cli, extra in (("jax", jfidelity, []),
                             ("port", tfidelity, ["--device", "cpu"])):
        jwp.reset_degradations()
        twp.reset_degradations()
        out = str(tmp_path / f"{name}.json")
        assert cli.main([*argv, "--out", out, *extra]) == 0
        with open(out) as f:
            reports[name] = json.load(f)
    got, want = reports["port"], reports["jax"]
    assert "degraded_weights" not in got
    stages = sorted(k for k in want if k.startswith("stage"))
    assert len(stages) >= 5 and "gif" in want, sorted(want)
    assert_same_report(got, want)
    mesh = got["stage2b_mesh"]["files"]
    assert any(m["chamfer"] > 0 for m in mesh.values())
    gif = got["gif"]["files"]["rest_pose.gif"]["aggregate"]
    assert gif["psnr"] != "inf"


def test_cli_without_npz_reports_degraded_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("DSU_VGG19_NPZ", "")
    twp.reset_degradations()
    out = str(tmp_path / "report.json")
    assert tfidelity.main(["--ours", GOLDENS_TREE, "--theirs", GOLDENS_TREE,
                           "--uid", gp.GOLDEN_UID, "--device", "cpu",
                           "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert [d["component"] for d in report["degraded_weights"]] == [
        "fidelity-vgg19"]
    for stage, r in report.items():
        if stage.startswith("stage") and "aggregate" in r:
            assert r["aggregate"]["psnr"] == "inf", stage
            assert r["aggregate"]["perceptual"] == 0.0, stage
    for m in report["stage2b_mesh"]["files"].values():
        assert m["chamfer"] == 0.0


JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|drawingspinup_tpu)\b")


def test_port_sources_import_no_jax():
    """No line of the port's package or of ``chip_smoke.py`` imports JAX,
    its libraries or the JAX package."""
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(REPO, "drawingspinup_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(sources) > 50
    bad = []
    for path in sources:
        with open(path) as f:
            bad += [f"{path}:{i}" for i, line in enumerate(f, 1)
                    if JAX_IMPORT.match(line)]
    assert not bad, bad

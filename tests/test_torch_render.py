"""PyTorch port, stage-3 renders: the copied FBX reader and writer, the
rig helpers, the skinning, the image ops and the ``run_render`` CLI,
against the JAX package on the CPU.

  * the copies: ``render/fbx.py`` (the scene arrays read from one file,
    the bytes written), ``utils/synthetic.py::make_rig_fbx`` (the bytes of
    ``tests/test_fbx_render.py::make_rig_fbx``), ``auto_weights``,
    ``auto_frame``, ``bone_endpoints`` and ``cluster_weights``: bit-equal;
  * ``skin_all_frames`` against JAX's jitted einsum: within 1e-5;
  * ``sobel_magnitude``, ``edge_from_pos`` and ``resize`` (up and down)
    against ``drawingspinup_tpu/ops/image.py``;
  * ``python -m drawingspinup_torch.cli.run_render --device cpu`` against
    JAX's ``render_animation`` on an animated (yawed) and two static rigs
    at a 64 px base: equal frame counts and sizes, color and pos u8 within
    ±1, alpha and edge differing on < 0.5 % of pixels (the limits the
    smoke run holds the card to).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drawingspinup_tpu.ops import image as jimage
from drawingspinup_tpu.render import animation as janim
from drawingspinup_tpu.render import fbx as jfbx
from drawingspinup_torch.cli import run_render
from drawingspinup_torch.core.io import read_image_u8
from drawingspinup_torch.ops import image as timage
from drawingspinup_torch.render import animation as tanim
from drawingspinup_torch.render import fbx as tfbx
from drawingspinup_torch.utils import synthetic
from test_fbx_render import make_rig_fbx as j_make_rig_fbx
from torch_native_guard import ensure_jax_native

ALPHA_EDGE_SHARE = 0.005    # the smoke run's card-vs-CPU limit


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library, built under a lock if another worker's
    build raced this one's."""
    ensure_jax_native()


def _scene_arrays(scene):
    """Every array and scalar of a loaded FbxScene, by name."""
    out = {"vertices": scene.vertices, "faces": scene.faces,
           "mesh_model": scene.mesh_model, "frame_rate": scene.frame_rate,
           "frame_range": scene.frame_range()}
    for uid, m in scene.models.items():
        for f in ("name", "kind", "translation", "rotation", "scaling",
                  "pre_rotation", "parent"):
            out[f"model{uid}.{f}"] = getattr(m, f)
    for i, c in enumerate(scene.clusters):
        for f in ("bone_model", "indexes", "weights", "transform",
                  "transform_link"):
            out[f"cluster{i}.{f}"] = getattr(c, f)
    for uid, chans in scene.anim.items():
        for prop, axes in chans.items():
            for axis, c in axes.items():
                out[f"anim{uid}.{prop}.{axis}"] = (c.times, c.values)
    return out


@pytest.mark.parametrize("animate", [True, False])
def test_fbx_copy_and_rig_are_the_originals(tmp_path, animate):
    j_path, t_path = str(tmp_path / "j.fbx"), str(tmp_path / "t.fbx")
    jv, jf = j_make_rig_fbx(j_path, animate=animate)
    tv, tf = synthetic.make_rig_fbx(t_path, animate=animate)
    assert open(j_path, "rb").read() == open(t_path, "rb").read()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    js, ts = jfbx.load_scene(j_path), tfbx.load_scene(j_path)
    ja, ta = _scene_arrays(js), _scene_arrays(ts)
    assert ja.keys() == ta.keys()
    for k in ja:
        np.testing.assert_array_equal(np.asarray(ta[k], dtype=object),
                                      np.asarray(ja[k], dtype=object),
                                      err_msg=k)
    bones = [c.bone_model for c in ts.clusters]
    times = np.linspace(0.0, 1.0, 7)
    np.testing.assert_array_equal(
        tfbx.evaluate_bone_worlds(ts, times, bones),
        jfbx.evaluate_bone_worlds(js, times, bones))
    w_t, b_t = tanim.cluster_weights(ts, len(tv))
    w_j, b_j = janim.cluster_weights(js, len(jv))
    np.testing.assert_array_equal(w_t, w_j)
    assert b_t == b_j
    for a, b in zip(tanim.bone_endpoints(ts, bones),
                    janim.bone_endpoints(js, bones)):
        np.testing.assert_array_equal(a, b)


def test_auto_weights_and_auto_frame_are_the_originals():
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    for n_bones in (2, 6):          # the k-nearest cut applies past k = 4
        heads = rng.normal(size=(n_bones, 3)).astype(np.float32)
        tails = heads + rng.normal(size=(n_bones, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            tanim.auto_weights(verts, heads, tails),
            janim.auto_weights(verts, heads, tails))
    for spread in (0.4, 3.0):       # inside the ortho scale, and grown
        posed = (spread * rng.normal(size=(5, 40, 3))).astype(np.float32)
        t, j = tanim.auto_frame(posed), janim.auto_frame(posed)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:] == j[1:]


def test_skin_all_frames_matches_jax():
    rng = np.random.default_rng(4)
    verts = rng.normal(size=(500, 3)).astype(np.float32)
    w = rng.uniform(size=(500, 3)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    mats = rng.normal(size=(6, 3, 4, 4)).astype(np.float32)
    want = np.asarray(janim.skin_all_frames(jnp.asarray(verts),
                                            jnp.asarray(w),
                                            jnp.asarray(mats)))
    got = tanim.skin_all_frames(torch.from_numpy(verts), torch.from_numpy(w),
                                torch.from_numpy(mats)).numpy()
    assert got.shape == want.shape == (6, 500, 3)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_sobel_and_edge_from_pos_match_jax():
    rng = np.random.default_rng(5)
    pos = rng.uniform(size=(40, 36, 3)).astype(np.float32)
    pos[:, 18:] += 0.5
    mask = (rng.uniform(size=(40, 36)) > 0.3).astype(np.float32)
    want = np.asarray(jimage.sobel_magnitude(jnp.asarray(pos)))
    got = timage.sobel_magnitude(torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jimage.edge_from_pos(jnp.asarray(pos),
                                           jnp.asarray(mask)))
    got = timage.edge_from_pos(torch.from_numpy(pos),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    batch = timage.edge_from_pos(torch.from_numpy(np.stack([pos, pos])),
                                 torch.from_numpy(np.stack([mask, mask])))
    np.testing.assert_array_equal(batch.numpy()[1], want)


@pytest.mark.parametrize("shape,out", [((37, 41, 3), (64, 80)),
                                       ((64, 64, 4), (29, 33)),
                                       ((96, 96, 1), (48, 48)),
                                       ((24, 64, 3), (48, 32))])
def test_resize_matches_jax(shape, out):
    """Keys cubic a = -0.5 with antialiasing when it shrinks: F.interpolate's
    antialiased bicubic, within f32 rounding of jax.image.resize."""
    x = np.random.default_rng(6).uniform(size=shape).astype(np.float32)
    want = np.asarray(jimage.resize(jnp.asarray(x), out))
    got = timage.resize(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("actions,test_mode", [(("jumping",), True),
                                               ((), True), ((), False)],
                         ids=["animated_yaw", "rest_rotate", "rest_pose"])
def test_run_render_cli_matches_jax(tmp_path, monkeypatch, actions,
                                    test_mode):
    monkeypatch.setattr(janim, "BASE_RES", 64)
    monkeypatch.setattr(tanim, "BASE_RES", 64)
    root = str(tmp_path)
    paths = synthetic.write_rig_uid(root, "u", actions=actions)
    rc = run_render.main(["--uid", "u", "--data_dir", root, "--device", "cpu"]
                         + (["--test"] if test_mode else []))
    assert rc == 0
    mesh = [f for f in os.listdir(paths.mesh_dir) if f.endswith(".obj")]
    done = sorted(os.listdir(paths.render_dir))
    assert done == ((sorted(actions) or ["rest_rotate"]) if test_mode
                    else ["rest_pose"])
    for action in done:
        fbx = "rest_pose.fbx" if action.startswith("rest") \
            else f"{action}.fbx"
        ref = str(tmp_path / "jax" / action)
        info = janim.render_animation(
            os.path.join(paths.fbx_dir, fbx),
            os.path.join(paths.mesh_dir, mesh[0]), ref,
            yaw_deg=30.0 if action in ("jumping", "rest_rotate") else 0.0)
        assert info["frames"] == (31 if actions else 1)
        for name in ("color", "pos", "edge"):
            files = sorted(os.listdir(os.path.join(ref, name)))
            assert files == sorted(os.listdir(
                os.path.join(paths.action_dir(action), name)))
            assert len(files) == info["frames"]
            for f in files:
                want = read_image_u8(os.path.join(ref, name, f)).astype(int)
                got = read_image_u8(os.path.join(
                    paths.action_dir(action), name, f)).astype(int)
                assert got.shape == want.shape == (info["size"],
                                                   info["size"],
                                                   1 if name == "edge" else 4)
                if name == "edge":
                    assert (got != want).mean() < ALPHA_EDGE_SHARE
                else:
                    assert np.abs(got[..., :3] - want[..., :3]).max() <= 1
                    assert (got[..., 3] != want[..., 3]).mean() \
                        < ALPHA_EDGE_SHARE


def test_run_render_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    synthetic.write_rig_uid(str(tmp_path), "u")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_render.main(["--uid", "u", "--data_dir", str(tmp_path)])
    assert not os.path.exists(os.path.join(str(tmp_path), "u", "mesh",
                                           "blender_render"))

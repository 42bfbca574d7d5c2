"""PyTorch port, stage 2b: the export, the copied host helpers, and the
recon CLI end to end, against the JAX package.

  * (e) the export's u8 field against JAX's ``eval_smoothed_grid_sparse``
    at R = 64 from the same params and extent: within ±1 everywhere with
    f32 compute (the gaussian's f32 sums land on the other side of a u8
    rounding edge); with bf16 compute, see the test;
  * (f) the copies: cameras, the data loader, config and overrides, the
    NSR config, contract paths, OBJ IO, the synthetic uid, the front crop,
    marching and remesh, and ``save_mesh``'s OBJ bytes, each equal to its
    original;
  * (g) ``python -m drawingspinup_torch.cli.recon --device cpu`` at the
    tiny overrides of ``tests/test_stage2_pipeline.py``: the OBJ under the
    reference name, the sphere's radius, and a resume that re-exports.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drawingspinup_tpu.core import UidPaths as JPaths
from drawingspinup_tpu.core import config as jconfig
from drawingspinup_tpu.core import io as jio
from drawingspinup_tpu.pipelines import stage2_recon as js2
from drawingspinup_tpu.render import cameras as jcam
from drawingspinup_tpu.render import marching as jmarch
from drawingspinup_tpu.render import mesh_post as jpost
from drawingspinup_tpu.train import nsr as jnsr
from drawingspinup_tpu.utils.synthetic import write_sphere_mv as j_sphere
from drawingspinup_torch.cli import recon as trecon
from drawingspinup_torch.core import config as tconfig
from drawingspinup_torch.core import contract as tcontract
from drawingspinup_torch.core import io as tio
from drawingspinup_torch.pipelines import stage2_data as tdata
from drawingspinup_torch.pipelines import stage2_export as texport
from drawingspinup_torch.pipelines import stage2_recon as ts2
from drawingspinup_torch.render import cameras as tcam
from drawingspinup_torch.render import marching as tmarch
from drawingspinup_torch.render import mesh_post as tpost
from drawingspinup_torch.utils import jax_params
from drawingspinup_torch.utils.synthetic import write_sphere_mv
from test_torch_nsr import configs
from torch_native_guard import ensure_jax_native
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = "drawingspinup_tpu/configs/neus-ortho.yaml"
TINY_OVERRIDES = [
    "trainer.max_steps=120",
    "system.constant_steps=40",
    "dataset.imSize=[64, 64]",
    "model.train_num_rays_fixed=256",
    "model.geometry.isosurface.resolution=64",
    "model.geometry.face_count=3000",
    "model.geometry.xyz_encoding_config.n_levels=4",
    "model.geometry.xyz_encoding_config.log2_hashmap_size=13",
    "model.geometry.xyz_encoding_config.base_resolution=8",
    "model.geometry.xyz_encoding_config.start_level=4",
    "model.geometry.mlp_network_config.n_neurons=32",
    "model.texture.mlp_network_config.n_neurons=32",
    "export.thinning=false",
]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library, built under a lock if another worker's
    build raced this one's."""
    ensure_jax_native()


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sphere"))
    write_sphere_mv(root, "s", size=64)
    return root


# ---------------------------------------------------------------------------
# (e) the export
# ---------------------------------------------------------------------------

def _trained_like(tdt, cdt):
    """JAX's init of the small test config with its tables redrawn at
    scale 0.05, so that every level shapes the surface."""
    jc, tc = configs(tdt, cdt)
    params = jax.device_get(jnsr.init_params(jc, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(8)
    params["geometry"]["table"] = tuple(
        jnp.asarray(rng.standard_normal(np.shape(x)) * 0.05, jnp.dtype(tdt))
        for x in params["geometry"]["table"])
    return jc, tc, params


def _off_by_more_than_one(got, want):
    return float((np.abs(got.astype(np.int16) - want) > 1).mean())


@pytest.mark.parametrize("tdt,cdt", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_export_field_matches_jax(tdt, cdt, sphere):
    """bbox, then the carved, smoothed u8 field at R = 64 over JAX's extent,
    then the marched and remeshed mesh of each. With f32 compute the field
    is within ±1 everywhere. With bf16 compute the MLP's last bias add
    rounds to bf16 (2^-9 at |h| ~ 0.5), so a one-ulp difference in the
    f32-summed product before it moves the SDF by up to ~2e-3 and flips a
    voxel's sign near the surface, which the gaussian spreads over its
    neighbours (a flip moves the u8 field by up to 16): fewer than 0.5 % of
    voxels more than 1 apart (measured 0.24 %), the bound chip_smoke
    sets between the kernel and plain fields."""
    jc, tc, params = _trained_like(tdt, cdt)
    tp = jax_params.nsr_params(params, requires_grad=False)
    R, step = 64, jc.max_steps
    front = js2.load_front_mask(JPaths(sphere, "s"))
    np.testing.assert_array_equal(
        tdata.load_front_mask(tcontract.UidPaths(sphere, "s")), front)
    vmin, vmax = js2._bbox_pass(jc, params, R, step, sparse=True,
                                use_blocks=True)
    ev = texport.FieldEvaluator(tc, tp, step, "cpu")
    tvmin, tvmax = texport.bbox_pass(ev, R, tc.radius)
    np.testing.assert_array_equal(tvmin, vmin)
    np.testing.assert_array_equal(tvmax, vmax)
    for mask in (front, None):
        want = js2.eval_smoothed_grid_sparse(jc, params, vmin, vmax, R,
                                             step=step, front_mask=mask)
        got = texport.smoothed_field(ev, vmin, vmax, R, mask).numpy()
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape == (R, R, R)
        assert 0.05 < (want > 127).mean() < 0.9
        if cdt == "float32":
            assert np.abs(got.astype(np.int16) - want).max() <= 1
        else:
            assert _off_by_more_than_one(got, want) < 5e-3
    tv, tf_ = texport.isosurface_from_smoothed(want, vmin, vmax, R, 2000)
    jv, jf_ = js2.isosurface_from_smoothed(want, vmin, vmax, R, 2000)
    np.testing.assert_array_equal(tf_, jf_)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)


def test_gaussian_blur_is_scipys_reflect():
    """The separable conv over flip-and-cat padding against scipy's
    ``gaussian_filter`` (mode 'reflect', the edge included), on a field
    that touches its faces."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(9)
    x = (rng.uniform(0, 1, (12, 10, 9)) > 0.6).astype(np.float32)
    got = texport.gaussian_blur3d(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, gaussian_filter(x, 1.0), rtol=0,
                               atol=2e-7)


# ---------------------------------------------------------------------------
# (f) the copies
# ---------------------------------------------------------------------------

def test_cameras_are_the_originals():
    views = ["front", "front_right", "right", "back", "left", "front_left"]
    for v in views:
        np.testing.assert_array_equal(tcam.w2c_opengl(v), jcam.w2c_opengl(v))
        np.testing.assert_array_equal(
            tcam.opengl_to_opencv(tcam.w2c_opengl(v)),
            jcam.opengl_to_opencv(jcam.w2c_opengl(v)))
    for a, b in zip(tcam.view_matrices(views), jcam.view_matrices(views)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcam.ortho_ray_grid(40, 24), jcam.ortho_ray_grid(40, 24)):
        np.testing.assert_array_equal(a, b)
    o, d = jcam.ortho_ray_grid(16, 16)
    c2w = jcam.view_matrices(["front_left"])[0][0]
    for a, b in zip(tcam.rays_to_world(o.reshape(-1, 3), d.reshape(-1, 3),
                                       c2w),
                    jcam.rays_to_world(o.reshape(-1, 3), d.reshape(-1, 3),
                                       c2w)):
        np.testing.assert_array_equal(a, b)


def test_data_loader_is_the_originals(sphere):
    """Images, normals, masks, cameras and hull intervals of the 64² views
    (hull: within 1e-5, the march's f32 sums in torch), and the uid's
    view sets."""
    want = js2.load_ortho_data(JPaths(sphere, "s"), im_size=64)
    got = tdata.load_ortho_data(tcontract.UidPaths(sphere, "s"), im_size=64)
    assert set(got) == set(want) | {"pixels"}
    for k in want:
        if k == "t_range":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
    # resized on load (64² files read at 32²)
    small = js2.load_ortho_data(JPaths(sphere, "s"), im_size=32,
                                hull_trange=False)
    np.testing.assert_array_equal(
        tdata.load_ortho_arrays(tcontract.UidPaths(sphere, "s"),
                                32)["normals"], np.asarray(small["normals"]))
    for uid in ("s", *js2.TWO_VIEW_UIDS, *js2.FOUR_VIEW_UIDS):
        assert tdata.views_for_uid(uid) == js2.views_for_uid(uid)


def test_synthetic_uid_is_the_originals(tmp_path):
    write_sphere_mv(tmp_path / "t", "u", size=32)
    j_sphere(tmp_path / "j", "u", size=32)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert len(files) == 19
    for f in files:
        with open(tmp_path / "j" / f, "rb") as a, \
                open(tmp_path / "t" / f, "rb") as b:
            assert a.read() == b.read(), f


def test_config_and_nsr_config_are_the_originals(tmp_path):
    """The yaml byte-equal; loading, ``key=value`` overrides and
    interpolation as the original; ``nsr_config_from_yaml`` field for
    field (at the production yaml and the tiny overrides)."""
    with open(os.path.join(REPO, YAML), "rb") as a, open(os.path.join(
            REPO, "drawingspinup_torch/configs/neus-ortho.yaml"), "rb") as b:
        assert a.read() == b.read()
    y = tmp_path / "c.yaml"
    y.write_text("a: 3\nb: ${add:${a},2}\nc:\n  d: ${a}\n  e: [1, 2]\n"
                 "f: x_${c.d}\n")
    over = ["c.d=7", "g=[64, 64]", "h=true", "c.e=[3]"]
    want = jconfig.load_config(str(y), over).to_dict()
    got = tconfig.load_config(str(y), over)
    assert _plain(got) == want
    for over in ([], TINY_OVERRIDES):
        j = js2.nsr_config_from_yaml(jconfig.load_config(
            os.path.join(REPO, YAML), over))
        t = ts2.nsr_config_from_yaml(tconfig.load_config(
            os.path.join(REPO, YAML), over))
        want = dataclasses.asdict(j)
        # recon runs analytic gradients: the port has no grad_type option
        assert want.pop("grad_type") == "analytic"
        assert dataclasses.asdict(t) == want


def _plain(cfg):
    if isinstance(cfg, dict):
        return {k: _plain(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [_plain(v) for v in cfg]
    return cfg


def test_contract_paths_and_obj_io_are_the_originals(tmp_path):
    t, j = tcontract.UidPaths("/r", "u"), JPaths("/r", "u")
    assert (t.mask, t.mesh_dir, t.char_dir) == (j.mask, j.mesh_dir,
                                               j.char_dir)
    for kind in ("color", "normal", "mask"):
        assert t.mv(kind, "front_left") == j.mv(kind, "front_left")
    lst = tmp_path / "uids.json"
    lst.write_text('["a", "b"]')
    from drawingspinup_tpu.core.contract import load_uid_list
    assert tcontract.load_uid_list(str(lst)) == load_uid_list(str(lst))
    rng = np.random.default_rng(10)
    v = rng.standard_normal((30, 3)).astype(np.float32)
    f = rng.integers(0, 30, (40, 3))
    c = rng.uniform(-0.1, 1.1, (30, 3)).astype(np.float32)
    for colors in (None, c):
        tio.write_obj(str(tmp_path / "t.obj"), v, f, colors)
        jio.write_obj(str(tmp_path / "j.obj"), v, f, colors)
        assert (tmp_path / "t.obj").read_bytes() == \
            (tmp_path / "j.obj").read_bytes()
        for a, b in zip(tio.read_obj(str(tmp_path / "t.obj")),
                        jio.read_obj(str(tmp_path / "t.obj"))):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)
    assert ts2.export_name(3000, 512, 50000, True, True, False, True, True) \
        == js2.export_name(3000, 512, 50000, True, True, False, True, True)


def test_front_crop_march_remesh_and_save_mesh_are_the_originals(
        sphere, tmp_path):
    """From a u8 sphere field: the native march (vertex for vertex), the
    front crop, the remesh, and ``save_mesh``'s OBJ bytes with and without
    color back-projection, with thinning and with the UV atlas."""
    n = 48
    g = np.linspace(-1, 1, n)
    r = np.sqrt(sum(a ** 2 for a in np.meshgrid(g, g, g, indexing="ij")))
    u8 = np.round(np.clip(0.5 + (0.7 - r) * 4, 0, 1) * 255).astype(np.uint8)
    tv, tf_ = tmarch.marching_tetrahedra(u8, 0.5)
    jv, jf_ = jmarch.marching_tetrahedra(u8, 0.5)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf_, jf_)
    rv, rf = tpost.remesh(tv, tf_, 3000)
    jrv, jrf = jpost.remesh(jv, jf_, 3000)
    np.testing.assert_array_equal(rv, jrv)
    np.testing.assert_array_equal(rf, jrf)
    verts = rv / (n - 1) * 1.4 - 0.7
    front = js2.load_front_mask(JPaths(sphere, "s"))
    vmin, vmax = np.float32([-0.6] * 3), np.float32([0.5] * 3)
    np.testing.assert_array_equal(texport.front_crop(front, vmin, vmax, 40),
                                  js2.front_crop(front, vmin, vmax, 40))
    paths = JPaths(sphere, "s")
    color = jio.read_image(paths.mv("color", "front"))[..., :3]
    back = jio.read_image(paths.mv("color", "back"))[..., :3]
    mask = jio.read_image(paths.mask)[..., 0]
    cols = np.random.default_rng(11).uniform(0, 1, (len(verts), 3))
    for kw in ({"front_mask": mask, "front_color": color,
                "back_color": back},
               {"vert_colors": cols, "color_back_projection": False},
               {"vert_colors": cols, "color_back_projection": False,
                "smoothing": False, "shearing": False}):
        tpost.save_mesh(str(tmp_path / "t.obj"), verts, rf, **kw)
        jpost.save_mesh(str(tmp_path / "j.obj"), verts, rf, **kw)
        assert (tmp_path / "t.obj").read_bytes() == \
            (tmp_path / "j.obj").read_bytes()
    # thinning and the UV atlas: every file written byte-equal
    for i, kw in enumerate(({"front_mask": mask, "front_color": color,
                             "thinning": True},
                            {"vert_colors": cols, "export_uv": True,
                             "color_back_projection": False})):
        for d, mod in ((f"t{i}", tpost), (f"j{i}", jpost)):
            mod.save_mesh(str(tmp_path / d / "m.obj"), verts, rf, **kw)
        t_files = sorted((tmp_path / f"t{i}").iterdir())
        j_files = sorted((tmp_path / f"j{i}").iterdir())
        assert [p.name for p in t_files] == [p.name for p in j_files]
        for a, b in zip(t_files, j_files):
            assert a.read_bytes() == b.read_bytes(), a.name


# ---------------------------------------------------------------------------
# (g) the recon CLI on the CPU
# ---------------------------------------------------------------------------

def test_recon_cli_on_cpu(tmp_path, capsys):
    """Train 120 steps and export at mc64 on the CPU: the OBJ under the
    reference name approximates the sphere (radius ≈ 0.45·0.5·1.35 after
    the export's ×0.5 and ×ortho_scale, within 35 %, the bound of
    tests/test_stage2_pipeline.py); the checkpoint is written; a second
    run resumes from it and re-exports without training."""
    paths = write_sphere_mv(tmp_path, "sphere_uid")
    argv = ["--uid", "sphere_uid", "--root", str(tmp_path), "--device", "cpu",
            *TINY_OVERRIDES]
    assert trecon.main(argv) == 0
    name = "it120-mc64-f3000_c_r_s_cbp.obj"
    obj = os.path.join(paths.mesh_dir, name)
    assert sorted(os.listdir(paths.mesh_dir)) == ["ckpt", name]
    assert os.listdir(os.path.join(paths.mesh_dir, "ckpt")) == ["step_120.pt"]
    v, f, c = tio.read_obj(obj)
    assert len(v) > 100 and len(f) > 100 and c is not None
    expected = 0.45 * 0.5 * 1.35
    r = float(np.median(np.linalg.norm(v, axis=1)))
    assert abs(r - expected) / expected < 0.35, (r, expected)
    stats = ts2.LAST_STATS
    assert stats["steps"] == 120 and list(stats["phase_ms"]) == [4]
    # the resume re-exports, here with the radiance field's colors in place
    # of the back-projected ones: the same geometry under the other name
    capsys.readouterr()
    assert trecon.main(argv + ["export.color_back_projection=false"]) == 0
    assert "resumed from step 120" in capsys.readouterr().out
    assert ts2.LAST_STATS["steps"] == 0
    v2, f2, c2 = tio.read_obj(os.path.join(
        paths.mesh_dir, "it120-mc64-f3000_c_r_s.obj"))
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(f2, f)
    assert c2 is not None and 0 <= c2.min() and c2.max() <= 1
    assert not np.array_equal(c2, c)

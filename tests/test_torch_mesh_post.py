"""PyTorch port, stage-2b host helpers: the copies of the skeleton
utilities, the binary smoothing and f32 march, thin-part flattening, the
UV atlas and the textured OBJ writer, each bit-equal to the JAX package's
original on fixtures made from a seed.

The thinning fixture is a character with a thin arm: a sphere body with a
box arm 0.05 deep in z, marched and remeshed, under a drawing mask whose
arm is a 3-px stroke, so that the stroke's skeleton lies within θ₂ of the
background and the arm's vertices get z-offsets.
"""

import numpy as np
import pytest

from drawingspinup_tpu.core import io as jio
from drawingspinup_tpu.ops import skeleton as jsk
from drawingspinup_tpu.render import marching as jmarch
from drawingspinup_tpu.render import mesh_post as jpost
from drawingspinup_torch.core import io as tio
from drawingspinup_torch.ops import skeleton as tsk
from drawingspinup_torch.render import marching as tmarch
from drawingspinup_torch.render import mesh_post as tpost
from torch_native_guard import ensure_jax_native

RES = 128           # the drawing mask's size


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library, built under a lock if another worker's
    build raced this one's."""
    ensure_jax_native()


def _masks(seed: int):
    """Blobs and strokes of a seeded drawing, u8 0/255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:64]
    m = np.zeros((64, 64), bool)
    for _ in range(4):
        cy, cx, r = rng.uniform(10, 54, 2).tolist() + [rng.uniform(4, 10)]
        m |= np.hypot(yy - cy, xx - cx) < r
    for _ in range(3):
        r0, c0 = rng.integers(4, 60, 2)
        m[r0:r0 + 2, max(c0 - 15, 0):c0 + 15] = True
    return (m * 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_skeleton_utilities_are_the_originals(seed):
    mask = _masks(seed)
    for name in ("distance_transform_l2", "skeletonize", "dilate", "erode"):
        np.testing.assert_array_equal(getattr(tsk, name)(mask),
                                      getattr(jsk, name)(mask), err_msg=name)
    skel = jsk.skeletonize(mask)
    assert tsk.end_points(skel) == jsk.end_points(skel)
    centers = tsk.end_points(skel)[:5] + [(0, 0), (63, 63)]
    np.testing.assert_array_equal(tsk.stamp_discs(mask, centers, 3, 7),
                                  jsk.stamp_discs(mask, centers, 3, 7))
    thin = ((skel > 0) & (jsk.distance_transform_l2(mask) <= 3)) * 255
    np.testing.assert_array_equal(
        tsk.remove_intersections(thin.astype(np.uint8), skel, 4),
        jsk.remove_intersections(thin.astype(np.uint8), skel, 4))
    np.testing.assert_array_equal(tsk.remove_short_lines(skel, 12),
                                  jsk.remove_short_lines(skel, 12))
    xy = np.random.default_rng(seed).uniform(-2, 66, (50, 2))
    img = np.random.default_rng(seed + 1).uniform(0, 1, (64, 64, 3))
    np.testing.assert_array_equal(tsk.bilinear_sample(img, xy),
                                  jsk.bilinear_sample(img, xy))


def test_smooth_binary_and_f32_march_are_the_originals():
    """``smooth_binary``, the native march of an f32 field and
    ``extract_isosurface``, vertex for vertex."""
    rng = np.random.default_rng(3)
    n = 40
    g = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    binary = (np.sqrt(x ** 2 + 1.5 * y ** 2 + z ** 2)
              + 0.1 * rng.standard_normal((n, n, n)) < 0.7)
    np.testing.assert_array_equal(tmarch.smooth_binary(binary),
                                  jmarch.smooth_binary(binary))
    field = jmarch.smooth_binary(binary)
    for a, b in zip(tmarch.marching_tetrahedra(field, 0.5),
                    jmarch.marching_tetrahedra(field, 0.5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tmarch.extract_isosurface(binary),
                    jmarch.extract_isosurface(binary)):
        assert len(a) > 100
        np.testing.assert_array_equal(a, b)


def _armed_character():
    """(verts in the y-up export space, faces, the drawing mask)."""
    n = 72
    g = np.linspace(-0.6, 0.6, n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    body = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.24
    q = np.stack([np.abs(x - 0.33) - 0.12, np.abs(y) - 0.03,
                  np.abs(z) - 0.025])
    arm = (np.linalg.norm(np.maximum(q, 0), axis=0)
           + np.minimum(q.max(0), 0))
    field = np.clip(0.5 - np.minimum(body, arm) * 20, 0, 1).astype(np.float32)
    v, f = jmarch.marching_tetrahedra(field, 0.5)
    v, f = jpost.remesh(v / (n - 1) * 1.2 - 0.6, f, 6000)
    yy, xx = np.mgrid[0:RES, 0:RES]
    c = (RES - 1) / 2
    mask = np.hypot(yy - c, xx - c) < 0.24 * (RES - 1)
    arm_cols = (xx >= c + 0.21 * (RES - 1)) & (xx <= c + 0.45 * (RES - 1))
    mask |= arm_cols & (np.abs(yy - c) <= 1.5)
    return v.astype(np.float32), f, mask.astype(np.float32)


@pytest.fixture(scope="module")
def armed():
    return _armed_character()


def test_thinning_is_the_original(armed):
    """The cotan Laplacian and mass matrix, the biharmonic solve, the
    raycast offsets and ``thinning_processing`` for each thinning type:
    equal arrays, and the arm really moves."""
    v, f, mask = armed
    for a, b in zip(tpost.cotan_laplacian(v, f), jpost.cotan_laplacian(v, f)):
        assert (a != b).nnz == 0
    b_ids = np.arange(0, len(v), 7)
    bc = np.random.default_rng(4).standard_normal((len(b_ids), 3)) * 0.01
    for k in (1, 2):
        np.testing.assert_array_equal(
            tpost.harmonic_deformation(v, f, b_ids, bc, k),
            jpost.harmonic_deformation(v, f, b_ids, bc, k))
    for ttype in ("double", "front", "back"):
        got = tpost.thinning_processing(v, f, mask, ttype)
        want = jpost.thinning_processing(v, f, mask, ttype)
        np.testing.assert_array_equal(got, want, err_msg=ttype)
        arm = v[:, 0] > 0.3
        moved = np.abs(got - v)[:, 2]
        assert moved[arm].max() > 1e-3, ttype
        assert moved[~arm].max() < moved[arm].max()


def test_uv_atlas_is_the_original(armed):
    v, f, _ = armed
    cols = np.random.default_rng(5).uniform(0, 1, (len(v), 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tpost._face_charts(v, f),
                                  jpost._face_charts(v, f))
    got = tpost.uv_atlas(v, f, cols, tex_res=256)
    want = jpost.uv_atlas(v, f, cols, tex_res=256)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2].min() >= 0 and got[2].max() <= 1


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_write_obj_with_uvs_is_the_original(tmp_path):
    rng = np.random.default_rng(6)
    v = rng.standard_normal((20, 3)).astype(np.float32)
    f = rng.integers(0, 20, (30, 3))
    uv = rng.uniform(0, 1, (20, 2)).astype(np.float32)
    tex = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    for d, mod in (("t", tio), ("j", jio)):
        mod.write_obj(str(tmp_path / d / "m.obj"), v, f, uvs=uv,
                      texture_png=tex)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(got) == ["m.mtl", "m.obj", "m.png"]
    assert got == want


@pytest.mark.parametrize("kw", [
    {"thinning": True},
    {"thinning": True, "thinning_type": "front"},
    {"thinning": True, "export_uv": True},
    {"export_uv": True, "color_back_projection": False},
], ids=["thin_double", "thin_front", "thin_uv", "uv"])
def test_save_mesh_thinning_and_uv_are_the_original(armed, tmp_path, kw):
    """``save_mesh`` with thinning and with the UV atlas: every file it
    writes byte-equal to the original's (the export's ×0.5 undone on the
    fixture, colors back-projected from a seeded front image)."""
    v, f, mask = armed
    rng = np.random.default_rng(7)
    verts = np.stack([v[:, 0], -v[:, 2], v[:, 1]], 1) * 2   # export input
    color = rng.uniform(0, 1, (RES, RES, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (len(v), 3)).astype(np.float32)
    args = dict(front_mask=mask, front_color=color, vert_colors=cols, **kw)
    for d, mod in (("t", tpost), ("j", jpost)):
        (tmp_path / d).mkdir()
        mod.save_mesh(str(tmp_path / d / "m.obj"), verts, f, **args)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert ("m.png" in got) == bool(kw.get("export_uv"))
    assert got == want

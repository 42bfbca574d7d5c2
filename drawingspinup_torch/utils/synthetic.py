"""Synthetic per-uid fixtures for the tests and the smoke run: a copy of
``drawingspinup_tpu/utils/synthetic.py`` (``tests/test_torch_recon.py``
pins its files to the original's), the two-bone rig and bar mesh of
``tests/test_fbx_render.py`` (``tests/test_torch_render.py`` pins the FBX
bytes), the drawing of ``tests/test_stage1.py``
(``tests/test_torch_stage1.py`` pins the PNG bytes), coloured OBJs for
the BiCar renderer of stage-1 training, the in-memory sphere views of
``scripts/bench_nsr.py::make_sphere_dataset`` (``sphere_dataset``), and
the toy golden flow of ``tests/golden_pipeline.py`` through the port's CLIs
(``run_toy_flow``; ``tests/test_torch_goldens.py`` pins its drawing and
budgets)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import write_image, write_obj


def sphere_dataset(n_views=6, size=1024, radius=0.5, hull=False,
                   scene_radius=1.0, device="cpu"):
    """An NSR training dict of an analytic sphere seen by the first
    ``n_views`` ortho cameras (``scripts/bench_nsr.py``'s
    ``make_sphere_dataset``): world normals, colours 0.5 + 0.5·n, masks,
    unit view weights, c2w; the visual-hull ``t_range`` with ``hull``;
    the packed ``pixels`` table of the NSR step."""
    import torch

    from drawingspinup_torch.core.contract import VIEWS
    from drawingspinup_torch.render.cameras import (
        ortho_ray_grid, rays_to_world, view_matrices,
    )
    from drawingspinup_torch.render.hull import hull_t_ranges
    from drawingspinup_torch.train.nsr import pack_pixels

    c2ws, _ = view_matrices(list(VIEWS[:n_views]))
    origins, dirs = ortho_ray_grid(size, size)
    images, normals, masks = [], [], []
    for c2w in c2ws:
        ro, rd = rays_to_world(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                               c2w)
        b = np.sum(ro * rd, -1)
        c = np.sum(ro * ro, -1) - radius ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        n = (ro + t[:, None] * rd) / radius
        col = np.clip(0.5 + 0.5 * n, 0, 1)
        images.append(np.where(hit[:, None], col, 0.0).reshape(size, size, 3))
        normals.append(np.where(hit[:, None], n, 0.0).reshape(size, size, 3))
        masks.append(hit.reshape(size, size).astype(np.float32))

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    data = {"images": dev(np.stack(images)), "normals": dev(np.stack(normals)),
            "masks": dev(np.stack(masks)),
            "view_weights": dev(np.ones((n_views,))), "c2w": dev(c2ws)}
    if hull:
        data["t_range"] = hull_t_ranges(data["masks"], data["c2w"],
                                        scene_radius)
    data["pixels"] = pack_pixels(data)
    return data


def write_sphere_mv(root, uid, size=64, radius=0.45):
    """Render analytic sphere views into the mv/ contract layout."""
    from drawingspinup_torch.render.cameras import (
        opengl_to_opencv, ortho_ray_grid, rays_to_world, view_matrices,
        w2c_opengl,
    )
    paths = UidPaths(str(root), uid)
    views = ["front", "front_right", "right", "back", "left", "front_left"]
    c2ws, w2cs = view_matrices(views)
    origins, dirs = ortho_ray_grid(size, size)
    front_w2c = opengl_to_opencv(w2c_opengl("front"))
    gl2cv = np.array([1.0, -1.0, -1.0], np.float32)
    for view, c2w, w2c in zip(views, c2ws, w2cs):
        ro, rd = rays_to_world(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                               c2w)
        b = np.sum(ro * rd, -1)
        c = np.sum(ro * ro, -1) - radius ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        p = ro + t[:, None] * rd
        n_world = p / radius
        color = np.clip(0.5 + 0.5 * n_world, 0, 1)
        color = np.where(hit[:, None], color, 0).reshape(size, size, 3)
        # normals are stored in the FRONT view camera system as images:
        # n_front_cam_cv = R_front_w2c @ n_world, then cv→gl flip, →[0,1]
        n_cam = n_world @ front_w2c[:3, :3].T
        n_gl = n_cam * gl2cv
        nimg = np.where(hit[:, None], n_gl * 0.5 + 0.5, 0.5)
        nimg = nimg.reshape(size, size, 3)
        mask = hit.reshape(size, size).astype(np.float32)
        write_image(paths.mv("color", view), color)
        write_image(paths.mv("normal", view), np.where(mask[..., None] > 0,
                                                       nimg, 0.0))
        write_image(paths.mv("mask", view), mask)
    # front drawing mask for carving/thinning
    m = np.asarray(
        np.hypot(*np.mgrid[-1:1:size * 1j, -1:1:size * 1j]) < radius * 2,
        np.float32)
    write_image(paths.mask, m)
    return paths


# ---------------------------------------------------------------------------
# stage 3: a skinned two-bone rig; stage 1: a drawing
# ---------------------------------------------------------------------------

def bar_mesh(n_seg=8, half=0.08, height=2.0):
    """A vertical bar along z (square cross-section), segmented so skinning
    can bend it: 4 (n_seg + 1) vertices, 8 n_seg faces."""
    verts, faces = [], []
    ring = [(-half, -half), (half, -half), (half, half), (-half, half)]
    for s in range(n_seg + 1):
        z = height * s / n_seg
        for (x, y) in ring:
            verts.append([x, y, z])
    for s in range(n_seg):
        for k in range(4):
            a = s * 4 + k
            b = s * 4 + (k + 1) % 4
            c = (s + 1) * 4 + k
            d = (s + 1) * 4 + (k + 1) % 4
            faces += [[a, b, d], [a, d, c]]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def _p70(entries):
    from drawingspinup_torch.render import fbx as F

    node = F.Node("Properties70")
    for name, vals in entries.items():
        node.children.append(
            F.Node("P", [name, name, "", "A"] + list(vals)))
    return node


def _trans4(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


def make_rig_fbx(path, animate=True, n_seg=8, duration=1.0, height=2.0,
                 half=0.08):
    """Two-bone chain along z, the joint at mid-height, the child bone
    rotating 90° about X over ``duration`` seconds; the skinned mesh is
    ``bar_mesh(n_seg, half, height)``. The defaults write the bytes of
    ``tests/test_fbx_render.py::make_rig_fbx``. Returns (verts, faces)."""
    from drawingspinup_torch.render import fbx as F

    verts, faces = bar_mesh(n_seg, half, height)
    joint = height / 2
    poly = []
    for f in faces:
        poly += [int(f[0]), int(f[1]), ~int(f[2])]

    geom = F.Node("Geometry", [150, "Geometry::bar", "Mesh"])
    geom.children.append(F.Node("Vertices",
                                [verts.astype(np.float64).ravel()]))
    geom.children.append(F.Node("PolygonVertexIndex",
                                [np.asarray(poly, np.int32)]))

    mesh_model = F.Node("Model", [100, "Model::bar", "Mesh"])
    bone0 = F.Node("Model", [200, "Model::root", "LimbNode"])
    bone0.children.append(_p70({"Lcl Translation": (0.0, 0.0, 0.0)}))
    bone1 = F.Node("Model", [201, "Model::upper", "LimbNode"])
    bone1.children.append(_p70({"Lcl Translation": (0.0, 0.0, joint)}))

    lower = verts[:, 2] < joint
    c0 = F.Node("Deformer", [300, "SubDeformer::c0", "Cluster"])
    c0.children.append(F.Node("Indexes",
                              [np.nonzero(lower)[0].astype(np.int32)]))
    c0.children.append(F.Node("Weights",
                              [np.ones(lower.sum(), np.float64)]))
    c0.children.append(F.Node("Transform", [np.eye(4).ravel()]))
    c0.children.append(F.Node("TransformLink", [np.eye(4).ravel()]))
    c1 = F.Node("Deformer", [301, "SubDeformer::c1", "Cluster"])
    c1.children.append(F.Node("Indexes",
                              [np.nonzero(~lower)[0].astype(np.int32)]))
    c1.children.append(F.Node("Weights",
                              [np.ones((~lower).sum(), np.float64)]))
    c1.children.append(F.Node("Transform", [np.eye(4).ravel()]))
    # column-major flatten: the writer stores raw, the parser transposes
    c1.children.append(F.Node("TransformLink",
                              [_trans4([0, 0, joint]).T.ravel()]))

    objects = F.Node("Objects")
    objects.children += [geom, mesh_model, bone0, bone1, c0, c1]

    conns = F.Node("Connections")

    def C(kind, a, b, prop=None):
        props = [kind, a, b] + ([prop] if prop else [])
        conns.children.append(F.Node("C", props))

    C("OO", 150, 100)
    C("OO", 201, 200)
    C("OO", 200, 300)
    C("OO", 201, 301)

    if animate:
        t = (np.array([0.0, duration]) * F.KTIME_PER_SEC).astype(np.int64)
        cx = F.Node("AnimationCurve", [500, "AnimCurve::x", ""])
        cx.children.append(F.Node("KeyTime", [t]))
        cx.children.append(F.Node("KeyValueFloat",
                                  [np.array([0.0, 90.0], np.float32)]))
        cn = F.Node("AnimationCurveNode", [400, "AnimCurveNode::R", ""])
        cn.children.append(_p70({"d|X": (0.0,), "d|Y": (0.0,),
                                 "d|Z": (0.0,)}))
        objects.children += [cx, cn]
        C("OP", 500, 400, "d|X")
        C("OP", 400, 201, "Lcl Rotation")

    F.write_fbx(path, [objects, conns])
    return verts, faces


def write_rig_uid(root, uid, actions=(), n_seg=8, duration=1.0, height=2.0,
                  half=0.08):
    """A rigged uid for ``cli/run_render.py``: the bar as the recon OBJ
    (vertex colours banded along the bar), ``fbx_files/rest_pose.fbx``
    (static) and one animated FBX per name in ``actions``."""
    from drawingspinup_torch.core.io import write_obj

    paths = UidPaths(str(root), uid)
    os.makedirs(paths.fbx_dir, exist_ok=True)
    verts, faces = make_rig_fbx(os.path.join(paths.fbx_dir, "rest_pose.fbx"),
                                False, n_seg, duration, height, half)
    for action in actions:
        make_rig_fbx(os.path.join(paths.fbx_dir, f"{action}.fbx"), True,
                     n_seg, duration, height, half)
    z = verts[:, 2:3] / height
    band = np.floor(z * 6) % 2
    colors = np.concatenate([0.85 - 0.5 * band, 0.3 + 0.5 * z,
                             0.2 + 0.6 * band], axis=1)
    write_obj(os.path.join(paths.mesh_dir, f"it3000-mc512-f{len(faces)}.obj"),
              verts, faces, vertex_colors=colors)
    return paths


def write_drawing_uid(root, uid, size=64):
    """A drawing-like RGBA ``char/texture.png``: a coloured disc with a dark
    contour ring (``tests/test_stage1.py::make_synthetic_uid`` at any
    size)."""
    paths = UidPaths(str(root), uid)
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.hypot(yy - size / 2, xx - size / 2)
    body = r < size * 0.3
    ring = (r >= size * 0.28) & (r < size * 0.33)
    rgba = np.zeros((size, size, 4), np.float32)
    rgba[..., 0] = np.where(body, 0.9, 0.0)
    rgba[..., 1] = np.where(body, 0.6, 0.0)
    rgba[..., 2] = np.where(body, 0.3, 0.0)
    rgba[body | ring, :3] = np.where(ring[..., None][body | ring], 0.05,
                                     rgba[body | ring, :3])
    rgba[..., 3] = (body | ring).astype(np.float32)
    write_image(paths.texture, rgba)
    return paths


# ---------------------------------------------------------------------------
# stage-1 training: coloured OBJs for render/bicar.py
# ---------------------------------------------------------------------------

def sphere_mesh(n=24, radius=0.6):
    """A UV sphere: 2 n² vertices on n latitudes × 2 n longitudes."""
    th, ph = np.meshgrid(np.linspace(0, np.pi, n),
                         np.linspace(0, 2 * np.pi, 2 * n))
    v = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], -1).reshape(-1, 3) * radius
    idx = np.arange(2 * n * n).reshape(2 * n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    f = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    return v.astype(np.float32), f.astype(np.int64)


def write_bicar_objs(root, n, seed=0):
    """``n`` OBJs ``<root>/obj<i>/model.obj`` with vertex colours, for
    ``render/bicar.py``: bars (``bar_mesh``) and spheres in turn, of seeded
    proportions, coloured by a seeded linear ramp along a seeded
    direction; returns the uids."""
    rng = np.random.default_rng(seed)
    uids = []
    for i in range(n):
        if i % 2:
            v, f = sphere_mesh(radius=rng.uniform(0.4, 0.8))
        else:
            v, f = bar_mesh(half=rng.uniform(0.08, 0.3),
                            height=rng.uniform(1.0, 2.0))
        t = v @ rng.normal(size=3)
        t = (t - t.min()) / max(float(np.ptp(t)), 1e-6)
        lo, hi = rng.uniform(0, 1, 3), rng.uniform(0, 1, 3)
        uids.append(f"obj{i}")
        write_obj(os.path.join(root, uids[-1], "model.obj"), v, f,
                  vertex_colors=lo + t[:, None] * (hi - lo))
    return uids


# ---------------------------------------------------------------------------
# the toy golden flow: drawing → GIF at tiny budgets
# ---------------------------------------------------------------------------

# the recon budget of ``tests/test_stage2_pipeline.py::TINY_OVERRIDES``
TINY_RECON_OVERRIDES = (
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
)
# stage 1 at a narrow width, and the stage-3 GAN's toy budget
TOY_LAMA_OVERRIDES = ("generator.ngf=8", "generator.n_downsampling=2",
                      "generator.n_blocks=1")
TOY_GAN = dict(generator="GeneratorJ", filters=(8, 16, 16, 16, 16, 8),
               resnet_blocks=1, batch_size=4, patch_size=16,
               input_channels=6, log_interval=10 ** 9)
TOY_SIZE = 64
TOY_STYLE_BATCHES = 3


def write_toy_drawing(root, uid, size=TOY_SIZE):
    """``tests/golden_pipeline.py``'s drawing: an orange disc in a dark
    ring, its mask and its composite on white."""
    paths = UidPaths(str(root), uid)
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.hypot(yy - size / 2, xx - size / 2)
    body = r < size * 0.38
    ring = (r >= size * 0.34) & (r < size * 0.40)
    rgba = np.zeros((size, size, 4), np.float32)
    rgba[body] = [0.85, 0.55, 0.25, 1.0]
    rgba[ring] = [0.05, 0.05, 0.05, 1.0]
    write_image(paths.texture, rgba)
    write_image(paths.mask, (body | ring).astype(np.float32))
    write_image(paths.texture_with_bg,
                rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:]))
    return paths


def run_toy_flow(root, uid, device="cuda", lama_ckpt: Optional[str] = None
                 ) -> Tuple[UidPaths, Dict[str, float]]:
    """``tests/golden_pipeline.py::run_toy_pipeline`` through the port's
    CLIs on ``device``: stage 1 at the narrow width and 64² (the generator
    from ``lama_ckpt``, else drawn from the config's seed), the sphere views
    in place of stage 2a, recon at ``TINY_RECON_OVERRIDES``, the two-bone
    rig rendered, three stage-1 style batches, the GIF. Returns the uid's
    paths and each stage's seconds."""
    from drawingspinup_torch.cli import gif_writer, predict, recon, run_render
    from drawingspinup_torch.pipelines import stage3_translate
    from drawingspinup_torch.train import gan

    root = str(root)
    dev = ["--device", str(device)]
    paths = write_toy_drawing(root, uid)
    uid_file = os.path.join(root, f"{uid}_uids.json")
    with open(uid_file, "w") as f:
        json.dump([uid], f)
    ckpt = [f"pretrained.path={lama_ckpt}"] if lama_ckpt else []
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()

    def done(stage: str, rc: int = 0) -> None:
        nonlocal t0
        if rc != 0:
            raise RuntimeError(f"toy flow: {stage} exited with {rc}")
        seconds[stage] = time.perf_counter() - t0
        t0 = time.perf_counter()

    done("stage1", predict.main(
        [predict.DEFAULT_CFG, *TOY_LAMA_OVERRIDES, *ckpt, "--uid", uid,
         "--root", root, "--batch-size", "1", "--size", str(TOY_SIZE),
         *dev]))
    write_sphere_mv(root, uid, size=TOY_SIZE)
    done("mv")
    done("recon", recon.main(["--uid", uid, "--root", root,
                              f"dataset.uid_list_file={uid_file}",
                              *TINY_RECON_OVERRIDES, *dev]))
    os.makedirs(paths.fbx_dir, exist_ok=True)
    make_rig_fbx(os.path.join(paths.fbx_dir, "rest_pose.fbx"), animate=False)
    done("render", run_render.main(["--uid", uid, "--data_dir", root, *dev]))
    stage3_translate.train_stage(root, uid, 1, cfg=gan.GANConfig(**TOY_GAN),
                                 max_batches=TOY_STYLE_BATCHES, device=device)
    done("train_style")
    done("gif", gif_writer.main(["--uid", uid, "--root", root]))
    return paths, seconds

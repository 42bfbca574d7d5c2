"""PyTorch port, the toy golden run: ``tests/golden_pipeline.py``'s flow,
drawing → GIF, through the port's CLIs on the CPU, judged by the JAX
package's ``cli/fidelity.py`` against the committed goldens
(``tests/data/goldens/``, made by the JAX pipeline).

The flow and budgets are the golden pipeline's: stage 1 at a narrow width
and 64², the sphere fixture in place of stage 2a, recon at its tiny
budget (R = 64, so the level chain, as JAX ran it), the two-bone rig
rendered at the production size, three stage-1 style batches, the GIF.
Where a converter exists the port starts from JAX's init: the LaMa
generator (JAX's ``load_variables`` with no checkpoint, through a
LaMa-named ``state_dict``), the NSR params (``jax_params.nsr_params``) and
the three GAN models (``jax_params.to_state_dict``). The random draws
(rays, patches) are the port's own, as a run on another device count
draws its own in JAX.

Bounds: ``test_single_device_pipeline_matches_dp8_goldens``'s
(``tests/test_goldens.py``): stage-3 images ≥ 20 dB PSNR, every other
image ≥ 30 dB, mesh chamfer ≤ 2.5e-2, mesh V/F within 10 % of the
goldens' stats; and the GIF's frame counts equal.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import golden_pipeline as gp
from drawingspinup_tpu.cli import fidelity
from drawingspinup_tpu.cli import predict as jpredict
from drawingspinup_tpu.core import load_config as jload_config
from drawingspinup_tpu.pipelines import stage1 as js1
from drawingspinup_tpu.pipelines import stage2_recon as js2
from drawingspinup_tpu.train import gan as jgan
from drawingspinup_tpu.train import nsr as jnsr
from drawingspinup_tpu.utils.torch_port import invert_to_torch_names
from drawingspinup_torch.cli import gif_writer, predict, recon, run_render
from drawingspinup_torch.core.contract import UidPaths
from drawingspinup_torch.core.io import read_obj, write_image
from drawingspinup_torch.pipelines import stage3_translate as tst
from drawingspinup_torch.train import gan as tgan
from drawingspinup_torch.train import nsr as tnsr
from drawingspinup_torch.utils import jax_params
from drawingspinup_torch.utils.synthetic import write_sphere_mv
from test_fbx_render import make_rig_fbx
from test_stage2_pipeline import TINY_OVERRIDES
from torch_native_guard import ensure_jax_native
from torch_threads import one_torch_thread  # noqa: F401

STAGE3_FLOOR = 20.0
PSNR_FLOOR = 30.0
CHAMFER_MAX = 2.5e-2
COUNT_TOL = 0.10
LAMA_TINY = ["generator.ngf=8", "generator.n_downsampling=2",
             "generator.n_blocks=1"]
GAN_TINY = dict(generator="GeneratorJ", filters=(8, 16, 16, 16, 16, 8),
                resnet_blocks=1, batch_size=4, patch_size=16,
                input_channels=6, log_interval=10 ** 9)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(gp.GOLDENS_ROOT, gp.GOLDEN_UID)),
    reason="no committed goldens (scripts/make_goldens.py)")


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library, built under a lock if another worker's
    build raced this one's."""
    ensure_jax_native()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _lama_checkpoint(path: str) -> None:
    """JAX predict's init with no checkpoint, as a LaMa-named torch
    checkpoint."""
    cfg = jload_config(jpredict.DEFAULT_CFG, LAMA_TINY)
    v = jpredict.load_variables(cfg, js1.build_generator(cfg))
    sd = {k: torch.from_numpy(np.array(a)) for k, a in invert_to_torch_names(
        v, n_downsampling=2, n_blocks=1).items()}
    torch.save({"state_dict": sd}, path)


def _jax_nsr_init(monkeypatch) -> None:
    """The port's recon starts from JAX's ``init_state`` of the same yaml
    and seed."""
    def init_state(cfg, seed, device="cpu"):
        jcfg = js2.nsr_config_from_yaml(jload_config(
            os.path.join(os.path.dirname(js2.__file__), "..", "configs",
                         "neus-ortho.yaml"), TINY_OVERRIDES))
        jstate = jnsr.init_state(jcfg, jax.random.PRNGKey(seed))
        params = jax_params.nsr_params(_np_tree(jstate.params),
                                       device=device)
        return tnsr.TrainState(params, tnsr.make_optimizer(cfg).init(params),
                               0)

    monkeypatch.setattr(tnsr, "init_state", init_state)


def _jax_gan_init(monkeypatch) -> None:
    """The port's style training starts from JAX's ``init_state`` of the
    same config and seed (generator, discriminator, VGG)."""
    orig = tgan.init_state

    def init_state(cfg, device, seed=0):
        jstate = jgan.init_state(jgan.GANConfig(**dataclasses.asdict(cfg)),
                                 jax.random.PRNGKey(seed))
        state = orig(cfg, device, seed)
        for module, params, stats in (
                (state.gen, jstate.g_params, jstate.g_stats),
                (state.disc, jstate.d_params, None),
                (state.vgg, jstate.vgg_params, None)):
            result = module.load_state_dict(jax_params.to_state_dict(
                _np_tree(params), None if stats is None else _np_tree(stats)))
            assert not result.missing_keys and not result.unexpected_keys
        return state

    monkeypatch.setattr(tgan, "init_state", init_state)


def _run_port_pipeline(root: str, uid: str, monkeypatch) -> UidPaths:
    """``golden_pipeline.run_toy_pipeline`` through the port's CLIs."""
    paths = UidPaths(root, uid)
    size = 64
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
    uid_file = os.path.join(root, f"{uid}_uids.json")
    with open(uid_file, "w") as f:
        json.dump([uid], f)
    cpu = ["--device", "cpu"]

    ckpt = os.path.join(root, "lama_jax_init.pth")
    _lama_checkpoint(ckpt)
    assert predict.main([predict.DEFAULT_CFG, *LAMA_TINY,
                         f"pretrained.path={ckpt}", "--uid", uid, "--root",
                         root, "--batch-size", "1", "--size", "64",
                         *cpu]) == 0
    write_sphere_mv(root, uid, size=64)
    _jax_nsr_init(monkeypatch)
    assert recon.main(["--uid", uid, "--root", root,
                       f"dataset.uid_list_file={uid_file}",
                       *TINY_OVERRIDES, *cpu]) == 0
    os.makedirs(paths.fbx_dir, exist_ok=True)
    make_rig_fbx(os.path.join(paths.fbx_dir, "rest_pose.fbx"), animate=False)
    assert run_render.main(["--uid", uid, "--data_dir", root, *cpu]) == 0
    _jax_gan_init(monkeypatch)
    tst.train_stage(root, uid, 1, cfg=tgan.GANConfig(**GAN_TINY),
                    max_batches=3, device="cpu")
    assert gif_writer.main(["--uid", uid, "--root", root]) == 0
    return paths


def test_port_toy_pipeline_holds_the_cross_run_bounds(tmp_path, monkeypatch):
    root = str(tmp_path)
    paths = _run_port_pipeline(root, gp.GOLDEN_UID, monkeypatch)
    goldens_root = os.path.dirname(os.path.join(gp.GOLDENS_ROOT,
                                                gp.GOLDEN_UID))
    report_path = os.path.join(root, "fidelity.json")
    assert fidelity.main(["--ours", root, "--theirs", goldens_root,
                          "--uid", gp.GOLDEN_UID, "--out", report_path]) == 0
    with open(report_path) as f:
        report = json.load(f)

    stages = [k for k in report
              if k.startswith(("stage1", "stage2a", "stage3"))]
    assert any(k.startswith("stage3") for k in stages), sorted(report)
    for stage in stages:
        assert report[stage]["n"] > 0, stage
        floor = STAGE3_FLOOR if stage.startswith("stage3") else PSNR_FLOOR
        v = report[stage]["aggregate"]["psnr"]
        assert v == "inf" or v >= floor, (stage, report[stage]["aggregate"])

    meshes = report["stage2b_mesh"]["files"]
    assert meshes
    for name, m in meshes.items():
        assert not m.get("missing") and m["chamfer"] <= CHAMFER_MAX, (name, m)
    with open(os.path.join(gp.GOLDENS_ROOT, "..", "stats.json")) as f:
        golden_stats = json.load(f)["mesh"]
    objs = sorted(f for f in os.listdir(paths.mesh_dir) if f.endswith(".obj"))
    assert objs == sorted(golden_stats)
    for name, g in golden_stats.items():
        v, f, _ = read_obj(os.path.join(paths.mesh_dir, name))
        for k, n in (("n_verts", len(v)), ("n_faces", len(f))):
            assert abs(n - g[k]) <= COUNT_TOL * g[k], (name, k, n, g[k])

    gifs = report["gif"]["files"]
    assert gifs
    for name, m in gifs.items():
        assert not m.get("missing"), name
        na, nb = m["n_frames"]
        assert na == nb, (name, m)

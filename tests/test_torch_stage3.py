"""PyTorch port: the stage-3 serving slice (test_stage1 → test_stage2 →
GIF) against the JAX package, plus the copied host helpers and the
package's import hygiene.

Tolerances: PNG outputs within ±1 LSB on < 2 % of RGB pixels and alpha
exact, the contract of tests/test_stage3.py's u8 path (f32 sums in another
order flip the final u8 rounding on a few pixels). The copied numpy and IO
helpers must be exact.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from drawingspinup_tpu.cli import gif_writer as j_gif_writer
from drawingspinup_tpu.core import contract as jcontract
from drawingspinup_tpu.core import io as jio
from drawingspinup_tpu.pipelines import stage3_data as jdata
from drawingspinup_tpu.pipelines import stage3_translate as jst
from drawingspinup_tpu.train import gan as jgan
from drawingspinup_torch.cli import gif_writer as t_gif_writer
from drawingspinup_torch.cli import test_stage1 as t_cli1
from drawingspinup_torch.core import checkpoint as tckpt
from drawingspinup_torch.core import contract as tcontract
from drawingspinup_torch.core import device as tdevice
from drawingspinup_torch.core import io as tio
from drawingspinup_torch.pipelines import stage3_data as tdata
from drawingspinup_torch.pipelines import stage3_translate as tst
from drawingspinup_torch.train import gan as tgan
from drawingspinup_torch.utils import jax_params
from test_torch_generator_j import jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(filters=(8, 16, 16, 16, 16, 8), resnet_blocks=2)
ACTIONS = ("jump", "walk")


def write_uid(root, uid, size, frames, seed):
    """Synthetic per-uid render tree: ``color`` (RGBA, a disc on a clear
    background), ``pos`` and ``edge`` passes for each action and frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.hypot(yy - size / 2, xx - size / 2)
    paths = tcontract.UidPaths(root, uid)
    for action in ACTIONS:
        for k in range(1, frames + 1):
            mask = r < size * rng.uniform(0.3, 0.45)
            color = rng.uniform(0, 1, (size, size, 4)).astype(np.float32)
            color[..., 3] = mask
            color[..., :3] *= mask[..., None]
            pos = np.stack([xx / size, yy / size, np.zeros_like(r)], -1)
            edge = np.where(mask & (r > size * 0.25), 0.0, 1.0)
            d = paths.action_dir(action)
            name = f"{k:04d}.png"
            tio.write_image(os.path.join(d, "color", name), color)
            tio.write_image(os.path.join(d, "pos", name),
                            pos * mask[..., None])
            tio.write_image(os.path.join(d, "edge", name), edge)
    return paths


def save_both_checkpoints(jax_paths, port_paths, stage, cfg, seed):
    """One set of weights, saved as the JAX package's orbax checkpoint and
    as the port's ``model_99999.pt``."""
    params, stats = jax_variables(cfg, seed)
    log = jst.log_name_for(stage, True, True)
    # save_checkpoint reads only the generator's fields of the state
    state = jgan.GANState(params, stats, None, None, None, None, None)
    jgan.save_checkpoint(os.path.join(jax_paths.mesh_dir, log), state,
                         jst.FINAL_STEP)
    tckpt.save(tgan.checkpoint_path(os.path.join(port_paths.mesh_dir, log),
                                    jst.FINAL_STEP),
               jax_params.to_state_dict(params, stats))


def assert_png_dirs_match(jax_files, port_files, jax_root, port_root):
    rel = [os.path.relpath(p, jax_root) for p in jax_files]
    assert rel == [os.path.relpath(p, port_root) for p in port_files]
    assert rel, "no frames written"
    for r in rel:
        want = jio.read_image_u8(os.path.join(jax_root, r))
        got = tio.read_image_u8(os.path.join(port_root, r))
        assert got.shape == want.shape and got.shape[-1] == 4
        np.testing.assert_array_equal(got[..., 3], want[..., 3], err_msg=r)
        diff = np.abs(got[..., :3].astype(np.int16) - want[..., :3])
        assert diff.max() <= 1, (r, int(diff.max()))
        assert (diff > 0).mean() < 0.02, (r, float((diff > 0).mean()))


def test_slice_matches_jax(tmp_path):
    """JAX ``test_stage`` and the port's ``test_stage(device="cpu")`` from
    one converted checkpoint: stage 1 on both trees, then stage 2 with the
    JAX stage-1 frames copied into the port's tree, so each stage is held
    on identical inputs; then the GIFs."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jpaths = write_uid(jroot, "u0", 32, 2, seed=0)
    tpaths = write_uid(troot, "u0", 32, 2, seed=0)
    for stage in (1, 2):
        jcfg = jst.make_config(stage, **SMALL)
        save_both_checkpoints(jpaths, tpaths, stage, jcfg, seed=stage)
        jfiles = jst.test_stage(jroot, "u0", stage, cfg=jcfg)
        tfiles = tst.test_stage(
            troot, "u0", stage, device="cpu",
            cfg=tgan.GANConfig(**dataclasses.asdict(jcfg)))
        assert len(jfiles) == len(ACTIONS) * 2
        assert_png_dirs_match(jfiles, tfiles, jroot, troot)
        if stage == 1:
            res = jst.res_dir_name(1, True, True)
            for action in ACTIONS:
                dst = tpaths.action_dir(action) + f"/{res}"
                shutil.rmtree(dst)
                shutil.copytree(jpaths.action_dir(action) + f"/{res}", dst)
    assert j_gif_writer.main(["--uid", "u0", "--root", jroot]) == 0
    assert t_gif_writer.main(["--uid", "u0", "--root", troot]) == 0
    for action in ACTIONS:
        assert os.path.getsize(tpaths.gif(action)) > 0


def test_cli_stage1_full_width_on_cpu(tmp_path, capsys):
    """The port's CLI at the production width (7 blocks, filters
    (32, 64, 128, 128, 128, 64)) on one 32² frame."""
    root = str(tmp_path)
    paths = write_uid(root, "u1", 32, 1, seed=4)
    shutil.rmtree(paths.action_dir(ACTIONS[1]))
    model = tgan.build_generator(tst.make_config(1), "cpu",
                                 torch.Generator().manual_seed(0))
    tgan.save_checkpoint(os.path.join(paths.mesh_dir, "logs_stage1_mask_pos"),
                         model, tst.FINAL_STEP)
    assert t_cli1.main(["--uid", "u1", "--root", root,
                        "--device", "cpu"]) == 0
    assert '"written": 1' in capsys.readouterr().out
    out = tio.read_image_u8(os.path.join(paths.action_dir(ACTIONS[0]),
                                         "res_stage1_mask_pos", "0001.png"))
    assert out.shape == (32, 32, 4) and out.dtype == np.uint8


def test_gif_writer_matches_jax_bytes(tmp_path):
    for root in (tmp_path / "a", tmp_path / "b"):
        paths = write_uid(str(root), "u", 16, 3, seed=9)
        for action in ACTIONS:
            src = os.path.join(paths.action_dir(action), "color")
            shutil.copytree(src, os.path.join(paths.action_dir(action),
                                              "res_stage1_mask_pos"))
    assert j_gif_writer.main(["--uid", "u", "--root", str(tmp_path / "a")]) == 0
    assert t_gif_writer.main(["--uid", "u", "--root", str(tmp_path / "b")]) == 0
    for action in ACTIONS:
        a = tmp_path / "a" / "u" / "gif" / f"{action}.gif"
        b = tmp_path / "b" / "u" / "gif" / f"{action}.gif"
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("use_edge", [False, True])
def test_frame_loading_matches_jax(tmp_path, use_edge):
    paths = write_uid(str(tmp_path), "u", 16, 1, seed=2)
    d = paths.action_dir(ACTIONS[0])
    np.testing.assert_array_equal(
        tdata.load_full_frame_u8(d, "0001.png", use_edge),
        jdata.load_full_frame_u8(d, "0001.png", use_edge))
    rng = np.random.default_rng(1)
    rgba = rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)
    edge = (rng.uniform(0, 1, (8, 8, 3)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(tdata.overlap_edge_on_img(edge, rgba),
                                  jdata.overlap_edge_on_img(edge, rgba))
    np.testing.assert_array_equal(tdata.normalize(rgba), jdata.normalize(rgba))


def test_io_and_paths_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for k, arr in enumerate([rng.uniform(0, 1, (9, 7, 4)).astype(np.float32),
                             rng.integers(0, 256, (9, 7, 3), np.uint8),
                             rng.uniform(0, 1, (9, 7, 1))]):
        a, b = str(tmp_path / f"j{k}.png"), str(tmp_path / f"t{k}.png")
        jio.write_image(a, arr)
        tio.write_image(b, arr)
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(tio.read_image(b), jio.read_image(a))
        np.testing.assert_array_equal(tio.read_image_u8(b),
                                      jio.read_image_u8(a))
    frames = [rng.uniform(0, 1, (6, 6, 3)) for _ in range(3)]
    jio.write_gif(str(tmp_path / "j.gif"), frames)
    tio.write_gif(str(tmp_path / "t.gif"), frames)
    assert (tmp_path / "j.gif").read_bytes() == (tmp_path / "t.gif").read_bytes()

    write_uid(str(tmp_path), "u", 8, 1, seed=0)
    jp, tp = jcontract.UidPaths(str(tmp_path), "u"), \
        tcontract.UidPaths(str(tmp_path), "u")
    for name in ("mesh_dir", "render_dir", "gif_dir"):
        assert getattr(tp, name) == getattr(jp, name)
    assert tp.action_dir("walk") == jp.action_dir("walk")
    assert tp.gif("walk") == jp.gif("walk")
    assert tcontract.list_actions(tp) == jcontract.list_actions(jp)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("use_mask,use_pos", [(True, True), (False, True),
                                              (False, False)])
def test_stage_wiring_matches_jax(stage, use_mask, use_pos):
    assert tst.stage_settings(stage, use_mask, use_pos) == \
        jst.stage_settings(stage, use_mask, use_pos)
    for fn in ("log_name_for", "res_dir_name", "pre_dir_for_stage"):
        assert getattr(tst, fn)(stage, use_mask, use_pos) == \
            getattr(jst, fn)(stage, use_mask, use_pos)
    assert dataclasses.asdict(tst.make_config(stage, use_mask, use_pos)) == \
        dataclasses.asdict(jst.make_config(stage, use_mask, use_pos))


def test_checkpoint_roundtrip_and_latest(tmp_path):
    model = tgan.build_generator(tgan.GANConfig(**SMALL), "cpu",
                                 torch.Generator().manual_seed(1))
    for step in (3, 12):
        tgan.save_checkpoint(str(tmp_path), model, step)
    assert sorted(os.listdir(tmp_path)) == ["model_00003.pt", "model_00012.pt"]
    assert tckpt.latest_step(str(tmp_path), prefix="model_") == 12
    other = tgan.load_checkpoint(
        str(tmp_path), tgan.build_generator(tgan.GANConfig(**SMALL), "cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        tgan.load_checkpoint(str(tmp_path / "none"), model)


def test_device_setup_is_explicit(monkeypatch):
    assert tdevice.setup("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.setup()
    with pytest.raises(ValueError):
        tdevice.setup("meta")


def test_port_imports_no_jax():
    """Importing every module of the port (stages 1, 2a, 2b and 3) loads no
    JAX, flax, optax or orbax module and nothing of the JAX package, and
    builds neither the CUDA kernels nor the native library."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import drawingspinup_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "              'drawingspinup_tpu'))\n"
        "assert not bad, bad\n"
        "from drawingspinup_torch.kernels import _build\n"
        "assert _build._ext is None\n"
        "from drawingspinup_torch import native\n"
        "assert native._lib is None\n"
        "for m in ('cli.recon', 'models.hashgrid', 'kernels.hashgrid',\n"
        "          'models.fields', 'render.neus', 'render.hull',\n"
        "          'render.marching', 'render.mesh_post', 'train.nsr',\n"
        "          'pipelines.stage2_recon', 'pipelines.stage2_export',\n"
        "          'pipelines.stage2_data', 'core.config',\n"
        "          'utils.synthetic', 'cli.run_render', 'render.animation',\n"
        "          'render.fbx', 'ops.image', 'cli.predict',\n"
        "          'pipelines.stage1', 'models.ffc', 'ops.fourier',\n"
        "          'ops.inpaint', 'kernels.pixel_rays', 'cli.mv',\n"
        "          'pipelines.stage2_mv', 'models.unet_mv2d',\n"
        "          'models.attention_mv', 'models.vae', 'models.clip_vision',\n"
        "          'ops.diffusion', 'utils.diffusers_port'):\n"
        "    assert 'drawingspinup_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

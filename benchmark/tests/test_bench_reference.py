"""The plain reference against the port on the CPU at a small size: the RIC
tables, the keyframe pair, a served frame of each generator, and training
steps from the same weights and patches."""
import os

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import ric_tables, serve as ref_serve
from benchmark.reference import train as ref_train
from benchmark.tests.conftest import ROOT, SEED, TINY_CONFIG, TINY_MIX

CELLS = ["style1_ric.train", "style1_ric.serve", "style2_plain.serve"]


def _config(name, **extra):
    return {**harness.find(ROOT, "configs", name), **TINY_CONFIG, **extra}


@pytest.mark.parametrize("hw", [(16, 16), (24, 20)])
def test_frozen_tables_equal_the_programs(hw):
    from drawingspinup_torch.models import ric_tables as prog

    assert np.array_equal(ric_tables.ric_shifted_weights(*hw),
                          prog.ric_shifted_weights(*hw))


@pytest.mark.parametrize("name", ["style1_ric", "style2_plain"])
def test_keyframe_pair_equals_the_programs(tmp_path, name):
    """The reference's features, target, mask and midpoints from the u8
    images equal what the port loads from their PNGs."""
    from drawingspinup_torch.pipelines import stage3_data

    cfg = _config(name)
    imgs = inputs.keyframe_images(cfg["frame_size"], SEED, "cpu")
    d = tmp_path / "rest_pose"
    for kind in ("color", "pos", "edge"):
        inputs.write_png(str(d / kind / "0001.png"), imgs[kind])
    inputs.write_png(str(tmp_path / "post.png"), imgs["post"])
    pair = stage3_data.load_keyframe_pair(
        str(d), "color", str(tmp_path / "post.png"), use_mask=True,
        use_pos=True, use_edge=cfg["use_edge"])
    ref = ref_train.keyframe({k: torch.from_numpy(v)
                              for k, v in imgs.items()}, cfg)
    for key in ("pre", "post", "mask"):
        np.testing.assert_allclose(ref[key].numpy(), getattr(pair, key),
                                   rtol=0, atol=1e-6)
    assert np.array_equal(ref["valid_yx"].numpy(), pair.valid_yx)


@pytest.mark.parametrize("name", ["style1_ric", "style2_plain"])
def test_served_frame_equals_the_programs(name):
    from drawingspinup_torch.train import gan

    from benchmark.loops.train_loop import gan_config

    cfg = _config(name)
    stacks = inputs.frame_stacks(cfg["frame_size"], 2, SEED, "cpu")
    w = inputs.generator_weights(cfg, SEED, "cpu", trained=True)
    inputs.rescale_head(w, *ref_serve.pre_tanh_stats(
        w, torch.from_numpy(stacks[0]), cfg))
    model = gan.build_generator(gan_config(cfg, False), "cpu")
    model.load_state_dict(w)
    for s in stacks:
        got = gan.generate_full_rgba(model, s, True, True, cfg["use_edge"])
        ref = ref_serve.frame(w, torch.from_numpy(s), cfg).numpy()
        d = np.abs(got.astype(int) - ref.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
        # the frames are not saturated: the check sees the values
        assert 0.2 < (got[..., :3] % 255 != 0).mean()


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_its_comparison(run_tiny, cell):
    r = run_tiny(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("name", ["style1_ric", "style2_plain"])
def test_two_training_steps_from_the_same_weights(tmp_path, name):
    """Two steps of each configuration's training (config_stage2's with
    its edges and rotated copies) from the same weights and patches: the
    losses, the first gradients and the change of every leaf agree."""
    from benchmark.loops import train_loop

    cfg = _config(name)
    mix = {**harness.find(ROOT, "traffic", "train_patches"), **TINY_MIX,
           "checked_steps": 2}
    sess = train_loop.Session(cfg, mix, SEED, "cpu", str(tmp_path))
    sess.setup()
    sess.free()
    got = sess.check()
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-5 \
        and got["change_gap"] < 1e-4, got
    assert os.path.isfile(os.path.join(
        str(tmp_path), "bench", "char", "ffc_resnet_inpainted.png"))

"""The yardstick's arithmetic against counts worked out by hand."""
import json
import os
from collections import Counter

import pytest

from benchmark import work
from benchmark.tests.conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_ric_work_at_one_shape():
    # n 2, 4 × 4 pixels, C 3, O 5: 32 pixels
    assert work.ric_fwd_work(2, 4, 3, 5) == (
        4 * (32 * (3 + 5) + 9 * 3 * 5 + 81 * 16), 2 * 9 * 3 * 5 * 32)
    assert work.ric_fwd_work(2, 4, 3, 5) == (6748, 8640)
    assert work.ric_bwd_work(2, 4, 3, 5, True) == (7672, 17280)
    assert work.ric_bwd_work(2, 4, 3, 5, False) == (7288, 8640)


def test_bounds():
    assert work.bound_ms(3.35e9, 0, 1e12) == (pytest.approx(1.0), "bytes")
    assert work.bound_ms(0, 495e9, 495e12) == (pytest.approx(1.0),
                                               "operations")
    ms, by, f32_ms = work.ric_bounds(0, 165e9)
    assert ms == pytest.approx(1.0) and by == "operations"
    assert f32_ms == pytest.approx(165e9 / 67e12 * 1e3)
    assert work.F32_ACCURATE_FLOPS == pytest.approx(165e12)


def test_conv_flops():
    assert work.Conv("x", "conv", 3, 4, 8, 10).flops(2) \
        == 2 * 9 * 4 * 8 * 100 * 2


def test_ric_layers_match_the_smoke_tables():
    """The layer list of config_stage1's generator gives chip_smoke's
    launch tables (copied into work.py): 21 forward launches a 512² frame,
    22 forward and 21 backward a training step of 40 × 32² patches."""
    cfg = _config("style1_ric")
    fwd, _ = work.ric_launches(cfg, 1, 512, training=False)
    got = Counter((hw, c, o) for _, hw, c, o in fwd)
    assert got == {(hw, c, o): k for hw, c, o, k in work.RIC_SHAPES}
    fwd, bwd = work.ric_launches(cfg, 40, 32, training=True)
    assert Counter((hw, c, o) for _, hw, c, o in fwd) == Counter(
        {(hw, c, o): f for hw, c, o, f, _ in work.TRAIN_SHAPES})
    assert Counter((hw, c, o) for _, hw, c, o, _ in bwd) == Counter(
        {(hw, c, o): b for hw, c, o, _, b in work.TRAIN_SHAPES})
    assert [dx for *_, dx in bwd].count(False) == 1     # conv0
    assert len(fwd) == 22 and len(bwd) == 21
    # no RIC launch in config_stage2's generator
    assert work.ric_launches(_config("style2_plain"), 1, 512, False) \
        == ([], [])


def test_frame_flops_by_hand():
    px = 512 * 512
    plain = (2 * 49 * 6 * 32 * px               # conv0, 7×7
             + 2 * 9 * 32 * 64 * px // 4        # conv1, stride 2
             + 2 * 9 * 64 * 128 * px // 16      # conv2, stride 2
             + 14 * 2 * 9 * 128 * 128 * px // 16
             + 2 * 9 * 256 * 128 * px // 4      # upconv2
             + 2 * 9 * 192 * 128 * px           # upconv1
             + 2 * 49 * 166 * 64 * px           # conv_11, 7×7
             + 2 * 2 * 9 * 64 * 64 * px         # smooth0, smooth1
             + 2 * 64 * 3 * px)                 # head
    assert work.frame_flops(_config("style2_plain")) == plain
    ric = (2 * 9 * 6 * 32 * px + 2 * 9 * 32 * 64 * px // 4
           + 2 * 9 * 64 * 128 * px // 16
           + 14 * 2 * 9 * 128 * 128 * px // 16
           + 2 * 9 * 256 * 128 * px // 4 + 2 * 9 * 192 * 128 * px
           + 2 * 9 * 166 * 64 * px + 2 * 9 * 64 * 64 * px   # no smooth0
           + 2 * 64 * 3 * px)
    assert work.frame_flops(_config("style1_ric")) == ric


def test_discriminator_and_vgg_shapes():
    d = work.discriminator_layers(_config("style1_ric"), 32)
    assert [(l.c, l.o, l.hw) for l in d] == [(3, 12, 16), (12, 24, 8),
                                             (24, 48, 7), (48, 1, 6)]
    assert [l.dx for l in d] == [False, True, True, True]
    v = work.vgg_layers(32)
    assert [(l.c, l.o, l.hw) for l in v] == [(3, 64, 32), (64, 64, 32),
                                             (64, 128, 16)]


def test_train_step_flops_by_hand():
    cfg = _config("style1_ric")
    n = 40
    g = work.generator_layers(cfg, 32, training=True)
    g_fwd = sum(l.flops(n) for l in g)
    smooth0 = 2 * 9 * 64 * 64 * 32 * 32 * n
    conv0 = 2 * 9 * 6 * 32 * 32 * 32 * n
    g_bwd = 2 * (g_fwd - smooth0) - conv0        # no dx of conv0
    d = [2 * 16 * 3 * 12 * 256 * n, 2 * 16 * 12 * 24 * 64 * n,
         2 * 16 * 24 * 48 * 49 * n, 2 * 16 * 48 * 1 * 36 * n]
    d_step = 2 * sum(d) + 2 * (2 * sum(d) - d[0])
    v = [2 * 9 * 3 * 64 * 1024 * n, 2 * 9 * 64 * 64 * 1024 * n,
         2 * 9 * 64 * 128 * 256 * n]
    g_step = 2 * sum(v) + sum(v) + sum(d) + sum(d)
    assert work.train_step_flops(cfg) == g_fwd + g_bwd + d_step + g_step

"""PyTorch port: stage-3 training (train_stage1 → train_stage2) against the
JAX package: train-mode batch norm, the discriminator and VGG taps, the
keyframe data and patch cutting, the yaml configs, AdamW, one whole
``train_step``, and the training CLI on the CPU.

Both packages start from one set of weights: the JAX models' own init,
converted with ``utils/jax_params.py``. Random draws cannot match across
frameworks, so the port's step is fed the JAX step's own patch batch.
Tolerances are stated per test; the JAX side runs at
``default_matmul_precision("highest")``.
"""

import dataclasses
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from drawingspinup_tpu.core import weights_policy as j_weights_policy
from drawingspinup_tpu.models import generator_j as jgen
from drawingspinup_tpu.pipelines import stage3_data as jdata
from drawingspinup_tpu.pipelines import stage3_translate as jst
from drawingspinup_tpu.train import gan as jgan
from drawingspinup_torch.cli import train_stage1 as t_train1
from drawingspinup_torch.core import contract as tcontract
from drawingspinup_torch.core import io as tio
from drawingspinup_torch.core import weights_policy as t_weights_policy
from drawingspinup_torch.models import generator_j as tgen
from drawingspinup_torch.pipelines import stage3_data as tdata
from drawingspinup_torch.pipelines import stage3_translate as tst
from drawingspinup_torch.train import gan as tgan
from drawingspinup_torch.utils import jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(filters=(8, 16, 16, 16, 16, 8), resnet_blocks=2, batch_size=4,
             patch_size=16)
HIGHEST = functools.partial(jax.default_matmul_precision, "highest")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ batch norm --

@pytest.mark.parametrize("shape", [(4, 6, 5, 8), (2, 3, 3, 16)])
def test_batch_norm_train_mode_matches_flax(shape):
    """Output and the new running statistics against flax
    ``nn.BatchNorm(use_running_average=False, momentum=0.9)``, at 1e-5."""
    import flax.linen as nn

    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean0, "var": var0}},
                         jnp.asarray(x), mutable=["batch_stats"])
    port = tgen.BatchNorm(c).train()
    port.load_state_dict(jax_params.to_state_dict(
        {"scale": scale, "bias": bias}, {"mean": mean0, "var": var0}))
    got = port(torch.from_numpy(x))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), **tol)
    # the channel axis of an NCHW tensor (dim=1) gives the same numbers
    port_nchw = tgen.BatchNorm(c, dim=1).train()
    port_nchw.load_state_dict(port.state_dict())
    port_nchw.running_mean.copy_(torch.from_numpy(mean0))
    port_nchw.running_var.copy_(torch.from_numpy(var0))
    got_nchw = port_nchw(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), **tol)


def test_ric_generator_train_forward_runs_smooth_branch():
    """In training, GeneratorJ_RIC runs smooth0 → relu → smooth_bn (22 RIC
    convs) and moves smooth_bn's statistics; the output's gradient reaches
    neither module."""
    model = tgan.build_models(tgan.GANConfig(**SMALL), "cpu",
                              torch.Generator().manual_seed(0))[0]
    calls = []
    for name, mod in model.named_modules():
        if isinstance(mod, tgen.RICConv):
            mod.register_forward_hook(
                lambda m, i, o, name=name: calls.append(name))
    before = model.smooth_bn.running_mean.clone()
    model(torch.rand(2, 16, 16, 6)).sum().backward()
    # conv0-2, 2 blocks × 2, upconv2, upconv1, conv_11, smooth0, smooth1
    assert len(calls) == 12 and "smooth0" in calls
    assert not torch.equal(model.smooth_bn.running_mean, before)
    assert model.smooth0.kernel.grad is None
    assert model.smooth_bn.weight.grad is None
    assert model.smooth1.kernel.grad is not None


# ----------------------------------------------------------- D and VGG --

def test_discriminator_matches_jax():
    disc = jgen.DiscriminatorN_IN()
    x = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)
    variables = disc.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    with HIGHEST():
        want, _ = disc.apply(variables, jnp.asarray(x))
    port = tgen.DiscriminatorN_IN()
    port.load_state_dict(jax_params.to_state_dict(
        _np_tree(variables["params"])))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 6, 6, 1)
    # f32 convs and instance-norm reductions summed in another order
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_vgg_taps_match_jax():
    """Maps at feature indices (0, 3, 5) (0 and 5 before their ReLU, 3 after
    one) against the JAX module's ``as_list`` maps, within 1e-5 of the
    largest value."""
    vgg = jgen.PerceptualVGG19()
    x = np.random.default_rng(3).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    variables = vgg.init(jax.random.PRNGKey(12345), jnp.zeros((1, 16, 16, 3)))
    with HIGHEST():
        want = vgg.apply(variables, jnp.asarray(x), as_list=True)
    port = tgen.PerceptualVGG19()
    result = port.load_state_dict(jax_params.to_state_dict(
        _np_tree(variables["params"])))
    assert not result.missing_keys and not result.unexpected_keys
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 16, 16, 64), (2, 16, 16, 64), (2, 8, 8, 128)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=1e-5 * float(np.abs(w).max()))


def test_vgg_npz_overlay_matches_jax(tmp_path):
    """An npz of torch OIHW ``features.{0,2,5,7}`` weights lands on the same
    convs, bit for bit; ``features.7`` has no conv at taps (0, 3, 5)."""
    rng = np.random.default_rng(4)
    arrays = {}
    for idx, (i, o) in zip((0, 2, 5, 7), ((3, 64), (64, 64), (64, 128),
                                          (128, 128))):
        arrays[f"features.{idx}.weight"] = rng.standard_normal(
            (o, i, 3, 3)).astype(np.float32)
        arrays[f"features.{idx}.bias"] = rng.standard_normal(o).astype(
            np.float32)
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **arrays)
    vgg = jgen.PerceptualVGG19()
    variables = vgg.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    want = jax_params.to_state_dict(_np_tree(
        jgen.load_vgg_weights_npz(dict(variables), path)["params"]))
    port = tgen.load_vgg_weights_npz(tgen.PerceptualVGG19(), path)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------------ data --

def _write_pair_uid(root, size, post_size, seed, empty=False):
    """rest_pose frame 0001 (color, pos, edge) and both char drawings."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.hypot(yy - size / 2, xx - size / 3)
    mask = (r < size * 0.3) & (not empty)
    paths = tcontract.UidPaths(root, "u")
    d = paths.action_dir("rest_pose")
    color = rng.uniform(0, 1, (size, size, 4)).astype(np.float32)
    color[..., 3] = mask
    tio.write_image(os.path.join(d, "color", "0001.png"), color)
    pos = rng.uniform(0, 1, (size, size, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0, 1, (size, size)) > 0.3
    tio.write_image(os.path.join(d, "pos", "0001.png"), pos)
    tio.write_image(os.path.join(d, "edge", "0001.png"),
                    (rng.uniform(0, 1, (size, size)) > 0.2).astype(np.float32))
    for p in (paths.inpainted, paths.texture_with_bg):
        tio.write_image(p, rng.uniform(0, 1, (post_size, post_size, 4)))
    return paths


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(5)
    rgba = rng.uniform(0, 1, (12, 12, 4)).astype(np.float32)
    mask = (rng.uniform(0, 1, (12, 12)) > 0.5).astype(np.float32)
    for fn, arg in (("overlap_rotated", rgba), ("cat_with_rotated", rgba),
                    ("cat_mask_with_rotated", mask)):
        got, want = getattr(tdata, fn)(arg), getattr(jdata, fn)(arg)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn


@pytest.mark.parametrize("use_edge,use_mask,use_pos,post_size,empty", [
    (False, True, True, 24, False),
    (True, True, True, 24, False),
    (False, False, False, 36, False),    # the drawing is resized
    (True, True, False, 24, True),       # an empty mask
])
def test_load_keyframe_pair_matches_jax(tmp_path, use_edge, use_mask,
                                        use_pos, post_size, empty):
    """pre / post / mask bit-equal; the midpoints equal JAX's first
    ``n_valid`` rows (JAX pads the list to a 16384-row bucket); an empty
    mask samples (0, 0) in both."""
    paths = _write_pair_uid(str(tmp_path), 24, post_size, seed=post_size,
                            empty=empty)
    args = (paths.action_dir("rest_pose"), "color", paths.inpainted)
    kw = dict(use_mask=use_mask, use_pos=use_pos, use_edge=use_edge)
    want = jdata.load_keyframe_pair(*args, **kw)
    pair = tdata.load_keyframe_pair(*args, **kw)
    for name in ("pre", "post", "mask"):
        w = np.asarray(getattr(want, name))
        g = getattr(pair, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    n_valid = int(want.n_valid)
    data = tdata.keyframe_data(pair, "cpu")
    assert data.n_valid == n_valid
    assert len(pair.valid_yx) == (0 if empty else n_valid)
    np.testing.assert_array_equal(data.valid_yx.numpy(),
                                  np.asarray(want.valid_yx)[:n_valid])
    if empty:
        assert data.valid_yx.tolist() == [[0, 0]]


def test_cut_patches_match_jax():
    """Windows at midpoints on and near every border, zero outside, equal
    to the JAX ``_cut``; ``sample_patches`` draws only valid midpoints."""
    rng = np.random.default_rng(6)
    h, w, size = 20, 28, 16
    pair = tdata.KeyframePair(
        pre=rng.standard_normal((h, w, 6)).astype(np.float32),
        post=rng.standard_normal((h, w, 3)).astype(np.float32),
        mask=rng.uniform(0, 1, (h, w)).astype(np.float32),
        valid_yx=np.stack([rng.integers(0, h, 50), rng.integers(0, w, 50)],
                          1).astype(np.int32))
    data = tdata.keyframe_data(pair, "cpu")
    mids = np.array([[0, 0], [h - 1, w - 1], [3, 25], [10, 14], [19, 0]],
                    np.int32)
    got = tdata.cut_patches(data, torch.from_numpy(mids).long(),
                            torch.from_numpy(mids[::-1].copy()).long(), size)
    cut = jax.vmap(lambda img, yx: jdata._cut(img, yx, size), (None, 0))
    want = {"pre": cut(pair.pre, mids), "post": cut(pair.post, mids),
            "pre_mask": cut(pair.mask[..., None], mids),
            "already": cut(pair.post, mids[::-1]),
            "already_mask": cut(pair.mask[..., None], mids[::-1])}
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    batch = tdata.sample_patches(data, torch.Generator().manual_seed(0), 7,
                                 size)
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        "pre": (7, size, size, 6), "post": (7, size, size, 3),
        "pre_mask": (7, size, size, 1), "already": (7, size, size, 3),
        "already_mask": (7, size, size, 1)}
    centers = batch["pre"][:, size // 2, size // 2].numpy()
    valid = {tuple(pair.pre[y, x]) for y, x in pair.valid_yx}
    assert all(tuple(c) in valid for c in centers)


# -------------------------------------------------------- configs, paths --

@pytest.mark.parametrize("stage", [1, 2])
def test_yaml_copies_and_configs_match_jax(stage):
    assert filecmp.cmp(tst.DEFAULT_STAGE_CFGS[stage],
                       jst.DEFAULT_STAGE_CFGS[stage], shallow=False)
    for use_mask, use_pos in ((True, True), (False, True), (True, False),
                              (False, False)):
        got, got_extras = tst.gan_config_from_yaml(
            tst.DEFAULT_STAGE_CFGS[stage], use_mask, use_pos)
        want, want_extras = jst.gan_config_from_yaml(
            jst.DEFAULT_STAGE_CFGS[stage], use_mask, use_pos)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got_extras == want_extras


def test_weights_policy_copy_and_post_paths(tmp_path):
    """The policy module is a byte-equal copy; the training pair's target
    falls back to texture_with_bg as JAX's does."""
    assert filecmp.cmp(t_weights_policy.__file__, j_weights_policy.__file__,
                       shallow=False)
    from drawingspinup_tpu.core import contract as jcontract
    paths = _write_pair_uid(str(tmp_path), 8, 8, seed=0)
    jpaths = jcontract.UidPaths(str(tmp_path), "u")
    for name in ("char_dir", "texture_with_bg", "inpainted"):
        assert getattr(paths, name) == getattr(jpaths, name)
    for stage in (1, 2):
        assert tst.post_path_for_stage(paths, stage) == \
            jst.post_path_for_stage(jpaths, stage)
    os.remove(paths.inpainted)
    assert tst.post_path_for_stage(paths, 1) == paths.texture_with_bg == \
        jst.post_path_for_stage(jpaths, 1)


# --------------------------------------------------------------- AdamW ----

def test_adamw_matches_optax_over_three_steps():
    """torch AdamW as ``make_optimizers`` builds it against optax.adamw on
    the same gradients over 3 steps, at 1e-6. Leaf ``zero`` has a zero
    gradient after the first step and still moves (its first moment
    decays, not to zero); weight decay is 1e-2, so that its share shows in
    f32."""
    cfg = tgan.GANConfig(weight_decay=1e-2)
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 4), "b": (7,), "zero": (3, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (np.zeros(s) if k == "zero" and step else
                  rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for step in range(3)]
    tx = optax.adamw(cfg.lr, b1=0.9, b2=0.999, weight_decay=cfg.weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)
    mods = [torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()}), torch.nn.Linear(1, 1)]
    g_opt, _ = tgan.make_optimizers(cfg, *mods)
    after_first = None
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in mods[0].items():
            p.grad = torch.from_numpy(g[k])
        g_opt.step()
        if after_first is None:
            after_first = mods[0]["zero"].detach().numpy().copy()
    for k, p in mods[0].items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
    assert not np.array_equal(mods[0]["zero"].detach().numpy(), after_first)


# ------------------------------------------------------- one train step --

def _keyframe(seed):
    rng = np.random.default_rng(seed)
    h, w = 24, 24
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (np.hypot(yy - 12, xx - 10) < 7).astype(np.float32)
    from scipy import ndimage
    ys, xs = np.nonzero(ndimage.maximum_filter(mask, size=7) > 0)
    return jdata.KeyframeData(
        pre=jnp.asarray(rng.uniform(-1, 1, (h, w, 6)).astype(np.float32)),
        post=jnp.asarray(rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)),
        mask=jnp.asarray(mask),
        valid_yx=jnp.asarray(np.stack([ys, xs], 1).astype(np.int32)))


def _port_state(cfg, jstate):
    state = tgan.init_state(tgan.GANConfig(**dataclasses.asdict(cfg)), "cpu")
    for module, params, stats in (
            (state.gen, jstate.g_params, jstate.g_stats),
            (state.disc, jstate.d_params, None),
            (state.vgg, jstate.vgg_params, None)):
        result = module.load_state_dict(jax_params.to_state_dict(
            _np_tree(params), None if stats is None else _np_tree(stats)))
        assert not result.missing_keys and not result.unexpected_keys
    return state


def _assert_step_update(name, module, jparams, lr):
    """Adam's first step moves each element by about ±lr; where a gradient
    is near zero its sign may flip between frameworks. The discriminator's
    conv_1 and conv_2 biases feed instance norm, so their gradient is zero
    but for rounding: every one of their 72 elements may flip, which is why
    the 99 % share is taken over all elements of a model."""
    want = jax_params.to_state_dict(_np_tree(jparams))
    diffs = []
    for k, p in module.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k].numpy()).ravel()
        assert diff.max() <= 2 * lr, (name, k, float(diff.max()))
        diffs.append(diff)
    diffs = np.concatenate(diffs)
    assert (diffs <= 1e-6).mean() >= 0.99, (name, float((diffs > 1e-6).mean()))


@pytest.mark.parametrize("generator", ["GeneratorJ_RIC", "GeneratorJ"])
def test_train_step_matches_jax(generator):
    """One ``train_step_on_batch`` against ``jgan.train_step`` from the same
    weights, on the JAX step's own batch (``sample_patches`` with the
    ``k_patch`` it splits off). The JAX side runs the ``fused`` RIC
    formulation, held to the Pallas kernel by tests/test_ric_pallas.py;
    the Pallas VJP itself is held to the port in tests/test_torch_ric.py.

    Tolerances: losses rtol 1e-4; Adam's first moment (0.1 × the
    gradient) within 1e-4 of each leaf's largest value; batch statistics
    at 1e-5; new parameters within 2·lr everywhere and 1e-6 on ≥ 99 % of
    elements."""
    cfg = jgan.GANConfig(generator=generator, ric_variant="fused", **SMALL)
    jstate = jgan.init_state(cfg, jax.random.PRNGKey(3))
    state = _port_state(cfg, jstate)
    data, key = _keyframe(4), jax.random.PRNGKey(5)
    with HIGHEST():
        jnew, jlogs = jgan.train_step(cfg, jstate, data, key)
        k_patch, _ = jax.random.split(key)
        batch = jdata.sample_patches(data, k_patch, cfg.batch_size,
                                     cfg.patch_size)
    logs = tgan.train_step_on_batch(
        tgan.GANConfig(**dataclasses.asdict(cfg)), state,
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert state.step == 1
    for k in tgan.LOSS_NAMES:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-4, err_msg=k)

    mu = jax_params.to_state_dict(_np_tree(jnew.g_opt[0].mu))
    params = dict(state.gen.named_parameters())
    assert sorted(mu) == sorted(params)
    for k, p in params.items():
        want = mu[k].numpy()
        got = state.g_opt.state[p]["exp_avg"].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-12),
                                   err_msg=k)
    stats = jax_params.to_state_dict({}, _np_tree(jnew.g_stats))
    buffers = dict(state.gen.named_buffers())
    assert sorted(stats) == sorted(buffers)
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)

    _assert_step_update("G", state.gen, jnew.g_params, cfg.lr)
    _assert_step_update("D", state.disc, jnew.d_params, cfg.lr)


# ------------------------------------------------------------------- CLI --

def test_train_stage1_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """train_stage1 with a small yaml (log_interval 2, --max-batches 4):
    checkpoints at steps 2 and 4 and the final one, the periodic evals
    limited to ``eval_frame_limit`` frames per action and the final eval
    over every frame, finite per-step losses, and the strict flag reset."""
    root = str(tmp_path)
    paths = _write_pair_uid(root, 16, 16, seed=8)
    rest = paths.action_dir("rest_pose")
    walk = paths.action_dir("walk")
    for k in range(1, 4):
        for p in ("color", "pos"):
            tio.write_image(os.path.join(walk, p, f"{k:04d}.png"),
                            tio.read_image(os.path.join(rest, p, "0001.png")))
    text = open(tst.DEFAULT_STAGE_CFGS[1]).read()
    for a, b in (("filters: [32, 64, 128, 128, 128, 64]",
                  "filters: [8, 16, 16, 16, 16, 8]"),
                 ("resnet_blocks: 7", "resnet_blocks: 1"),
                 ("batch_size: 40", "batch_size: 4"),
                 ("patch_size: 32", "patch_size: 16"),
                 ("log_interval: 1000", "log_interval: 2")):
        assert a in text
        text = text.replace(a, b)
    cfg_path = tmp_path / "stage1.yaml"
    cfg_path.write_text(text)
    args = ["--uid", "u", "--root", root, "--config", str(cfg_path),
            "--device", "cpu", "--max-batches", "4"]
    monkeypatch.delenv("DSU_ALLOW_DEGRADED_WEIGHTS", raising=False)
    monkeypatch.delenv("DSU_VGG19_NPZ", raising=False)
    with pytest.raises(t_weights_policy.DegradedWeightsError):
        t_train1.main(args)
    assert not t_weights_policy.is_strict()
    evals = []
    real_eval = tst.test_on_full_images

    def counting_eval(*a, **kw):
        out = real_eval(*a, **kw)
        evals.append((kw.get("max_frames_per_action"), len(out)))
        return out

    monkeypatch.setattr(tst, "test_on_full_images", counting_eval)
    assert t_train1.main(args + ["--allow-degraded-weights"]) == 0
    assert not t_weights_policy.is_strict()
    log_dir = os.path.join(paths.mesh_dir, "logs_stage1_mask_pos")
    assert sorted(os.listdir(log_dir)) == [
        "model_00002.pt", "model_00004.pt", "model_99999.pt",
        "train_losses.json"]
    # n_valid // 4 batches per epoch, 3 epochs: well above the cap of 4
    assert evals == [(8, 4), (8, 4), (None, 4)]
    with open(os.path.join(log_dir, "train_losses.json")) as f:
        losses = json.load(f)
    assert sorted(losses) == sorted(tgan.LOSS_NAMES)
    assert all(len(v) == 4 and np.isfinite(v).all() for v in losses.values())
    out = tio.read_image_u8(os.path.join(walk, "res_stage1_mask_pos",
                                         "0003.png"))
    assert out.shape == (16, 16, 4)
    assert "4 batches in" in capsys.readouterr().out

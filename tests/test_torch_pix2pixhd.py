"""PyTorch port, the pix2pixHD zoo of stage 1 (``models/pix2pixhd.py``) and
the ``lama-regular.yaml`` path, against the JAX package on the CPU.

  * GlobalGenerator (default, depthwise and multidilated conv kinds, the
    bilinear upsampling, instance norm), MultiDilatedGlobalGenerator,
    ConfigGlobalGenerator (5×5, dilated and depthwise blocks),
    GlobalGeneratorFromSuperChannels, NLayerDiscriminator and
    MultidilatedNLayerDiscriminator at small width,
    weights from JAX's init with every bias and batch statistic redrawn
    from a seed, converted by ``utils/jax_params.py::pix2pixhd_params``:
    the output (and the discriminators' activations) within relative L2
    1e-5 of JAX's ``apply``, in eval mode and (GlobalGenerator) in train
    mode with the moved statistics;
  * ``convert_super_channels`` equal (and failing alike); ``rotate_image``
    and its angle's gradient, the learnable-rotation wrapper and a
    two-step cascade within relative L2 1e-5;
  * the port's ``state_dict`` carries upstream's names: JAX's
    ``utils/torch_port.py`` converters read it back into JAX's tree,
    leaf for leaf bit-equal, and it loads strictly into a fresh module;
  * ``configs/lama-regular.yaml`` byte-equal; ``build_generator``'s
    ``pix2pixhd_global`` dispatch; the predict CLI with that yaml (tiny
    overrides) and a reference-named checkpoint within ±1 u8 of JAX's
    ``predict_uids``.
"""

import os

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drawingspinup_tpu.core import Config as JConfig
from drawingspinup_tpu.models import pix2pixhd as jp
from drawingspinup_tpu.pipelines import stage1 as js1
from drawingspinup_tpu.utils import torch_port
from drawingspinup_torch.cli import predict
from drawingspinup_torch.core.config import load_config
from drawingspinup_torch.core.io import read_image_u8
from drawingspinup_torch.models import pix2pixhd as tp
from drawingspinup_torch.pipelines import stage1 as ts1
from drawingspinup_torch.utils.jax_params import pix2pixhd_params
from drawingspinup_torch.utils.synthetic import write_drawing_uid
from test_stage1 import make_synthetic_uid
from torch_native_guard import ensure_jax_native
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
YAML = os.path.join(REPO, "drawingspinup_torch", "configs",
                    "lama-regular.yaml")
TINY_OVERRIDES = ["generator.ngf=8", "generator.n_downsampling=2",
                  "generator.n_blocks=1"]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library (Telea), built under a lock if another
    worker's build raced this one's."""
    ensure_jax_native()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _variables(module, x, seed=0):
    """JAX's init of ``module`` with every bias, norm scale and batch
    statistic redrawn from ``seed``."""
    rng = np.random.default_rng(seed)
    v = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    flat = tu.flatten_dict(jax.tree.map(np.asarray, dict(v)))
    for k, a in flat.items():
        name = k[-1]
        if name == "scale":
            flat[k] = (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        elif name in ("mean",) or "bias" in name:
            flat[k] = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        elif name == "var":
            flat[k] = (0.5 + rng.uniform(size=a.shape)).astype(np.float32)
    return tu.unflatten_dict(flat)


GEN = dict(output_nc=1, ngf=8, n_downsampling=2, n_blocks=2)
SPEC = ({"n_blocks": 1, "resnet_block_kind": "resnetblock5x5",
         "resnet_conv_kind": "default"},
        {"n_blocks": 1, "resnet_block_kind": "resnetblockdwdil",
         "resnet_conv_kind": "default", "resnet_dilation": 2},
        {"n_blocks": 1, "resnet_block_kind": "resnetblock",
         "resnet_conv_kind": "depthwise"},
        {"n_blocks": 1, "use_default": True})
SC = (4, 4, 4, 8, 8, 8, 8, 4, 4)
CASES = {
    "global": (lambda: jp.GlobalGenerator(out_act="sigmoid", **GEN),
               lambda: tp.GlobalGenerator(out_act="sigmoid", **GEN)),
    "global_depthwise": (
        lambda: jp.GlobalGenerator(conv_kind="depthwise", **GEN),
        lambda: tp.GlobalGenerator(conv_kind="depthwise", **GEN)),
    "global_multidilated": (
        lambda: jp.GlobalGenerator(conv_kind="multidilated", **GEN),
        lambda: tp.GlobalGenerator(conv_kind="multidilated", **GEN)),
    "global_bilinear_in": (
        lambda: jp.GlobalGenerator(deconv_kind="bilinear", norm="in", **GEN),
        lambda: tp.GlobalGenerator(deconv_kind="bilinear", norm="in",
                                   **GEN)),
    "multidilated_global": (lambda: jp.MultiDilatedGlobalGenerator(**GEN),
                            lambda: tp.MultiDilatedGlobalGenerator(**GEN)),
    "config_global": (
        lambda: jp.ConfigGlobalGenerator(manual_block_spec=SPEC, **GEN),
        lambda: tp.ConfigGlobalGenerator(manual_block_spec=SPEC, **GEN)),
    "superchannels": (
        lambda: jp.GlobalGeneratorFromSuperChannels(
            output_nc=1, super_channels=SC, n_downsampling=2),
        lambda: tp.GlobalGeneratorFromSuperChannels(
            output_nc=1, super_channels=SC, n_downsampling=2)),
    "nlayer": (lambda: jp.NLayerDiscriminator(ndf=8),
               lambda: tp.NLayerDiscriminator(4, ndf=8)),
    "nlayer_multidilated": (
        lambda: jp.MultidilatedNLayerDiscriminator(ndf=8),
        lambda: tp.MultidilatedNLayerDiscriminator(4, ndf=8)),
}


def _converted(kind, seed):
    jmk, tmk = CASES[kind]
    x = np.random.default_rng(seed).uniform(size=(2, 32, 32, 4)).astype(
        np.float32)
    jm = jmk()
    v = _variables(jm, x, seed)
    tm = tmk()
    tm.load_state_dict(pix2pixhd_params(v, tm), strict=True)
    return jm, tm, v, x


@pytest.mark.parametrize("kind", sorted(CASES))
def test_modules_match_jax(kind):
    jm, tm, v, x = _converted(kind, seed=len(kind))
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    if kind.startswith("nlayer"):
        assert len(got[1]) == len(want[1]) == 4
        pairs = zip([got[0], *got[1]], [want[0], *want[1]])
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        assert g.shape == _nchw(np.asarray(w)).shape
        assert _rel(_nhwc(g), np.asarray(w)) <= TOL


def test_global_generator_train_mode_matches_jax():
    jm, tm, v, x = _converted("global", seed=3)
    want, mut = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(_nchw(x))
    assert _rel(_nhwc(got), np.asarray(want)) <= TOL
    stats = pix2pixhd_params({"batch_stats": mut["batch_stats"]}, tm)
    sd = tm.state_dict()
    assert stats
    for k, a in stats.items():
        assert _rel(sd[k].numpy(), a.numpy()) <= TOL, k


READBACK = {
    "global": lambda sd: torch_port.convert_global_generator(
        sd, n_downsampling=2, n_blocks=2),
    "multidilated_global": lambda sd:
        torch_port.convert_multidilated_global_generator(
            sd, n_downsampling=2, n_blocks=2),
    "config_global": lambda sd: torch_port.convert_config_global_generator(
        sd, n_downsampling=2, manual_block_spec=SPEC, n_blocks=2),
    "superchannels": lambda sd: torch_port.convert_superchannels_generator(
        sd, n_downsampling=2),
    "nlayer": lambda sd: torch_port.convert_nlayer_discriminator(sd),
    "nlayer_multidilated": lambda sd:
        torch_port.convert_nlayer_discriminator(
            sd, middle_kind="multidilated"),
}


@pytest.mark.parametrize("kind", sorted(READBACK))
def test_state_dict_has_upstream_names(kind):
    """JAX's reader of upstream checkpoints turns the port's state_dict
    back into JAX's tree, and the state_dict loads strictly."""
    _, tm, v, _ = _converted(kind, seed=5)
    sd = {k: t.numpy() for k, t in tm.state_dict().items()}
    back = tu.flatten_dict(READBACK[kind](sd))
    want = tu.flatten_dict(v)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))
    fresh = CASES[kind][1]()
    fresh.load_state_dict(tm.state_dict(), strict=True)


@pytest.mark.parametrize("schedule,nd", [(SC, 2), ((8, 16, 32, 64, 64, 64,
                                                     128, 64, 96), 3),
                                          ((8, 16, 32, 64, 64, 64), 3)])
def test_convert_super_channels_is_the_original(schedule, nd):
    try:
        want = jp.convert_super_channels(schedule, nd)
    except IndexError:
        with pytest.raises(IndexError):
            tp.convert_super_channels(schedule, nd)
        return
    assert tp.convert_super_channels(schedule, nd) == want


def test_rotation_and_wrappers_match_jax():
    """``rotate_image`` (values, and the gradient in the angle), the
    learnable-rotation wrapper around a GlobalGenerator and a two-step
    cascade of GlobalGenerators, within relative L2 1e-5 of JAX."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 24, 20, 3)).astype(np.float32)
    for angle in (30.0, -75.5):
        jf = lambda xx, a: (jp.rotate_image(xx, a) ** 2).sum()    # noqa
        want = jp.rotate_image(jnp.asarray(x), jnp.asarray(angle))
        dwant = jax.grad(jf, argnums=1)(jnp.asarray(x), jnp.asarray(angle))
        a = torch.tensor(angle, requires_grad=True)
        got = tp.rotate_image(_nchw(x), a)
        (got ** 2).sum().backward()
        assert _rel(_nhwc(got), np.asarray(want)) <= TOL
        np.testing.assert_allclose(float(a.grad), float(dwant), rtol=1e-4)

    x = rng.uniform(size=(2, 32, 32, 4)).astype(np.float32)
    inner = jp.GlobalGenerator(out_act="sigmoid", **GEN)
    wrap = jp.LearnableSpatialTransformWrapper(inner, angle_init=25.0)
    v = _variables(wrap, x, seed=8)
    t_inner = tp.GlobalGenerator(out_act="sigmoid", **GEN)
    t_inner.load_state_dict(pix2pixhd_params(
        {c: v[c]["inner"] for c in v}, t_inner), strict=True)
    twrap = tp.LearnableSpatialTransformWrapper(t_inner.eval(), 25.0)
    with torch.no_grad():
        twrap.angle.fill_(float(v["params"]["angle"]))
        got = twrap(_nchw(x))
    assert _rel(_nhwc(got), np.asarray(wrap.apply(v, jnp.asarray(x)))) <= TOL

    steps = (jp.GlobalGenerator(out_act="sigmoid", **GEN),
             jp.GlobalGenerator(out_act="tanh", **GEN))
    multi = jp.SimpleMultiStepGenerator(steps)
    v = _variables(multi, x, seed=9)
    tsteps = []
    for i, act in enumerate(("sigmoid", "tanh")):
        m = tp.GlobalGenerator(input_nc=4 + i, out_act=act, **GEN)
        m.load_state_dict(pix2pixhd_params(
            {c: v[c][f"steps_{i}"] for c in v}, m), strict=True)
        tsteps.append(m.eval())
    with torch.no_grad():
        got = tp.SimpleMultiStepGenerator(tsteps)(_nchw(x))
    want = np.asarray(multi.apply(v, jnp.asarray(x)))
    assert got.shape[1] == 2 and _rel(_nhwc(got), want) <= TOL


def test_lama_regular_yaml_and_dispatch():
    assert open(YAML, "rb").read() == open(os.path.join(
        REPO, "drawingspinup_tpu", "configs", "lama-regular.yaml"),
        "rb").read()
    model = ts1.build_generator(load_config(YAML))
    assert isinstance(model, tp.GlobalGenerator) and not model.training
    assert isinstance(model.out_act, torch.nn.Sigmoid)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(jax.eval_shape(
            js1.build_generator(JConfig({"generator": dict(
                load_config(YAML)["generator"])})).init,
            jax.random.PRNGKey(0),
            jnp.zeros((1, 64, 64, 4)))["params"]))


def test_lama_regular_predict_cli_matches_jax(tmp_path):
    """The predict CLI with lama-regular.yaml (tiny) and a reference-named
    checkpoint written from JAX's variables: the PNG within ±1 u8 of
    JAX's ``predict_uids``, on < 1 % of values."""
    cfg = JConfig({"generator": {"kind": "pix2pixhd_global", "ngf": 8,
                                 "n_downsampling": 2, "n_blocks": 1,
                                 "add_out_act": "sigmoid"}})
    jm = js1.build_generator(cfg)
    v = _variables(jm, np.zeros((1, 64, 64, 4), np.float32), seed=7)
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    make_synthetic_uid(jroot)
    write_drawing_uid(troot, "toy")
    want = js1.predict_uids(jroot, ["toy"], v, cfg, batch_size=1, size=64)
    tm = ts1.build_generator(load_config(YAML, TINY_OVERRIDES))
    sd = pix2pixhd_params(v, tm)
    sd.update({k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(3)
               for k in list(sd) if k.endswith("running_mean")})
    ckpt = str(tmp_path / "regular.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    assert predict.main([YAML, *TINY_OVERRIDES, f"pretrained.path={ckpt}",
                         "--uid", "toy", "--root", troot, "--size", "64",
                         "--device", "cpu"]) == 0
    got = read_image_u8(os.path.join(troot, "toy", "char",
                                     "ffc_resnet_inpainted.png")).astype(int)
    ref = read_image_u8(want[0]).astype(int)
    assert got.shape == ref.shape == (64, 64, 4)
    diff = np.abs(got - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01

"""PyTorch port, stage 1 (contour removal): the FFTs, the FFC modules, the
checkpoint paths, Telea inpainting and the ``predict`` CLI, against the
JAX package on the CPU.

  * ``rfft2_ortho`` / ``irfft2_ortho`` against JAX's DFT matmuls at 64×64,
    63×65 and 32×48 (a spectrum that is not Hermitian too): within 1e-5
    of the largest value;
  * FourierUnit, SpectralTransform with and without the local Fourier
    unit, FFCResnetBlock and the whole generator (ngf 8, 2 downsamplings,
    1-2 blocks, 64²), weights from JAX's init with batch statistics drawn
    from a seed, converted by ``utils/jax_params.py::ffc_params``: relative
    L2 ≤ 1e-5 to JAX's ``apply`` (the generator's logits and output);
  * ``ffc_params`` gives upstream LaMa's names: the keys and arrays of
    JAX's ``invert_to_torch_names``;
  * a LaMa-named ``state_dict`` from ``invert_to_torch_names``, written
    with ``torch.save``, loads strictly through ``cli/predict.py``, whose
    PNG is JAX's ``predict_uids`` output within ±1 on < 1 % of the u8
    values;
  * Telea inpainting equal to JAX's native one; the yaml byte-equal; the
    stage-1 paths and the drawing fixture equal to the originals.
"""

import os

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drawingspinup_tpu import native as jnative
from drawingspinup_tpu.core import Config as JConfig
from drawingspinup_tpu.core import UidPaths as JPaths
from drawingspinup_tpu.models import ffc as jffc
from drawingspinup_tpu.ops import fourier as jfourier
from drawingspinup_tpu.pipelines import stage1 as js1
from drawingspinup_tpu.utils.torch_port import invert_to_torch_names
from drawingspinup_torch.cli import predict
from drawingspinup_torch.core import contract as tcontract
from drawingspinup_torch.core import profiling
from drawingspinup_torch.core.io import read_image_u8
from drawingspinup_torch.models import ffc as tffc
from drawingspinup_torch.ops import fourier as tfourier
from drawingspinup_torch.ops.inpaint import telea_inpaint
from drawingspinup_torch.pipelines import stage1 as ts1
from drawingspinup_torch.utils.jax_params import ffc_params
from drawingspinup_torch.utils.synthetic import write_drawing_uid
from test_stage1 import make_synthetic_uid
from torch_native_guard import ensure_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
TINY = {"ngf": 8, "n_downsampling": 2, "n_blocks": 1,
        "resnet_conv_kwargs": {"ratio_gin": 0.75}}
TINY_OVERRIDES = ["generator.ngf=8", "generator.n_downsampling=2",
                  "generator.n_blocks=1"]
YAML = os.path.join(REPO, "drawingspinup_torch", "configs",
                    "lama-fourier.yaml")


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """JAX's native library, built under a lock if another worker's
    build raced this one's."""
    ensure_jax_native()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _variables(module, x, seed=0):
    """JAX init of ``module`` on ``x`` with batch statistics and BN affine
    parameters drawn from ``seed`` (so batch norm is not the identity)."""
    rng = np.random.default_rng(seed)
    v = jax.jit(module.init)(jax.random.PRNGKey(seed), x)
    flat = tu.flatten_dict(jax.tree.map(np.asarray, dict(v)))
    for k, a in flat.items():
        if "BatchNorm_0" not in k:
            continue
        if k[-1] == "scale":
            flat[k] = (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        elif k[-1] in ("bias", "mean"):
            flat[k] = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        elif k[-1] == "var":
            flat[k] = (0.5 + rng.uniform(size=a.shape)).astype(np.float32)
    return tu.unflatten_dict(flat)


def _load(module, variables):
    module.load_state_dict(ffc_params(variables["params"],
                                      variables.get("batch_stats")),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("h,w", [(64, 64), (63, 65), (32, 48)])
def test_ffts_match_jax_dft_matmuls(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    j_re, j_im = (np.asarray(a) for a in jfourier.rfft2_ortho(jnp.asarray(x)))
    t_re, t_im = tfourier.rfft2_ortho(_nchw(x))
    scale = max(np.abs(j_re).max(), np.abs(j_im).max())
    assert np.abs(_nhwc(t_re) - j_re).max() <= TOL * scale
    assert np.abs(_nhwc(t_im) - j_im).max() <= TOL * scale
    # a spectrum that is not Hermitian: the imaginary parts of the DC and
    # (even w) Nyquist columns must be ignored as JAX's synthesis does
    re = rng.normal(size=(2, h, w // 2 + 1, 3)).astype(np.float32)
    im = rng.normal(size=(2, h, w // 2 + 1, 3)).astype(np.float32)
    want = np.asarray(jfourier.irfft2_ortho(jnp.asarray(re), jnp.asarray(im),
                                            (h, w)))
    got = _nhwc(tfourier.irfft2_ortho(_nchw(re), _nchw(im), (h, w)))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    # the round trip, in float64 as well
    back = tfourier.irfft2_ortho(*tfourier.rfft2_ortho(_nchw(x).double()),
                                 (h, w))
    assert back.dtype == torch.float64
    np.testing.assert_allclose(_nhwc(back), x, atol=1e-12)


@pytest.mark.parametrize("kind", ["fourier_unit", "spectral", "spectral_lfu",
                                  "spectral_lfu_stride2"])
def test_spectral_modules_match_jax(kind):
    x = np.random.default_rng(7).normal(size=(2, 16, 16, 8)).astype(
        np.float32)
    jm, tm = {
        "fourier_unit": (jffc.FourierUnit(6), tffc.FourierUnit(8, 6)),
        "spectral": (jffc.SpectralTransform(8, enable_lfu=False),
                     tffc.SpectralTransform(8, 8, enable_lfu=False)),
        "spectral_lfu": (jffc.SpectralTransform(8, enable_lfu=True),
                         tffc.SpectralTransform(8, 8, enable_lfu=True)),
        "spectral_lfu_stride2": (
            jffc.SpectralTransform(16, stride=2, enable_lfu=True),
            tffc.SpectralTransform(8, 16, stride=2, enable_lfu=True)),
    }[kind]
    v = _variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(_load(tm, v)(_nchw(x)))
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


def test_ffc_resnet_block_matches_jax():
    rng = np.random.default_rng(8)
    x_l = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    x_g = rng.normal(size=(2, 16, 16, 24)).astype(np.float32)
    jm = jffc.FFCResnetBlock(32, ratio_gin=0.75, ratio_gout=0.75,
                             enable_lfu=False)
    v = _variables(jm, (jnp.asarray(x_l), jnp.asarray(x_g)))
    want = jm.apply(v, (jnp.asarray(x_l), jnp.asarray(x_g)))
    tm = _load(tffc.FFCResnetBlock(32, 0.75, 0.75, enable_lfu=False), v)
    with torch.no_grad():
        got = tm((_nchw(x_l), _nchw(x_g)))
    for g, w in zip(got, want):
        assert _rel(_nhwc(g), np.asarray(w)) <= TOL


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_generator_matches_jax(n_blocks):
    x = np.random.default_rng(9).uniform(size=(2, 64, 64, 4)).astype(
        np.float32)
    jm = jffc.FFCResNetGenerator(ngf=8, n_downsampling=2, n_blocks=n_blocks)
    v = _variables(jm, jnp.asarray(x), seed=n_blocks)
    no_act = jffc.FFCResNetGenerator(ngf=8, n_downsampling=2,
                                     n_blocks=n_blocks, add_out_act="none")
    want_logits = np.asarray(no_act.apply(v, jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = _load(tffc.FFCResNetGenerator(ngf=8, n_downsampling=2,
                                       n_blocks=n_blocks), v)
    with torch.no_grad():
        logits, out = tm.logits(_nchw(x)), tm(_nchw(x))
    assert _rel(_nhwc(logits), want_logits) <= TOL
    assert _rel(_nhwc(out), want) <= TOL
    sd = ffc_params(v["params"], v["batch_stats"])
    names = invert_to_torch_names(v, n_downsampling=2, n_blocks=n_blocks)
    assert sd.keys() == names.keys()
    for k, a in names.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


def _jax_tiny_variables():
    cfg = JConfig({"generator": TINY})
    model = js1.build_generator(cfg)
    v = _variables(model, jnp.zeros((1, 64, 64, 4), jnp.float32), seed=3)
    return cfg, v


def test_lama_state_dict_loads_strictly_through_the_cli(tmp_path):
    """JAX's predict_uids and the port's CLI on one uid with one generator:
    the port reads it as a LaMa checkpoint (upstream names, BN counters,
    nested under ``state_dict``)."""
    cfg, v = _jax_tiny_variables()
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    make_synthetic_uid(jroot)
    write_drawing_uid(troot, "toy")
    want = js1.predict_uids(jroot, ["toy"], v, cfg, batch_size=1, size=64)
    sd = {k: torch.from_numpy(np.array(a))
          for k, a in invert_to_torch_names(v, n_downsampling=2,
                                            n_blocks=1).items()}
    sd.update({k.rsplit(".", 1)[0] + ".num_batches_tracked":
               torch.tensor(7) for k in sd if k.endswith("running_mean")})
    ckpt = str(tmp_path / "lama.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    rc = predict.main([YAML, *TINY_OVERRIDES, f"pretrained.path={ckpt}",
                       "--uid", "toy", "--root", troot, "--size", "64",
                       "--device", "cpu"])
    assert rc == 0
    got = read_image_u8(os.path.join(troot, "toy", "char",
                                     "ffc_resnet_inpainted.png")).astype(int)
    ref = read_image_u8(want[0]).astype(int)
    assert got.shape == ref.shape == (64, 64, 4)
    diff = np.abs(got - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    # strict: a missing key raises
    sd.pop("model.1.ffc.convl2l.weight")
    torch.save(sd, ckpt)
    with pytest.raises(RuntimeError, match="Missing key"):
        predict.main([YAML, *TINY_OVERRIDES, f"pretrained.path={ckpt}",
                      "--uid", "toy", "--root", troot, "--size", "64",
                      "--device", "cpu"])


def test_predict_cli_seeded_weights_and_device(tmp_path, monkeypatch):
    root = str(tmp_path)
    for uid in ("a", "b", "c"):
        write_drawing_uid(root, uid, size=48)
    argv = [YAML, *TINY_OVERRIDES, "--root", root, "--size", "64",
            "--device", "cpu", "--seed", "5"]
    outs = []
    for uids, batch in ((["a", "b", "c"], 2), (["a"], 8)):
        lst = tmp_path / "uids.json"
        lst.write_text(str(uids).replace("'", '"'))
        assert predict.main(argv[:1] + [f"uid_json={lst}"] + argv[1:]
                            + ["--batch-size", str(batch)]) == 0
        outs.append(read_image_u8(os.path.join(
            root, "a", "char", "ffc_resnet_inpainted.png")))
    # the same seeded weights whatever the batching; alpha is the input's,
    # resized to 64² as JAX resizes it
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (64, 64, 4)
    rgb, alpha = js1.load_input(JPaths(root, "a"), size=64)
    t_rgb, t_alpha = ts1.load_input(tcontract.UidPaths(root, "a"), size=64)
    assert np.abs(t_rgb - rgb).max() <= 1e-5
    assert np.abs(t_alpha - alpha).max() <= 1e-5
    assert np.abs(outs[0][..., 3].astype(int)
                  - np.round(np.clip(alpha[..., 0], 0, 1) * 255)).max() <= 1
    orbax = tmp_path / "orbax_dir"
    orbax.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        predict.main([YAML, *TINY_OVERRIDES, f"pretrained.path={orbax}",
                      "--uid", "a", "--root", root, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        predict.main([YAML, "--uid", "a", "--root", root])


def test_telea_inpaint_equals_jax_native():
    rng = np.random.default_rng(11)
    img = rng.uniform(size=(40, 44, 3)).astype(np.float32)
    mask = np.zeros((40, 44), np.uint8)
    mask[10:18, 5:30] = 1
    mask[25:35, 20:24] = 1
    img[mask != 0] = 0
    assert jnative.available()
    np.testing.assert_array_equal(telea_inpaint(img, mask),
                                  jnative.telea_inpaint(img, mask))


def test_copies_are_the_originals(tmp_path):
    assert open(YAML, "rb").read() == open(os.path.join(
        REPO, "drawingspinup_tpu", "configs", "lama-fourier.yaml"),
        "rb").read()
    t, j = tcontract.UidPaths("/r", "u"), JPaths("/r", "u")
    assert (t.texture, t.mask, t.inpainted, t.fbx_dir) == \
        (j.texture, j.mask, j.inpainted, j.fbx_dir)
    make_synthetic_uid(tmp_path / "j")
    write_drawing_uid(str(tmp_path / "t"), "toy")
    assert (tmp_path / "j" / "toy" / "char" / "texture.png").read_bytes() \
        == (tmp_path / "t" / "toy" / "char" / "texture.png").read_bytes()
    assert ts1.CONTOUR_THRESHOLD == js1.CONTOUR_THRESHOLD
    assert ts1.INPAINT_RADIUS == js1.INPAINT_RADIUS


# ---------------------------------------------------------------------------
# the FFTs' gradients, the FFC options, train mode and the discriminator
# ---------------------------------------------------------------------------

def _vjp_rel(jfn, tfn, args, cot):
    """Relative L2 of the port's VJP of ``tfn`` to JAX's of ``jfn`` on the
    same NHWC ``args`` and output cotangents ``cot``, per argument."""
    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = vjp(tuple(jnp.asarray(c) for c in cot) if len(cot) > 1
               else jnp.asarray(cot[0]))
    targs = [_nchw(a).requires_grad_(True) for a in args]
    outs = tfn(*targs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [_nchw(c) for c in cot])
    return [_rel(_nhwc(t.grad), np.asarray(w)) for t, w in zip(targs, want)]


@pytest.mark.parametrize("h,w", [(16, 16), (15, 17), (16, 12), (9, 9)])
def test_fft_vjps_match_jax(h, w):
    """The VJPs of both transforms against JAX's DFT matmuls' (odd and even
    W): the in-place zeroing of the DC and Nyquist imaginary parts is legal
    under autograd and gives JAX's zero gradient there."""
    rng = np.random.default_rng(h * 100 + w)
    wf = w // 2 + 1
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    cot = [rng.normal(size=(2, h, wf, 3)).astype(np.float32)
           for _ in range(2)]
    rels = _vjp_rel(jfourier.rfft2_ortho, tfourier.rfft2_ortho, [x], cot)
    re, im = (rng.normal(size=(2, h, wf, 3)).astype(np.float32)
              for _ in range(2))
    g = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    rels += _vjp_rel(lambda a, b: jfourier.irfft2_ortho(a, b, (h, w)),
                     lambda a, b: tfourier.irfft2_ortho(a, b, (h, w)),
                     [re, im], [g])
    assert max(rels) <= TOL, rels


def _bias_noise(v, seed):
    """``v`` with every non-BN bias redrawn (so that the biases' names are
    checked too)."""
    rng = np.random.default_rng(seed)
    flat = tu.flatten_dict(v)
    for k, a in flat.items():
        if k[0] == "params" and k[-1] == "bias" and "BatchNorm_0" not in k:
            flat[k] = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return tu.unflatten_dict(flat)


POS_SE = {"spectral_pos_encoding": True, "use_se": True}
OPTIONS = {
    "se": (lambda: jffc.SELayer(), lambda: tffc.SELayer(32), 32),
    "fourier_pos_se": (lambda: jffc.FourierUnit(8, **POS_SE),
                       lambda: tffc.FourierUnit(8, 8, **POS_SE), 8),
    "spectral_pos_se": (
        lambda: jffc.SpectralTransform(16, enable_lfu=True, fu_kwargs=POS_SE),
        lambda: tffc.SpectralTransform(8, 16, enable_lfu=True, **POS_SE), 8),
    "gated_ffc": (
        lambda: jffc.FFC(16, 3, 0.5, 0.5, padding=1, gated=True),
        lambda: tffc.FFC(16, 16, 3, 0.5, 0.5, padding=1, gated=True), 16),
}


@pytest.mark.parametrize("kind", sorted(OPTIONS))
def test_ffc_options_match_jax(kind):
    """The options that lama-fourier.yaml leaves off, forward and VJP
    (input and every parameter) within relative L2 1e-5 of JAX."""
    jmk, tmk, c = OPTIONS[kind]
    rng = np.random.default_rng(len(kind))
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    jm = jmk()
    if kind == "gated_ffc":
        xin = (jnp.asarray(x[..., :8]), jnp.asarray(x[..., 8:]))
        fwd = lambda p, x_l, x_g: jm.apply({**v, "params": p},    # noqa
                                           (x_l, x_g))
    else:
        xin = (jnp.asarray(x),)
        fwd = lambda p, xx: jm.apply({**v, "params": p}, xx)      # noqa
    v = _bias_noise(_variables(jm, xin if len(xin) > 1 else xin[0]), 1)
    want, vjp = jax.vjp(fwd, v["params"], *xin)
    want = want if isinstance(want, tuple) else (want,)
    cot = [rng.normal(size=w.shape).astype(np.float32) for w in want]
    jgrads = vjp(tuple(jnp.asarray(ct) for ct in cot) if len(cot) > 1
                 else jnp.asarray(cot[0]))
    tm = _load(tmk(), v)
    tin = [_nchw(np.asarray(a)).requires_grad_(True) for a in xin]
    got = tm(tuple(tin)) if len(tin) > 1 else tm(tin[0])
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert _rel(_nhwc(g.detach()), np.asarray(w)) <= TOL
    torch.autograd.backward(got, [_nchw(ct) for ct in cot])
    for t, w in zip(tin, jgrads[1:]):
        assert _rel(_nhwc(t.grad), np.asarray(w)) <= TOL
    want_p = ffc_params(jax.tree.map(np.asarray, jgrads[0]))
    named = dict(tm.named_parameters())
    assert named.keys() == want_p.keys()
    for k, p in named.items():
        g, w = p.grad.numpy(), want_p[k].numpy()
        # (a ReLU unit of the excitation that is off for every sample
        # gives both packages zero gradients)
        assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), k


def test_out_ffc_generator_matches_jax():
    x = np.random.default_rng(12).uniform(size=(2, 32, 32, 4)).astype(
        np.float32)
    kw = dict(ngf=8, n_downsampling=2, n_blocks=1, out_ffc=True)
    jm = jffc.FFCResNetGenerator(**kw)
    v = _variables(jm, jnp.asarray(x), seed=4)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = _load(tffc.FFCResNetGenerator(**kw), v)
    assert isinstance(tm.model[-3], tffc.FFCResnetBlock)
    with torch.no_grad():
        assert _rel(_nhwc(tm(_nchw(x))), want) <= TOL


def _stats_rel(tm, new_stats):
    """Largest relative L2 of the port's running statistics to JAX's."""
    want = ffc_params({}, jax.tree.map(np.asarray, new_stats))
    sd = tm.state_dict()
    assert want.keys() <= sd.keys() and want
    return max(_rel(sd[k].numpy(), a.numpy()) for k, a in want.items())


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_train_mode_matches_jax(net):
    """Batch statistics in train mode: the output (the discriminator's
    score and its 4 feature maps) and the moved running statistics within
    relative L2 1e-5 of flax's ``apply(train=True, mutable=...)``; eval
    mode uses JAX's own batch_stats."""
    rng = np.random.default_rng(13)
    if net == "generator":
        x = rng.uniform(size=(2, 32, 32, 4)).astype(np.float32)
        jm = jffc.FFCResNetGenerator(ngf=8, n_downsampling=2, n_blocks=1)
        tm_fn = lambda: tffc.FFCResNetGenerator(ngf=8, n_downsampling=2,  # noqa
                                                n_blocks=1)
    else:
        x = rng.normal(size=(2, 64, 64, 1)).astype(np.float32)
        jm = jffc.FFCNLayerDiscriminator(ndf=8, n_layers=3)
        tm_fn = lambda: tffc.FFCNLayerDiscriminator(1, ndf=8, n_layers=3)  # noqa
    v = _variables(jm, jnp.asarray(x), seed=5)
    for train in (False, True):
        if train:
            want, mut = jm.apply(v, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        else:
            want = jm.apply(v, jnp.asarray(x))
        tm = _load(tm_fn(), v).train(train)
        with torch.no_grad():
            got = tm(_nchw(x))
        if net == "generator":
            assert _rel(_nhwc(got), np.asarray(want)) <= TOL
        else:
            assert len(got[1]) == len(want[1]) == 4
            for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
                assert _rel(_nhwc(g), np.asarray(w)) <= TOL
        if train:
            assert _stats_rel(tm, mut["batch_stats"]) <= TOL


# seeds 0-19, and the draws on which the earlier pad's gradient (the
# autograd of its flips and concatenations, a reordered sum) was more than
# 1e-15 from F.pad's: 43 ... 290 at (3, 3), 263 and 267 at (1, 2)
PAD_SEEDS = (*range(20), 43, 61, 117, 205, 215, 225, 290, 263, 267)


@pytest.mark.parametrize("ph,pw", [(3, 3), (1, 2), (0, 1)])
def test_reflect_pad_equals_torch(ph, pw):
    """The pad equals ``F.pad(mode="reflect")`` on the CPU, values and
    gradient, bit for bit, on seeded draws in float64 and f32."""
    for seed in PAD_SEEDS:
        gen = torch.Generator().manual_seed(seed)
        for dtype in (torch.float64, torch.float32):
            x = torch.randn(2, 3, 9, 11, dtype=dtype, generator=gen,
                            requires_grad=True)
            g = torch.randn(2, 3, 9 + 2 * ph, 11 + 2 * pw, dtype=dtype,
                            generator=gen)
            want = torch.nn.functional.pad(x, (pw, pw, ph, ph),
                                           mode="reflect")
            (gw,) = torch.autograd.grad(want, x, g)
            got = tffc.reflect_pad2d(x, ph, pw)
            (gg,) = torch.autograd.grad(got, x, g)
            assert torch.equal(got, want), (seed, dtype)
            assert torch.equal(gg, gw), (seed, dtype)


OVERLAP_SIZES = (40, 48, 56, 64, 72)    # five drawings, one a size


def _lama_ckpt(tmp_path):
    """JAX's tiny generator as a LaMa checkpoint; (cfg, variables, path)."""
    cfg, v = _jax_tiny_variables()
    sd = {k: torch.from_numpy(np.array(a))
          for k, a in invert_to_torch_names(v, n_downsampling=2,
                                            n_blocks=1).items()}
    ckpt = str(tmp_path / "lama.pth")
    torch.save({"state_dict": sd}, ckpt)
    return cfg, v, ckpt


def test_overlapped_predict_tracks_jax(tmp_path):
    """Five drawings at batch 2 (the last batch partial) through the CLI:
    one PNG counted a drawing, and each is JAX's ``predict_uids`` output on
    the same drawings within ±1 on < 1 % of the u8 values."""
    cfg, v, ckpt = _lama_ckpt(tmp_path)
    uids = [f"d{s}" for s in OVERLAP_SIZES]
    roots = {k: str(tmp_path / k) for k in ("overlap", "jax")}
    for root in roots.values():
        for uid, s in zip(uids, OVERLAP_SIZES):
            write_drawing_uid(root, uid, size=s)
    lst = tmp_path / "uids.json"
    lst.write_text(str(uids).replace("'", '"'))
    before = profiling.counters()["stage1.drawing"]
    rc = predict.main([YAML, *TINY_OVERRIDES, f"pretrained.path={ckpt}",
                       f"uid_json={lst}", "--root", roots["overlap"],
                       "--size", "64", "--batch-size", "2",
                       "--device", "cpu"])
    assert rc == 0
    assert profiling.counters()["stage1.drawing"] - before == len(uids)
    want = js1.predict_uids(roots["jax"], uids, v, cfg, batch_size=2,
                            size=64)
    for uid, ref in zip(uids, want):
        got = read_image_u8(os.path.join(roots["overlap"], uid, "char",
                                         "ffc_resnet_inpainted.png"))
        got, ref = got.astype(int), read_image_u8(ref).astype(int)
        assert got.shape == ref.shape == (64, 64, 4)
        diff = np.abs(got - ref)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, uid


class _Recording(torch.nn.Module):
    """A stand-in generator that logs each forward's batch size."""

    def __init__(self, log):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.log = log

    def forward(self, x):
        self.log.append(("forward", x.shape[0]))
        return torch.sigmoid(self.w * (x[:, :1] - 0.5))


def test_next_batch_dispatched_before_post_processing(tmp_path, monkeypatch):
    """Batch k+1's forward is enqueued before batch k is post-processed
    (five drawings at batch 2)."""
    root = str(tmp_path)
    uids = [f"d{s}" for s in OVERLAP_SIZES]
    for uid, s in zip(uids, OVERLAP_SIZES):
        write_drawing_uid(root, uid, size=s)
    log = []
    post = ts1.postprocess_one

    def recorded(rgb, alpha, prob):
        log.append(("post", 1))
        return post(rgb, alpha, prob)

    monkeypatch.setattr(ts1, "postprocess_one", recorded)
    written = ts1.predict_uids(root, uids, _Recording(log), batch_size=2,
                               size=32)
    assert len(written) == 5 and all(os.path.exists(p) for p in written)
    f, p = ("forward", 2), ("post", 1)
    assert log == [f, f, p, p, ("forward", 1), p, p, p]

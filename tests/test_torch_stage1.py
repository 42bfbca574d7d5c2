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

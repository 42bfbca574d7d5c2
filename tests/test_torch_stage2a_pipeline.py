"""PyTorch port, stage 2a: the whole tiny pipeline and the ``mv`` CLI
against the JAX package on the CPU.

  * The tiny pipeline of ``tests/test_stage2a.py::test_mv_tiny_output_stability``
    (UNet 32/64/64/64, the full SD VAE, 64² input, 3 steps, f32) with
    JAX's init params (PRNGKey(5), converted by
    ``utils/jax_params.py::mv_params``) and JAX's draws injected: within
    atol 2e-3 of ``tests/data/mv_tiny_expected.npz`` (the JAX test's
    bound) and within 1e-4 of JAX's own output; the same with guidance 3.0
    (the doubled [uncond | cond] batch) against JAX's output.
  * bf16 compute: the port's bf16 run no farther (relative L2) from its
    f32 run than 1.25 × JAX's bf16 run from JAX's f32 run.
  * ``python -m drawingspinup_torch.cli.mv --tiny --device cpu`` on a
    ``utils/synthetic.py::write_drawing_uid`` uid writes the 18 PNGs; run
    in-process on the JAX pipeline's weights with JAX's draws, in f32, its
    PNGs are within ±1 u8 of JAX's ``generate_uid`` and its masks equal.

The JAX side is built and compiled once for the module (the init's compile
takes most of the file's time).
"""

import copy
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drawingspinup_tpu.models.unet_mv2d import UNetMV2D, UNetMVConfig
from drawingspinup_tpu.models.vae import AutoencoderKL
from drawingspinup_tpu.pipelines import stage2_mv as jmv
from drawingspinup_torch.cli import mv as cli_mv
from drawingspinup_torch.core.io import read_image_u8
from drawingspinup_torch.models import unet_mv2d as tunet
from drawingspinup_torch.pipelines import stage2_mv as tmv
from drawingspinup_torch.utils.jax_params import mv_params
from drawingspinup_torch.utils.synthetic import write_drawing_uid
from mv_parity import jax_noises, nchw, nhwc, rel_l2, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_UNET = dict(block_out_channels=(32, 64, 64, 64), attention_heads=4,
                 cross_attention_dim=32)
STEPS = 3
OUT_SIZE = 96


def jax_init(cfg, key):
    """The params of ``MVPipeline.init_random(cfg, key)``: the same
    splits, shapes and init functions, compiled without XLA's optimisation
    passes (the initialisers' compile dominates this file's time; fully
    optimised, as ``init_random`` compiles it, the values differ from these
    in the last bits). ``mv_tiny_expected.npz``, which ``init_random``'s
    params produced, holds the two together."""
    k1, k2, k3 = jax.random.split(key, 3)
    nv2 = cfg.num_views * 2
    lat = cfg.image_size // 8
    u, c = cfg.unet, cfg.clip_config()
    unet, vae = UNetMV2D(u), AutoencoderKL(cfg.vae_config())
    clip = jmv.CLIPVisionModelWithProjection(c)
    s = min(cfg.image_size, 64)
    fns = {
        "unet": (lambda k: unet.init(
            k, jnp.zeros((nv2, lat, lat, u.in_channels)),
            jnp.zeros((nv2,), jnp.int32),
            jnp.zeros((nv2, 1, u.cross_attention_dim)),
            jnp.zeros((nv2, u.projection_class_embeddings_input_dim))), k1),
        "vae": (lambda k: vae.init(k, jnp.zeros((1, s, s, 3))), k2),
        "clip": (lambda k: clip.init(k, jnp.zeros(
            (1, c.image_size, c.image_size, 3))), k3)}
    opts = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
    return {name: to_numpy(jax.jit(fn).lower(k).compile(
        compiler_options=opts)(k)["params"])
        for name, (fn, k) in fns.items()}


def torch_pipeline(tcfg, params) -> tmv.MVPipeline:
    pipe = tmv.MVPipeline.init_random(tcfg, seed=0, device="cpu")
    sds = mv_params(params)
    for part, mod in (("unet", pipe.unet), ("vae", pipe.vae),
                      ("clip", pipe.clip)):
        mod.load_state_dict(sds[part], strict=True)
    return pipe


def torch_config(**kw):
    """The port's config of the JAX test's."""
    return tmv.MVPipelineConfig(
        unet=tunet.UNetMVConfig(**TINY_UNET), num_inference_steps=STEPS,
        image_size=64, out_size=64, **kw)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX's tiny pipeline with its init params, the input image, the
    port's pipeline on the same weights, JAX's draws, both pipelines' f32
    outputs (guidance 1), and the root of a uid that JAX's ``generate_uid``
    wrote with these weights while its f32 loop was compiled."""
    jcfg = jmv.MVPipelineConfig(unet=UNetMVConfig(**TINY_UNET),
                                num_inference_steps=STEPS, image_size=64,
                                out_size=OUT_SIZE, compute_dtype="float32")
    params = jax_init(jcfg, jax.random.PRNGKey(5))
    jpipe = jmv.MVPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                        params))
    img = np.random.default_rng(6).random((64, 64, 3)).astype(np.float32)
    tpipe = torch_pipeline(torch_config(compute_dtype="float32"), params)
    noises = jax_noises(0, (12, 8, 8, 4), STEPS)
    outs = (jpipe(img, seed=0), tpipe(img, noises=noises))
    jroot = str(tmp_path_factory.mktemp("jax_uid"))
    write_drawing_uid(jroot, "toy", size=64)
    jmv.generate_uid(jroot, "toy", jpipe, seed=0)
    return jcfg, jpipe, tpipe, img, noises, jroot, outs


def run_jax(jpipe, jcfg, img, **kw):
    jpipe.cfg = dataclasses.replace(jcfg, **kw)
    try:
        return jpipe(img, seed=0)
    finally:
        jpipe.cfg = jcfg


def run_torch(tpipe, img, noises, **kw):
    cfg = tpipe.cfg
    tpipe.cfg = dataclasses.replace(cfg, **kw)
    try:
        return tpipe(img, noises=noises)
    finally:
        tpipe.cfg = cfg


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_tiny_pipeline_matches_jax(tiny, guidance):
    jcfg, jpipe, tpipe, img, noises, _, (want, got) = tiny
    if guidance != 1.0:
        want = run_jax(jpipe, jcfg, img, guidance_scale=guidance)
        got = run_torch(tpipe, img, noises, guidance_scale=guidance)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (6, 64, 64, 3)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)
    if guidance == 1.0:
        exp = np.load(os.path.join(REPO, "tests", "data",
                                   "mv_tiny_expected.npz"))
        np.testing.assert_allclose(got[0][:, ::8, ::8], exp["normals"],
                                   atol=2e-3)
        np.testing.assert_allclose(got[1][:, ::8, ::8], exp["colors"],
                                   atol=2e-3)


def test_bf16_no_farther_from_f32_than_jax(tiny):
    jcfg, jpipe, tpipe, img, noises, _, (j32, t32) = tiny
    j32, t32 = np.concatenate(j32), np.concatenate(t32)
    j16 = np.concatenate(run_jax(jpipe, jcfg, img, compute_dtype="bfloat16"))
    t16 = np.concatenate(run_torch(tpipe, img, noises,
                                   compute_dtype="bfloat16"))
    d_jax, d_port = rel_l2(j16, j32), rel_l2(t16, t32)
    assert 0 < d_port <= 1.25 * d_jax, (d_port, d_jax)


def test_port_f32_unet_no_farther_from_float64_than_jax(tiny):
    """What the 1e-4 bound above measures: the tiny UNet's lowest level is
    1×1 (8² latents), where every GroupNorm normalises two values a group,
    and f32 rounding grows from there through the mid block. At the first
    step (t = 667) of the guidance-3 batch, the port's f32 eps (combined as
    the guidance does) lies within 1e-5 relative L2 of its float64 eps, and
    no farther from it than JAX's f32 eps lies."""
    jpipe, tpipe, img, noises = tiny[1], tiny[2], tiny[3], tiny[4]
    embeds, cond = (np.asarray(a) for a in jpipe.encode_image(img))
    emb = np.concatenate([np.zeros((12,) + embeds.shape[1:], np.float32),
                          np.repeat(embeds, 12, 0)])
    cond = np.concatenate([np.zeros((12,) + cond.shape[1:], np.float32),
                           np.repeat(cond, 12, 0)])
    cam = np.tile(tmv.sincos(tmv.camera_task_embeddings(tmv.VIEWS)), (2, 1))
    lat = np.tile(nhwc(noises[0]), (2, 1, 1, 1))
    x = np.concatenate([lat, cond], -1)
    want_j = np.asarray(jax.jit(lambda p, *a: jpipe.unet.apply(
        {"params": p}, *a))(jpipe.params["unet"], x, jnp.asarray(667), emb,
                            cam))
    args = (nchw(x), torch.as_tensor(667), torch.from_numpy(emb),
            torch.from_numpy(cam))
    with torch.inference_mode():
        got = nhwc(tpipe.unet(*args))
        f64 = nhwc(copy.deepcopy(tpipe.unet).double()(
            *(a.double() if a.is_floating_point() else a for a in args)))

    def guided(e):
        uncond, cond_eps = np.split(np.asarray(e, np.float64), 2)
        return uncond + 3.0 * (cond_eps - uncond)

    d_port = rel_l2(guided(got), guided(f64))
    d_jax = rel_l2(guided(want_j), guided(f64))
    assert d_port <= 1e-5 and d_port <= d_jax, (d_port, d_jax)


def test_mv_cli_writes_the_views(tmp_path):
    """The CLI as a user runs it: 18 PNGs at --out-size, the front mask the
    drawing's alpha."""
    root = str(tmp_path)
    paths = write_drawing_uid(root, "toy", size=64)
    out = subprocess.run(
        [sys.executable, "-m", "drawingspinup_torch.cli.mv", "--uid", "toy",
         "--root", root, "--tiny", "--device", "cpu", "--steps", "2",
         "--size", "64", "--out-size", "96", "--seed", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert '"written": 18' in out.stdout
    assert "random weights" in out.stderr
    for kind in ("normal", "color", "mask"):
        for v in tmv.VIEWS:
            a = read_image_u8(paths.mv(kind, v))
            assert a.shape[:2] == (96, 96), (kind, v)
    alpha = read_image_u8(paths.texture)[..., 3]
    front = read_image_u8(paths.mv("mask", "front"))[..., 0]
    want = tmv.resize(torch.from_numpy(alpha[..., None] / 255.0),
                      (96, 96), "nearest").numpy()[..., 0] > 0.5
    np.testing.assert_array_equal(front > 127, want)


def test_mv_cli_matches_jax_generate_uid(tiny, tmp_path, monkeypatch):
    """The CLI in-process with ``--tiny --ckpt``, the checkpoint the JAX
    pipeline's weights (the ``--tiny`` UNet, the full SD VAE; the loader has
    its own tests), in f32, with JAX's draws: its PNGs within ±1 u8 of
    JAX's ``generate_uid`` on those weights, the masks equal."""
    tpipe, noises, jroot = tiny[2], tiny[4], tiny[5]
    root = str(tmp_path)
    write_drawing_uid(root, "toy", size=64)

    config_of = tmv.MVPipelineConfig

    def config(**kw):
        kw.pop("vae")
        return config_of(**kw, compute_dtype="float32")

    def jax_weights(cfg, ckpt_dir, device="cuda"):
        assert ckpt_dir == "jax-weights" and str(device) == "cpu"
        assert cfg.unet == tpipe.cfg.unet
        assert cfg.vae_config() == tpipe.cfg.vae_config()
        return tmv.MVPipeline(cfg, tpipe.unet, tpipe.vae, tpipe.clip)

    monkeypatch.setattr(tmv, "MVPipelineConfig", config)
    monkeypatch.setattr(tmv, "load_pretrained", jax_weights)
    monkeypatch.setattr(tmv, "generate_uid", functools.partial(
        tmv.generate_uid, noises=noises))
    assert cli_mv.main(["--uid", "toy", "--root", root, "--ckpt",
                        "jax-weights", "--tiny", "--device", "cpu",
                        "--steps", str(STEPS), "--size", "64",
                        "--out-size", str(OUT_SIZE), "--seed", "0"]) == 0
    got_paths = tmv.UidPaths(root, "toy")
    want_paths = tmv.UidPaths(jroot, "toy")
    for kind in ("normal", "color", "mask"):
        for v in tmv.VIEWS:
            got = read_image_u8(got_paths.mv(kind, v)).astype(int)
            want = read_image_u8(want_paths.mv(kind, v)).astype(int)
            assert got.shape == want.shape, (kind, v)
            assert got.shape[:2] == (OUT_SIZE, OUT_SIZE), (kind, v)
            if kind == "mask":
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= 1, (kind, v)


def test_isnet_requests_raise(monkeypatch):
    """The heuristic matte without ISNet; a ``DSU_ISNET_CKPT`` that does
    not load and any ``DSU_ISNET_ONNX`` raise (the matte that loads is
    held to JAX's in ``tests/test_torch_isnet.py``)."""
    img = np.ones((16, 16, 3), np.float32)
    img[4:12, 4:12] = 0.2
    assert tmv.background_removal(img)[8, 8] == 1.0
    monkeypatch.setenv("DSU_ISNET_CKPT", "/nonexistent/isnet.pth")
    with pytest.raises(FileNotFoundError, match="DSU_ISNET_CKPT"):
        tmv.background_removal(img, device="cpu")
    monkeypatch.delenv("DSU_ISNET_CKPT")
    monkeypatch.setenv("DSU_ISNET_ONNX", "/nonexistent/isnet.onnx")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmv.background_removal(img, device="cpu")

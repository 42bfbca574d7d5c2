"""PyTorch port, stage 2a (multi-view diffusion): DDIM, the MV attention
folds, the MV-UNet, the SD VAE, CLIP, the checkpoint loader and the
full-width schemas, against the JAX package on the CPU.

  * DDIM: ``alphas_cumprod`` and ``timesteps_for`` equal; ``ddim_step`` for
    eta 0 and 1, epsilon and v prediction, and ``add_noise`` within 1e-6;
  * ``Attention`` with each fold (none, views, views_sparse, domains, cross
    attention), ``BasicMVTransformerBlock`` and ``TransformerMV2D`` within
    relative L2 1e-5 of JAX's ``apply`` with the same weights (seeded
    numpy values, every weight nonzero, converted by
    ``utils/jax_params.py::mv_params``);
  * ``UNetMV2D`` within relative L2 1e-5 over the knobs
    ``tests/test_stage2a_oracles.py`` varies (joint mid, joint last, sparse
    MV without joint, a 3-level 6-view pyramid), with the too-small-latent
    ValueError;
  * the VAE's ``encode_mode``/``decode`` and CLIP with ``preprocess``
    within relative L2 1e-5; ``ops/image.py::resize``'s nearest mode
    (the masks') equal to JAX's, its bicubic within 1e-5;
  * the loader: a diffusers-layout directory of safetensors written by
    hand (f32, f16 and bf16 tensors; Wonder3D's joint-attention names and
    the deprecated attention names) loads strictly and equal; a truncated
    header, a missing key and an unexpected key raise;
  * Stable Diffusion's 4-channel ``conv_in``/``conv_out`` in a UNet of 8
    in and 8 out: both packages' loaders give bit-equal tensors (JAX's
    ``overlay`` zero-pads ``conv_in``, doubles ``conv_out``'s weight and
    leaves its bias at init; a missing part directory is skipped);
  * the full-width UNet, VAE and CLIP built on the meta device have exactly
    the keys and shapes of the SD-1.5, SD-VAE and ViT-L/14 schemas of
    ``tests/test_unet_checkpoint_schema.py`` and
    ``tests/test_vae_clip_checkpoint_schema.py``.

The tiny pipeline, the CLI and bf16 are in
``tests/test_torch_stage2a_pipeline.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drawingspinup_tpu.models import attention_mv as jattn
from drawingspinup_tpu.models import clip_vision as jclip
from drawingspinup_tpu.models import unet_mv2d as junet
from drawingspinup_tpu.models import vae as jvae
from drawingspinup_tpu.ops import diffusion as JD
from drawingspinup_torch.models import attention_mv as tattn
from drawingspinup_torch.models import clip_vision as tclip
from drawingspinup_torch.models import unet_mv2d as tunet
from drawingspinup_torch.models import vae as tvae
from drawingspinup_torch.ops import diffusion as TD
from drawingspinup_torch.utils import diffusers_port as tport
from mv_parity import (load_into, nchw, nhwc, rel_l2, seeded_tree,
                       write_safetensors)
from drawingspinup_torch.utils.jax_params import mv_params
from test_unet_checkpoint_schema import sd15_unet_checkpoint_schema
from test_vae_clip_checkpoint_schema import (
    clip_vit_l14_checkpoint_schema, sd_vae_checkpoint_schema,
)

TOL = 1e-5


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_matches_jax(prediction, eta):
    cfg = TD.DDIMConfig(prediction_type=prediction)
    jcfg = JD.DDIMConfig(prediction_type=prediction)
    acp = TD.alphas_cumprod(cfg)
    np.testing.assert_array_equal(acp, JD.alphas_cumprod(jcfg))
    ts = TD.timesteps_for(cfg, 75)
    np.testing.assert_array_equal(ts, JD.timesteps_for(jcfg, 75))
    rng = np.random.default_rng(1)
    x, out, noise = (rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
                     for _ in range(3))
    for t, t_prev in ((ts[0], ts[1]), (ts[37], ts[38]), (ts[-1], -1)):
        got = TD.ddim_step(cfg, acp, torch.from_numpy(out), int(t),
                           int(t_prev), torch.from_numpy(x), eta=eta,
                           noise=torch.from_numpy(noise)).numpy()
        want = np.asarray(JD.ddim_step(
            jcfg, jnp.asarray(acp), jnp.asarray(out), jnp.asarray(t),
            jnp.asarray(t_prev), jnp.asarray(x), eta=eta,
            noise=jnp.asarray(noise)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    t = np.array([1, 500, 999])
    got = TD.add_noise(acp, torch.from_numpy(x), torch.from_numpy(noise),
                       torch.from_numpy(t)).numpy()
    want = np.asarray(JD.add_noise(jnp.asarray(acp), jnp.asarray(x),
                                   jnp.asarray(noise), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _tokens(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("fold", [None, "views", "views_sparse", "domains",
                                  "cross"])
def test_attention_fold_matches_jax(fold):
    x = _tokens(2, 6, 10, 32)             # 2 groups of 3 views, 10 tokens
    ctx = _tokens(3, 6, 4, 24) if fold == "cross" else None
    kv_fold = None if fold == "cross" else fold
    mod = jattn.Attention(heads=4, cross_dim=24 if ctx is not None else None)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if ctx is not None
                                else ())
    params = seeded_tree(lambda k, *a: mod.init(k, *a, kv_fold=kv_fold,
                                                num_views=3), *args)
    want = mod.apply({"params": params}, *args, kv_fold=kv_fold,
                     num_views=3)
    t = load_into(tattn.Attention(32, 4, cross_dim=24 if ctx is not None
                                  else None), "attn", params)
    with torch.no_grad():
        got = t(torch.from_numpy(x),
                torch.from_numpy(ctx) if ctx is not None else None,
                kv_fold=kv_fold, num_views=3)
    assert rel_l2(got, want) <= TOL


@pytest.mark.parametrize("mid,last,sparse", [(True, True, False),
                                             (False, False, True)])
def test_transformer_blocks_match_jax(mid, last, sparse):
    kw = dict(cross_dim=24, num_views=2, sparse_mv_attention=sparse,
              cd_attention_mid=mid, cd_attention_last=last)
    x = _tokens(4, 4, 12, 32)
    ctx = _tokens(5, 4, 1, 24)
    blk = jattn.BasicMVTransformerBlock(heads=4, **kw)
    params = seeded_tree(blk.init, jnp.asarray(x), jnp.asarray(ctx))
    want = blk.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    t = load_into(tattn.BasicMVTransformerBlock(32, 4, **kw), "block",
                  params)
    with torch.no_grad():
        got = t(torch.from_numpy(x), torch.from_numpy(ctx))
    assert rel_l2(got, want) <= TOL

    xs = _tokens(6, 4, 4, 3, 32)           # (N, H, W, C)
    tr = jattn.TransformerMV2D(heads=4, **kw)
    params = seeded_tree(tr.init, jnp.asarray(xs), jnp.asarray(ctx))
    want = tr.apply({"params": params}, jnp.asarray(xs), jnp.asarray(ctx))
    t = load_into(tattn.TransformerMV2D(32, 4, **kw), "transformer", params)
    with torch.no_grad():
        got = nhwc(t(nchw(xs), torch.from_numpy(ctx)))
    assert rel_l2(got, want) <= TOL


# ---------------------------------------------------------------------------
# UNet, VAE, CLIP
# ---------------------------------------------------------------------------

TINY = dict(block_out_channels=(32, 64), layers_per_block=1,
            cross_attention_dim=16, attention_heads=2,
            projection_class_embeddings_input_dim=10, num_views=2)
UNET_KNOBS = {
    "joint_mid": dict(TINY, cd_attention_mid=True),
    "joint_last": dict(TINY, cd_attention_mid=False, cd_attention_last=True),
    "sparse_mv": dict(TINY, cd_attention_mid=False, sparse_mv_attention=True),
    "three_levels_six_views": dict(
        block_out_channels=(32, 32, 64), layers_per_block=1,
        cross_attention_dim=16, attention_heads=2,
        projection_class_embeddings_input_dim=10, num_views=6,
        cd_attention_mid=True),
}


@pytest.mark.parametrize("knobs", sorted(UNET_KNOBS))
def test_unet_matches_jax(knobs):
    kw = UNET_KNOBS[knobs]
    b = 2 * kw["num_views"]
    rng = np.random.default_rng(7)
    sample = rng.standard_normal((b, 8, 8, 8)).astype(np.float32)
    t = np.full((b,), 321, np.int32)
    ehs = rng.standard_normal((b, 1, 16)).astype(np.float32)
    cls = rng.standard_normal((b, 10)).astype(np.float32)
    unet = junet.UNetMV2D(junet.UNetMVConfig(**kw))
    args = tuple(jnp.asarray(a) for a in (sample, t, ehs, cls))
    params = seeded_tree(unet.init, *args)
    want = np.asarray(unet.apply({"params": params}, *args))
    m = load_into(tunet.UNetMV2D(tunet.UNetMVConfig(**kw)), "unet", params)
    with torch.no_grad():
        got = nhwc(m(nchw(sample), torch.from_numpy(t),
                     torch.from_numpy(ehs), torch.from_numpy(cls)))
        # a scalar timestep broadcasts over the batch
        same = nhwc(m(nchw(sample), torch.tensor(321), torch.from_numpy(ehs),
                      torch.from_numpy(cls)))
    assert got.shape == want.shape
    assert rel_l2(got, want) <= TOL
    np.testing.assert_array_equal(same, got)
    if knobs == "joint_mid":
        with pytest.raises(ValueError, match="too small"):
            m(torch.zeros((b, 8, 1, 1)), torch.from_numpy(t),
              torch.from_numpy(ehs), torch.from_numpy(cls))


def test_vae_matches_jax():
    cfg = dict(block_out_channels=(32, 64), layers_per_block=2)
    vae = jvae.AutoencoderKL(jvae.VAEConfig(**cfg))
    x = np.random.default_rng(8).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    params = seeded_tree(vae.init, jnp.asarray(x))
    z = np.asarray(vae.apply({"params": params}, jnp.asarray(x),
                             method=jvae.AutoencoderKL.encode_mode))
    img = np.asarray(vae.apply({"params": params}, jnp.asarray(z),
                               method=jvae.AutoencoderKL.decode))
    m = load_into(tvae.AutoencoderKL(tvae.VAEConfig(**cfg)), "vae", params)
    with torch.no_grad():
        got_z = nhwc(m.encode_mode(nchw(x)))
        got_img = nhwc(m.decode(nchw(z)))
    assert rel_l2(got_z, z) <= TOL and rel_l2(got_img, img) <= TOL


def test_clip_matches_jax():
    cfg = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
               num_heads=4, projection_dim=16)
    clip = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**cfg))
    images = np.random.default_rng(9).random((2, 48, 40, 3)).astype(
        np.float32)
    pre = np.asarray(jclip.preprocess(jnp.asarray(images), 32))
    params = seeded_tree(clip.init, jnp.asarray(pre))
    want = np.asarray(clip.apply({"params": params}, jnp.asarray(pre)))
    m = load_into(tclip.CLIPVisionModelWithProjection(
        tclip.CLIPVisionConfig(**cfg)), "clip", params)
    got_pre = tclip.preprocess(torch.from_numpy(images), 32)
    assert rel_l2(nhwc(got_pre), pre) <= TOL
    with torch.no_grad():
        got = m(got_pre)
    assert rel_l2(got, want) <= TOL


@pytest.mark.parametrize("method", ["nearest", "bicubic"])
@pytest.mark.parametrize("shape", [(96, 80), (24, 40)])
def test_resize_matches_jax(method, shape):
    """The masks' nearest resize (and the images' bicubic) of
    ``ops/image.py`` against JAX's, up and down."""
    from drawingspinup_tpu.ops.image import resize as jresize
    from drawingspinup_torch.ops.image import resize as tresize

    img = np.random.default_rng(10).random((48, 40, 3)).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(img), shape, method))
    got = tresize(torch.from_numpy(img), shape, method).numpy()
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _tiny_modules():
    from drawingspinup_torch.pipelines import stage2_mv as tmv

    cfg = tmv.MVPipelineConfig(
        unet=tunet.UNetMVConfig(**dict(TINY, cd_attention_mid=True,
                                       cd_attention_last=True)),
        vae=tvae.VAEConfig(block_out_channels=(8, 16), layers_per_block=1))
    pipe = tmv.MVPipeline.init_random(cfg, seed=3, device="cpu")
    # nonzero joint projections, so that their renames are checked
    with torch.no_grad():
        for n, p in pipe.unet.named_parameters():
            if "attn_joint" in n and "to_out" in n:
                p.normal_(generator=torch.Generator().manual_seed(len(n)))
    return cfg, pipe


def test_loader_reads_handwritten_checkpoint(tmp_path):
    from drawingspinup_torch.pipelines import stage2_mv as tmv

    cfg, pipe = _tiny_modules()
    parts = {"unet": pipe.unet, "vae": pipe.vae, "image_encoder": pipe.clip}
    renames = (("attn_joint_mid.", "attn_joint_twice."),
               ("norm_joint_mid.", "norm_joint_twice."),
               ("attn_joint_last.", "attn_joint."),
               ("norm_joint_last.", "norm_joint."))
    old_attn = (("to_q.", "query."), ("to_k.", "key."), ("to_v.", "value."),
                ("to_out.0.", "proj_attn."))
    for part, mod in parts.items():
        state = {}
        for k, v in mod.state_dict().items():
            a = v.numpy()
            if part == "unet":
                for new, old in renames:
                    k = k.replace(new, old)
            if part == "vae" and ".attentions." in k:
                for new, old in old_attn:
                    k = k.replace(new, old)
            state[k] = a
        if part == "image_encoder":
            state["vision_model.embeddings.position_ids"] = np.arange(
                5, dtype=np.int64)[None]
        d = tmp_path / "ckpt" / part
        d.mkdir(parents=True)
        keys = sorted(state)
        half = len(keys) // 2
        # f32 and f16 files, a few tensors stored as bf16
        write_safetensors(str(d / "a.safetensors"),
                          {k: state[k] for k in keys[:half]},
                          bf16=set(keys[:half][::7]))
        write_safetensors(str(d / "b.safetensors"),
                          {k: state[k].astype(np.float16)
                           if state[k].dtype == np.float32 else state[k]
                           for k in keys[half:]})
    assert any("attn_joint_twice." in k for k in tport.read_part(
        str(tmp_path / "ckpt" / "unet")))
    got = tmv.load_pretrained(cfg, str(tmp_path / "ckpt"), device="cpu")
    for part, mod in parts.items():
        new = {"unet": got.unet, "vae": got.vae,
               "image_encoder": got.clip}[part].state_dict()
        for k, v in mod.state_dict().items():
            w = v.numpy()
            bf = (w.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
            assert (np.array_equal(new[k].numpy(), w)
                    or np.array_equal(new[k].numpy(),
                                      w.astype(np.float16).astype(np.float32))
                    or np.array_equal(new[k].numpy(), bf)), (part, k)

    # a truncated header, a missing key and an unexpected key raise
    f = tmp_path / "ckpt" / "vae" / "a.safetensors"
    blob = f.read_bytes()
    f.write_bytes(blob[:40])
    with pytest.raises(ValueError, match="truncated"):
        tport.read_safetensors(str(f))
    state = tport.read_part(str(tmp_path / "ckpt" / "image_encoder"))
    with pytest.raises(RuntimeError, match="Missing"):
        tport.load_part(pipe.clip, "image_encoder",
                        {k: v for k, v in state.items()
                         if "post_layernorm" not in k})
    with pytest.raises(RuntimeError, match="Unexpected"):
        tport.load_part(pipe.clip, "image_encoder",
                        {**state, "vision_model.extra.weight": np.zeros(2)})


def test_loader_adapts_sd_shaped_convs_as_jax(tmp_path, capsys):
    """SD-shaped conv_in/conv_out (4 channels) in a UNet of 8 in, 8 out:
    the port's strict loader gives every tensor bit-equal to JAX's
    ``load_wonder3d_params`` on the same init; the vae/ and
    image_encoder/ directories are missing, and both skip them."""
    from drawingspinup_tpu.utils import diffusers_port as jport

    kw = dict(TINY, cd_attention_mid=True, in_channels=8, out_channels=8)
    b = 2 * kw["num_views"]
    rng = np.random.default_rng(9)
    args = tuple(jnp.asarray(a) for a in (
        rng.standard_normal((b, 8, 8, 8)).astype(np.float32),
        np.full((b,), 321, np.int32),
        rng.standard_normal((b, 1, 16)).astype(np.float32),
        rng.standard_normal((b, 10)).astype(np.float32)))
    unet = junet.UNetMV2D(junet.UNetMVConfig(**kw))
    init = seeded_tree(unet.init, *args, seed=0)
    state = {k: v.numpy() for k, v in load_into(
        tunet.UNetMV2D(tunet.UNetMVConfig(**kw)), "unet",
        seeded_tree(unet.init, *args, seed=1)).state_dict().items()}
    state["conv_in.weight"] = state["conv_in.weight"][:, :4]
    state["conv_out.weight"] = state["conv_out.weight"][:4]
    state["conv_out.bias"] = state["conv_out.bias"][:4]
    d = tmp_path / "ckpt" / "unet"
    d.mkdir(parents=True)
    write_safetensors(str(d / "a.safetensors"), state)

    want = jport.load_wonder3d_params(str(tmp_path / "ckpt"),
                                      {"unet": init})["unet"]
    # the one leaf JAX leaves at init: conv_out's bias of half the width
    assert "1 unmapped" in capsys.readouterr().out.split("unet:")[1]
    want = mv_params({"unet": jax.tree.map(np.asarray, want)})["unet"]
    m = load_into(tunet.UNetMV2D(tunet.UNetMVConfig(**kw)), "unet", init)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    tport.load_wonder3d(str(tmp_path / "ckpt"), m, None, None)
    got = m.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    w_in, w_out = got["conv_in.weight"], got["conv_out.weight"]
    assert w_in.shape[1] == 8 and not w_in[:, 4:].any()
    np.testing.assert_array_equal(w_out[:4].numpy(), w_out[4:].numpy())
    np.testing.assert_array_equal(got["conv_out.bias"].numpy(),
                                  before["conv_out.bias"].numpy())
    # a conv_in with more input channels than the model's still raises
    state["conv_in.weight"] = np.zeros((32, 12, 3, 3), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tport.load_part(m, "unet", state)


def test_load_pretrained_keeps_seeded_init_where_checkpoint_lacks(
        tmp_path):
    """``load_pretrained`` from a checkpoint with only ``unet/``, whose
    conv_in/conv_out are SD-shaped (4 channels): every tensor is finite,
    the VAE and CLIP equal ``init_random``'s from the same seed, conv_out's
    bias keeps that init, and the rest is the checkpoint's."""
    from drawingspinup_torch.pipelines import stage2_mv as tmv

    cfg = tmv.MVPipelineConfig(
        unet=tunet.UNetMVConfig(**dict(TINY, in_channels=8,
                                       out_channels=8)),
        vae=tvae.VAEConfig(block_out_channels=(8, 16), layers_per_block=1))
    src = tmv.MVPipeline.init_random(cfg, seed=5, device="cpu")
    state = {k: v.numpy().copy() for k, v in src.unet.state_dict().items()}
    state["conv_in.weight"] = state["conv_in.weight"][:, :4]
    state["conv_out.weight"] = state["conv_out.weight"][:4]
    state["conv_out.bias"] = state["conv_out.bias"][:4] + 1.0
    d = tmp_path / "ckpt" / "unet"
    d.mkdir(parents=True)
    write_safetensors(str(d / "a.safetensors"), state)

    got = tmv.load_pretrained(cfg, str(tmp_path / "ckpt"), device="cpu")
    ref = tmv.MVPipeline.init_random(cfg, seed=0, device="cpu")
    for name in ("unet", "vae", "clip"):
        for k, v in getattr(got, name).state_dict().items():
            assert torch.isfinite(v).all(), (name, k)
    for name in ("vae", "clip"):
        want = getattr(ref, name).state_dict()
        for k, v in getattr(got, name).state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    u = got.unet.state_dict()
    torch.testing.assert_close(u["conv_out.bias"],
                               ref.unet.state_dict()["conv_out.bias"],
                               rtol=0, atol=0)
    w_in, w_out = u["conv_in.weight"], u["conv_out.weight"]
    np.testing.assert_array_equal(w_in[:, :4].numpy(),
                                  state["conv_in.weight"])
    assert not w_in[:, 4:].any()
    for half in (w_out[:4], w_out[4:]):
        np.testing.assert_array_equal(half.numpy(), state["conv_out.weight"])
    for k, v in u.items():
        if not k.startswith(("conv_in.", "conv_out.")):
            np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_full_width_modules_match_checkpoint_schemas():
    with torch.device("meta"):
        unet = tunet.UNetMV2D(tunet.UNetMVConfig())
        vae = tvae.AutoencoderKL(tvae.VAEConfig())
        clip = tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig())

    def shapes(m, skip=()):
        return {k: tuple(v.shape) for k, v in m.state_dict().items()
                if not any(s in k for s in skip)}

    got = shapes(unet, skip=(".attn_joint", ".norm_joint"))
    assert got == sd15_unet_checkpoint_schema()
    assert any(".attn_joint_mid." in k for k in unet.state_dict())
    assert shapes(vae) == sd_vae_checkpoint_schema()
    assert shapes(clip) == clip_vit_l14_checkpoint_schema()
    n = sum(p.numel() for p in unet.parameters())
    assert 0.8e9 < n < 1.0e9, n

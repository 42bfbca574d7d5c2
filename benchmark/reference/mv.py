"""Plain PyTorch stage 2a, the yardstick the benchmark holds the port's
multi-view diffusion to: Wonder3D's image-conditioned multi-view
cross-domain UNet, the CLIP ViT-L/14 vision tower with its projection, the
SD VAE's encoder and decoder, the DDIM update, the bicubic resize and the
u8 quantisation, as functions of dicts of parameter tensors in float32.

Written for the benchmark from the published code: Wonder3D (Long et al.,
CVPR 2024, arXiv:2310.15008; github.com/xxlong0/Wonder3D,
``mvdiffusion/models/unet_mv2d_condition.py``, ``transformer_mv2d.py``,
``pipelines/pipeline_mvdiffusion_image.py``), diffusers' ``AutoencoderKL``
and ``DDIMScheduler``, transformers' ``CLIPVisionModelWithProjection``,
configured as DrawingSpinUp configures stage 2a
(``2_charactor_reconstructor/configs/mvdiffusion-joint-ortho-6views.yaml``).
Parameter names are the port's state-dict keys (diffusers' and
transformers' names), so one dict of weights made by the benchmark loads
into both; ``unet_shapes``, ``vae_shapes`` and ``clip_shapes`` list them.
Imports nothing of the port. Every convolution and matmul runs in full
float32 (``plain_f32``); attention is the softmax written out.

Departures from the published code, each as the port states it:
- GroupNorm normalises ``(x − mean) · rsqrt(var + eps)`` with the variance
  of the centred values (two passes). Torch's kernel folds the mean into a
  bias, which cancels in f32 where mean² ≫ variance (the port's
  ``models/attention_mv.py::GroupNorm``); the VAE's norms take the same
  form here, where the port keeps torch's kernel (the two agree to
  rounding there).
- CLIP's preprocessing resizes the 256² drawing straight to 224² with the
  bicubic below, where transformers' processor resizes a PIL image's
  shorter side and crops the centre (the same square here) on u8 values.
- The bicubic resize is ``jax.image.resize``'s ``cubic``: Keys' kernel with
  a = −0.5, half-pixel centres, taps outside the image dropped and the
  weights renormalised, the kernel stretched by the scale when it shrinks.
  The published pipeline resizes with PIL.
- The DDIM scheduler takes the checkpoint's settings without
  ``clip_sample`` or thresholding; alphas and the update in float32 as
  diffusers computes them (the port computes the table in float64 and
  rounds it to float32).
- The UNet computes in float32, where the published pipeline runs it in
  fp16 (the configuration's ``compute_dtype`` is bf16: the comparison's
  limits hold that gap).
- The camera ⊕ task class labels come from the configuration's camera
  positions (``cameras``: DrawingSpinUp's fixed poses) as elevation and
  azimuth relative to the front view, with the normal and colour one-hots,
  through ``e_de_da_sincos``: [sin | cos] of the five numbers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
# (name, shape, fan-in, kind): kind "w" a weight (fan-in its inputs), "b" a
# bias, "nw"/"nb" a norm's scale and shift, "e" an embedding table
Shape = Tuple[str, Tuple[int, ...], int, str]
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def plain_f32() -> None:
    """Full float32 products in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# parameter names and shapes
# ---------------------------------------------------------------------------

def _lin(name: str, cin: int, cout: int, bias: bool = True) -> List[Shape]:
    out = [(f"{name}.weight", (cout, cin), cin, "w")]
    return out + [(f"{name}.bias", (cout,), cin, "b")] if bias else out


def _conv(name: str, cin: int, cout: int, k: int,
          bias: bool = True) -> List[Shape]:
    out = [(f"{name}.weight", (cout, cin, k, k), cin * k * k, "w")]
    return out + [(f"{name}.bias", (cout,), cin * k * k, "b")] if bias \
        else out


def _norm(name: str, ch: int) -> List[Shape]:
    return [(f"{name}.weight", (ch,), 0, "nw"), (f"{name}.bias", (ch,), 0,
                                                 "nb")]


def _resnet(name: str, cin: int, cout: int, temb: int = 0) -> List[Shape]:
    out = _norm(f"{name}.norm1", cin) + _conv(f"{name}.conv1", cin, cout, 3)
    if temb:
        out += _lin(f"{name}.time_emb_proj", temb, cout)
    out += _norm(f"{name}.norm2", cout) + _conv(f"{name}.conv2", cout, cout,
                                                3)
    if cin != cout:
        out += _conv(f"{name}.conv_shortcut", cin, cout, 1)
    return out


def _attn(name: str, dim: int, kv: int) -> List[Shape]:
    return (_lin(f"{name}.to_q", dim, dim, False)
            + _lin(f"{name}.to_k", kv, dim, False)
            + _lin(f"{name}.to_v", kv, dim, False)
            + _lin(f"{name}.to_out.0", dim, dim))


def _transformer(name: str, dim: int, u: Dict) -> List[Shape]:
    b = f"{name}.transformer_blocks.0"
    out = _norm(f"{name}.norm", dim) + _conv(f"{name}.proj_in", dim, dim, 1)
    out += _norm(f"{b}.norm1", dim) + _attn(f"{b}.attn1", dim, dim)
    if u["cd_attention_mid"]:
        out += _norm(f"{b}.norm_joint_mid", dim) \
            + _attn(f"{b}.attn_joint_mid", dim, dim)
    out += _norm(f"{b}.norm2", dim) \
        + _attn(f"{b}.attn2", dim, u["cross_attention_dim"])
    out += _norm(f"{b}.norm3", dim) \
        + _lin(f"{b}.ff.net.0.proj", dim, 8 * dim) \
        + _lin(f"{b}.ff.net.2", 4 * dim, dim)
    if u["cd_attention_last"]:
        out += _norm(f"{b}.norm_joint_last", dim) \
            + _attn(f"{b}.attn_joint_last", dim, dim)
    return out + _conv(f"{name}.proj_out", dim, dim, 1)


def unet_shapes(cfg: Dict) -> List[Shape]:
    """Every parameter of the MV UNet of ``cfg["unet"]``."""
    u = cfg["unet"]
    bo = u["block_out_channels"]
    n, temb, per = len(bo), 4 * bo[0], u["layers_per_block"]
    out = _conv("conv_in", u["in_channels"], bo[0], 3)
    out += _lin("time_embedding.linear_1", bo[0], temb) \
        + _lin("time_embedding.linear_2", temb, temb)
    out += _lin("class_embedding.linear_1",
                u["projection_class_embeddings_input_dim"], temb) \
        + _lin("class_embedding.linear_2", temb, temb)
    skips, cin = [bo[0]], bo[0]
    for i, ch in enumerate(bo):
        for j in range(per):
            out += _resnet(f"down_blocks.{i}.resnets.{j}", cin, ch, temb)
            cin = ch
            if i < n - 1:
                out += _transformer(f"down_blocks.{i}.attentions.{j}", ch, u)
            skips.append(ch)
        if i < n - 1:
            out += _conv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
            skips.append(ch)
    out += _resnet("mid_block.resnets.0", bo[-1], bo[-1], temb)
    out += _transformer("mid_block.attentions.0", bo[-1], u)
    out += _resnet("mid_block.resnets.1", bo[-1], bo[-1], temb)
    prev = bo[-1]
    for i, ch in enumerate(reversed(bo)):
        for j in range(per + 1):
            out += _resnet(f"up_blocks.{i}.resnets.{j}", prev + skips.pop(),
                           ch, temb)
            prev = ch
            if i > 0:
                out += _transformer(f"up_blocks.{i}.attentions.{j}", ch, u)
        if i < n - 1:
            out += _conv(f"up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    return out + _norm("conv_norm_out", bo[0]) \
        + _conv("conv_out", bo[0], u["out_channels"], 3)


def _vae_mid(name: str, ch: int) -> List[Shape]:
    a = f"{name}.attentions.0"
    return (_resnet(f"{name}.resnets.0", ch, ch)
            + _norm(f"{a}.group_norm", ch) + _lin(f"{a}.to_q", ch, ch)
            + _lin(f"{a}.to_k", ch, ch) + _lin(f"{a}.to_v", ch, ch)
            + _lin(f"{a}.to_out.0", ch, ch)
            + _resnet(f"{name}.resnets.1", ch, ch))


def vae_shapes(cfg: Dict) -> List[Shape]:
    """Every parameter of the SD VAE of ``cfg["vae"]``."""
    v = cfg["vae"]
    bo, per, lat = v["block_out_channels"], v["layers_per_block"], \
        v["latent_channels"]
    out = _conv("encoder.conv_in", 3, bo[0], 3)
    cin = bo[0]
    for i, ch in enumerate(bo):
        for j in range(per):
            out += _resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin, ch)
            cin = ch
        if i < len(bo) - 1:
            out += _conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch,
                         ch, 3)
    out += _vae_mid("encoder.mid_block", bo[-1])
    out += _norm("encoder.conv_norm_out", bo[-1]) \
        + _conv("encoder.conv_out", bo[-1], 2 * lat, 3)
    out += _conv("decoder.conv_in", lat, bo[-1], 3)
    out += _vae_mid("decoder.mid_block", bo[-1])
    cin = bo[-1]
    for i, ch in enumerate(reversed(bo)):
        for j in range(per + 1):
            out += _resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin, ch)
            cin = ch
        if i < len(bo) - 1:
            out += _conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch,
                         3)
    out += _norm("decoder.conv_norm_out", bo[0]) \
        + _conv("decoder.conv_out", bo[0], 3, 3)
    return out + _conv("quant_conv", 2 * lat, 2 * lat, 1) \
        + _conv("post_quant_conv", lat, lat, 1)


def clip_shapes(cfg: Dict) -> List[Shape]:
    """Every parameter of the CLIP vision tower of ``cfg["clip"]``."""
    c = cfg["clip"]
    d, p = c["hidden_size"], c["patch_size"]
    e = "vision_model.embeddings"
    out = [(f"{e}.class_embedding", (d,), 0, "e")]
    out += _conv(f"{e}.patch_embedding", 3, d, p, bias=False)
    out += [(f"{e}.position_embedding.weight",
             ((c["image_size"] // p) ** 2 + 1, d), 0, "e")]
    out += _norm("vision_model.pre_layrnorm", d)
    for i in range(c["num_layers"]):
        name = f"vision_model.encoder.layers.{i}"
        out += _norm(f"{name}.layer_norm1", d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _lin(f"{name}.self_attn.{proj}", d, d)
        out += _norm(f"{name}.layer_norm2", d)
        out += _lin(f"{name}.mlp.fc1", d, d * c["mlp_ratio"])
        out += _lin(f"{name}.mlp.fc2", d * c["mlp_ratio"], d)
    out += _norm("vision_model.post_layernorm", d)
    return out + _lin("visual_projection", d, c["projection_dim"], False)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ p[f"{name}.weight"].t()
    b = p.get(f"{name}.bias")
    return y if b is None else y + b


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                    stride=stride, padding=padding)


def group_norm(p: Params, name: str, x: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """Centred, then scaled (two passes), on NCHW ``x``."""
    g = x.reshape(x.shape[0], groups, -1)
    c = g - g.mean(-1, keepdim=True)
    var = (c * c).mean(-1, keepdim=True)
    y = (c * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return y * p[f"{name}.weight"].reshape(shape) \
        + p[f"{name}.bias"].reshape(shape)


def layer_norm(p: Params, name: str, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    c = x - x.mean(-1, keepdim=True)
    var = (c * c).mean(-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * p[f"{name}.weight"] \
        + p[f"{name}.bias"]


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           heads: int) -> torch.Tensor:
    """(B, Sq, C) × (B, Sk, C) → (B, Sq, C): softmax(q·kᵀ/√d)·v per head,
    one batch row at a time (a row's scores at the widest fold are 1.2 GB)."""
    b, sq, c = q.shape
    d = c // heads
    out = []
    for i in range(b):
        qi = q[i].reshape(sq, heads, d).transpose(0, 1)
        ki = k[i].reshape(-1, heads, d).transpose(0, 1)
        vi = v[i].reshape(-1, heads, d).transpose(0, 1)
        w = torch.softmax(qi @ ki.transpose(1, 2) * d ** -0.5, dim=-1)
        out.append((w @ vi).transpose(0, 1).reshape(sq, c))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# CLIP ViT-L/14 with its projection
# ---------------------------------------------------------------------------

def clip_embed(p: Params, image: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(N, H, W, 3) images in [0, 1] → (N, projection_dim) embeddings:
    resize to the tower's size, CLIP's mean and std, patches ⊕ class token
    ⊕ positions, pre-norm, the layers (pre-norm attention and quick-GELU
    MLP), the class token post-norm, the projection."""
    c = cfg["clip"]
    plain_f32()
    x = resize(image, c["image_size"])
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    e = "vision_model.embeddings"
    t = F.conv2d(x, p[f"{e}.patch_embedding.weight"],
                 stride=c["patch_size"]).flatten(2).transpose(1, 2)
    cls = p[f"{e}.class_embedding"].expand(t.shape[0], 1, -1)
    h = torch.cat([cls, t], dim=1) + p[f"{e}.position_embedding.weight"]
    h = layer_norm(p, "vision_model.pre_layrnorm", h)
    for i in range(c["num_layers"]):
        name = f"vision_model.encoder.layers.{i}"
        y = layer_norm(p, f"{name}.layer_norm1", h)
        a = attend(linear(p, f"{name}.self_attn.q_proj", y),
                   linear(p, f"{name}.self_attn.k_proj", y),
                   linear(p, f"{name}.self_attn.v_proj", y), c["num_heads"])
        h = h + linear(p, f"{name}.self_attn.out_proj", a)
        y = linear(p, f"{name}.mlp.fc1", layer_norm(p, f"{name}.layer_norm2",
                                                    h))
        h = h + linear(p, f"{name}.mlp.fc2", y * torch.sigmoid(1.702 * y))
    pooled = layer_norm(p, "vision_model.post_layernorm", h[:, 0])
    return linear(p, "visual_projection", pooled)


# ---------------------------------------------------------------------------
# the SD VAE
# ---------------------------------------------------------------------------

def _vae_gn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return group_norm(p, name, x, min(32, x.shape[1]), 1e-6)


def _vae_resnet(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    h = conv(p, f"{name}.conv1", silu(_vae_gn(p, f"{name}.norm1", x)),
             padding=1)
    h = conv(p, f"{name}.conv2", silu(_vae_gn(p, f"{name}.norm2", h)),
             padding=1)
    if f"{name}.conv_shortcut.weight" in p:
        x = conv(p, f"{name}.conv_shortcut", x)
    return x + h


def _vae_mid_block(p: Params, name: str, h: torch.Tensor) -> torch.Tensor:
    h = _vae_resnet(p, f"{name}.resnets.0", h)
    a = f"{name}.attentions.0"
    n, c, hh, ww = h.shape
    y = _vae_gn(p, f"{a}.group_norm", h).permute(0, 2, 3, 1).reshape(
        n, hh * ww, c)
    y = attend(linear(p, f"{a}.to_q", y), linear(p, f"{a}.to_k", y),
               linear(p, f"{a}.to_v", y), 1)
    y = linear(p, f"{a}.to_out.0", y)
    h = h + y.reshape(n, hh, ww, c).permute(0, 3, 1, 2)
    return _vae_resnet(p, f"{name}.resnets.1", h)


def vae_encode(p: Params, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(N, 3, H, W) in [-1, 1] → the latent Gaussian's mean, scaled by the
    scaling factor: (N, latent, H/8, W/8)."""
    v = cfg["vae"]
    plain_f32()
    h = conv(p, "encoder.conv_in", x, padding=1)
    for i in range(len(v["block_out_channels"])):
        for j in range(v["layers_per_block"]):
            h = _vae_resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", h)
        name = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if f"{name}.weight" in p:
            # SD pads the downsampling convs by (0, 1) on each axis
            h = conv(p, name, F.pad(h, (0, 1, 0, 1)), stride=2)
    h = _vae_mid_block(p, "encoder.mid_block", h)
    h = conv(p, "encoder.conv_out", silu(_vae_gn(p, "encoder.conv_norm_out",
                                                 h)), padding=1)
    moments = conv(p, "quant_conv", h)
    return moments[:, :v["latent_channels"]] * v["scaling_factor"]


def vae_decode(p: Params, z: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(N, latent, h, w) scaled latents → (N, 3, 8h, 8w) images in about
    [-1, 1]."""
    v = cfg["vae"]
    plain_f32()
    h = conv(p, "post_quant_conv", z / v["scaling_factor"])
    h = conv(p, "decoder.conv_in", h, padding=1)
    h = _vae_mid_block(p, "decoder.mid_block", h)
    for i in range(len(v["block_out_channels"])):
        for j in range(v["layers_per_block"] + 1):
            h = _vae_resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", h)
        name = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if f"{name}.weight" in p:
            h = conv(p, name, h.repeat_interleave(2, 2).repeat_interleave(
                2, 3), padding=1)
    return conv(p, "decoder.conv_out",
                silu(_vae_gn(p, "decoder.conv_norm_out", h)), padding=1)


# ---------------------------------------------------------------------------
# the multi-view cross-domain UNet
# ---------------------------------------------------------------------------

def class_labels(cfg: Dict) -> torch.Tensor:
    """(2·views, 10) f32: [sin | cos] of (0, Δelevation, Δazimuth,
    normal, colour) per image, normals first, the angles of each view's
    camera position relative to the front view's."""
    cams = cfg["cameras"]

    def angles(name):
        x, y, z = (torch.tensor(float(a), dtype=torch.float64)
                   for a in cams[name])
        return torch.atan2(torch.hypot(x, y), z), torch.atan2(y, x)

    el0, az0 = angles("front")
    rows = []
    for view in cfg["views"]:
        el, az = angles(view)
        rows.append([0.0, float(el - el0),
                     float(torch.remainder(az - az0, 2 * np.pi))])
    cam = torch.tensor(rows, dtype=torch.float32)
    n = len(rows)
    task = torch.tensor([[1.0, 0.0]] * n + [[0.0, 1.0]] * n)
    e = torch.cat([torch.cat([cam, cam]), task], dim=1)
    return torch.cat([torch.sin(e), torch.cos(e)], dim=1)


def timestep_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' Timesteps(flip_sin_to_cos=True, shift 0): [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-float(np.log(10000.0)) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _unet_resnet(p: Params, name: str, x: torch.Tensor,
                 temb: torch.Tensor) -> torch.Tensor:
    h = conv(p, f"{name}.conv1",
             silu(group_norm(p, f"{name}.norm1", x, 32, 1e-5)), padding=1)
    h = h + linear(p, f"{name}.time_emb_proj", silu(temb))[:, :, None, None]
    h = conv(p, f"{name}.conv2",
             silu(group_norm(p, f"{name}.norm2", h, 32, 1e-5)), padding=1)
    if f"{name}.conv_shortcut.weight" in p:
        x = conv(p, f"{name}.conv_shortcut", x)
    return x + h


def _mv_attention(p: Params, name: str, x: torch.Tensor, fold: str,
                  u: Dict, context: torch.Tensor = None) -> torch.Tensor:
    """One attention of a transformer block on (B, S, C) tokens. ``views``:
    each view's queries over the keys and values of every view of its
    domain (B = domains × views, views consecutive); ``domains``: each
    image's queries over its own and the other domain's same view (B =
    [normals | colours]); ``cross``: over ``context``."""
    heads = u["attention_heads"]
    ctx = x if context is None else context
    q = linear(p, f"{name}.to_q", x)
    k, v = linear(p, f"{name}.to_k", ctx), linear(p, f"{name}.to_v", ctx)
    bv, s, c = q.shape
    if fold == "views":
        nv = u["num_views"]
        fold_in = lambda t: t.reshape(bv // nv, nv * s, c)  # noqa: E731
        out = attend(fold_in(q), fold_in(k), fold_in(v), heads).reshape(
            bv, s, c)
    elif fold == "domains":
        h2 = bv // 2
        fold_in = lambda t: torch.cat([t[:h2], t[h2:]], dim=1)  # noqa: E731
        out = attend(fold_in(q), fold_in(k), fold_in(v), heads)
        out = torch.cat([out[:, :s], out[:, s:]], dim=0)
    else:
        out = attend(q, k, v, heads)
    return linear(p, f"{name}.to_out.0", out)


def _unet_transformer(p: Params, name: str, x: torch.Tensor,
                      context: torch.Tensor, u: Dict) -> torch.Tensor:
    """GroupNorm, 1×1 proj_in, the MV block (multi-view self-attention,
    joint attention, cross-attention, GEGLU feed-forward, each pre-norm
    with a residual), 1×1 proj_out, the residual."""
    n, c, h, w = x.shape
    y = conv(p, f"{name}.proj_in", group_norm(p, f"{name}.norm", x, 32,
                                              1e-6))
    y = y.permute(0, 2, 3, 1).reshape(n, h * w, c)
    b = f"{name}.transformer_blocks.0"
    fold = "views" if u["multiview_attention"] else "self"
    y = y + _mv_attention(p, f"{b}.attn1", layer_norm(p, f"{b}.norm1", y),
                          fold, u)
    if u["cd_attention_mid"]:
        y = y + _mv_attention(p, f"{b}.attn_joint_mid",
                              layer_norm(p, f"{b}.norm_joint_mid", y),
                              "domains", u)
    y = y + _mv_attention(p, f"{b}.attn2", layer_norm(p, f"{b}.norm2", y),
                          "cross", u, context)
    a, gate = linear(p, f"{b}.ff.net.0.proj",
                     layer_norm(p, f"{b}.norm3", y)).chunk(2, dim=-1)
    y = y + linear(p, f"{b}.ff.net.2", a * gelu(gate))
    if u["cd_attention_last"]:
        y = y + _mv_attention(p, f"{b}.attn_joint_last",
                              layer_norm(p, f"{b}.norm_joint_last", y),
                              "domains", u)
    y = y.reshape(n, h, w, c).permute(0, 3, 1, 2)
    return conv(p, f"{name}.proj_out", y) + x


def unet(p: Params, sample: torch.Tensor, t: int, context: torch.Tensor,
         labels: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """The predicted noise (B, out, h, w) of ``sample`` (B, in, h, w: the
    noisy latents ⊕ the condition latents) at timestep ``t``, with CLIP
    tokens ``context`` (B, 1, cross) and class labels (B, 10)."""
    u = cfg["unet"]
    plain_f32()
    bo = u["block_out_channels"]
    n, per = len(bo), u["layers_per_block"]
    ts = torch.full((sample.shape[0],), int(t), device=sample.device)
    temb = linear(p, "time_embedding.linear_2", silu(linear(
        p, "time_embedding.linear_1",
        timestep_features(ts, bo[0]).to(sample.dtype))))
    temb = temb + linear(p, "class_embedding.linear_2", silu(linear(
        p, "class_embedding.linear_1", labels)))
    h = conv(p, "conv_in", sample, padding=1)
    skips = [h]
    for i in range(n):
        for j in range(per):
            h = _unet_resnet(p, f"down_blocks.{i}.resnets.{j}", h, temb)
            if i < n - 1:
                h = _unet_transformer(p, f"down_blocks.{i}.attentions.{j}",
                                      h, context, u)
            skips.append(h)
        if i < n - 1:
            h = conv(p, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2,
                     padding=1)
            skips.append(h)
    h = _unet_resnet(p, "mid_block.resnets.0", h, temb)
    h = _unet_transformer(p, "mid_block.attentions.0", h, context, u)
    h = _unet_resnet(p, "mid_block.resnets.1", h, temb)
    for i in range(n):
        for j in range(per + 1):
            h = _unet_resnet(p, f"up_blocks.{i}.resnets.{j}",
                             torch.cat([h, skips.pop()], dim=1), temb)
            if i > 0:
                h = _unet_transformer(p, f"up_blocks.{i}.attentions.{j}", h,
                                      context, u)
        if i < n - 1:
            h = conv(p, f"up_blocks.{i}.upsamplers.0.conv",
                     h.repeat_interleave(2, 2).repeat_interleave(2, 3),
                     padding=1)
    h = silu(group_norm(p, "conv_norm_out", h, 32, 1e-5))
    return conv(p, "conv_out", h, padding=1)


# ---------------------------------------------------------------------------
# DDIM (diffusers' DDIMScheduler, epsilon prediction)
# ---------------------------------------------------------------------------

def alphas_cumprod(cfg: Dict) -> torch.Tensor:
    """The scaled-linear schedule's ᾱ, f32: betas linear in √β."""
    d = cfg["ddim"]
    betas = torch.linspace(d["beta_start"] ** 0.5, d["beta_end"] ** 0.5,
                           d["num_train_timesteps"],
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def timesteps(cfg: Dict) -> List[int]:
    """Leading spacing, descending, plus ``steps_offset``."""
    d, n = cfg["ddim"], cfg["num_inference_steps"]
    ratio = d["num_train_timesteps"] // n
    return [i * ratio + d["steps_offset"] for i in reversed(range(n))]


def ddim_step(cfg: Dict, acp: torch.Tensor, eps: torch.Tensor, t: int,
              x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x_t → x_{t−Δ}, Δ = train steps / inference steps; the final step
    goes to ᾱ[0] (``set_alpha_to_one`` false). With eta > 0 the variance
    term σ·noise is added."""
    d = cfg["ddim"]
    prev = t - d["num_train_timesteps"] // cfg["num_inference_steps"]
    a_t = acp[t]
    a_prev = acp[prev] if prev >= 0 else (
        torch.ones(()) if d["set_alpha_to_one"] else acp[0])
    x0 = (x - (1 - a_t) ** 0.5 * eps) / a_t ** 0.5
    var = (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
    std = cfg["eta"] * var ** 0.5
    out = a_prev ** 0.5 * x0 + (1 - a_prev - std ** 2) ** 0.5 * eps
    return out + std * noise if cfg["eta"] > 0 else out


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

def _cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic, a = −0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of the bicubic resize along one axis:
    half-pixel centres, the kernel stretched by the scale when shrinking,
    taps outside the input dropped and each row renormalised."""
    inv = n_in / n_out
    stretch = max(inv, 1.0)
    at = (np.arange(n_out) + 0.5) * inv - 0.5
    w = _cubic(np.abs(at[:, None] - np.arange(n_in)[None, :]) / stretch)
    return w / w.sum(axis=1, keepdims=True)


def resize(img: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, C) → (N, size, size, C), separable, in float32 (float64
    stays float64)."""
    plain_f32()
    x = img if img.dtype == torch.float64 else img.float()
    wy, wx = (torch.from_numpy(resize_matrix(n, size)).to(x.device, x.dtype)
              for n in img.shape[1:3])
    y = torch.einsum("ih,nhwc->niwc", wy, x)
    return torch.einsum("jw,niwc->nijc", wx, y)


def quantise(v: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats → u8, half up, as 8-bit PNGs are written."""
    return torch.floor(torch.clamp(v, 0.0, 1.0) * 255.0 + 0.5).to(
        torch.uint8)


# ---------------------------------------------------------------------------
# the pipeline's parts
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode(p_clip: Params, p_vae: Params, drawing: torch.Tensor,
           cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """A drawing (H, W, 3) in [0, 1] on white → (CLIP tokens (1, 1,
    projection), condition latents (1, latent, H/8, W/8))."""
    x = drawing[None] if drawing.dtype == torch.float64 \
        else drawing.float()[None]
    embeds = clip_embed(p_clip, x, cfg)
    latents = vae_encode(p_vae, (x * 2.0 - 1.0).permute(0, 3, 1, 2), cfg)
    return embeds[:, None], latents


@torch.no_grad()
def predict_noise(p_unet: Params, latents: torch.Tensor, t: int,
                  embeds: torch.Tensor, cond: torch.Tensor,
                  cfg: Dict) -> torch.Tensor:
    """The UNet's noise for the (B, latent, h, w) ``latents`` of all images
    at ``t``: the condition latents concatenated to each row, the CLIP
    tokens and the class labels repeated over the batch (guidance 1)."""
    b = latents.shape[0]
    sample = torch.cat([latents, cond.expand(b, -1, -1, -1)], dim=1)
    labels = class_labels(cfg).to(latents.device, latents.dtype)
    return unet(p_unet, sample, t, embeds.expand(b, -1, -1), labels, cfg)


@torch.no_grad()
def images_u8(p_vae: Params, latents: torch.Tensor,
              cfg: Dict) -> torch.Tensor:
    """Final latents → (B, out, out, 3) u8: decode, to [0, 1], the bicubic
    resize to ``out_size``, quantised."""
    img = vae_decode(p_vae, latents, cfg).permute(0, 2, 3, 1)
    img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
    return quantise(resize(img, cfg["out_size"]))

"""Plain PyTorch stage-3 models, the yardstick the benchmark holds the
port's outputs to: GeneratorJ_RIC, GeneratorJ, DiscriminatorN_IN and the
VGG19 prefix of the perceptual loss, as functions of a dict of parameter
tensors in float32.

Written for the benchmark from the published models (DrawingSpinUp,
``3_style_translator``) with the semantics the port states in
``drawingspinup_torch/models/generator_j.py`` at commit 87d0b89: batch
norm with flax's biased variance ``E[x²] − E[x]²`` (clipped at 0) and eps
1e-5, leaky ReLU of slope 0.2 in ``jax.nn.leaky_relu``'s form, the RIC
conv's rotated taps sampled bilinearly (``ric_tables.py``). Parameter names
are the port's state-dict keys, so one dict of weights made by the
benchmark loads into both. Imports nothing of the port.

The RIC conv is the plain sum over taps and shifts (einsum), no kernel.
Every convolution and matmul runs in full float32: TF32 is switched off by
``plain_f32``.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.ric_tables import SHIFTS, ric_shifted_weights

EPS = 1e-5
Params = Dict[str, torch.Tensor]


def plain_f32() -> None:
    """Full float32 products in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def batch_norm(p: Params, name: str, x: torch.Tensor, dim: int,
               training: bool) -> torch.Tensor:
    """Batch statistics (biased variance) in training, running ones in
    eval; no update of the running statistics (nothing here reads them
    after a training step)."""
    shape = [1] * x.dim()
    shape[dim] = -1
    if training:
        dims = [d for d in range(x.dim()) if d != dim % x.dim()]
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    scale = torch.rsqrt(var + EPS) * p[f"{name}.weight"]
    return (x - mean.view(shape)) * scale.view(shape) \
        + p[f"{name}.bias"].view(shape)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + EPS)


@functools.lru_cache(maxsize=16)
def swf_table(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(9 shifts, 9 taps, H, W) bilinear weights of the rotated taps."""
    return torch.from_numpy(ric_shifted_weights(h, w).copy()).to(device)


def _shift(y: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """out[:, a, b] = y[:, a + sy, b + sx], zero outside (NHWC)."""
    h, w = y.shape[1], y.shape[2]
    padded = F.pad(y, (0, 0, 1, 1, 1, 1))
    return padded[:, 1 + sy:1 + sy + h, 1 + sx:1 + sx + w]


def ric_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant 3×3 conv of NHWC ``x`` with ``kernel`` (9, C, O):
    each tap's channel product, the taps' bilinear weights onto the nine
    integer shifts, and the nine zero-filled shifts summed."""
    swf = swf_table(x.shape[1], x.shape[2], x.device)
    z = torch.einsum("nhwc,tco->nhwto", x, kernel)
    y = torch.einsum("nhwto,ithw->nhwio", z, swf)
    out = None
    for i, (sy, sx) in enumerate(SHIFTS):
        t = _shift(y[:, :, :, i], sy, sx)
        out = t if out is None else out + t
    return out


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _up(x: torch.Tensor, dim_h: int) -> torch.Tensor:
    """Nearest ×2 along H and W (H at ``dim_h``, W right after it)."""
    return x.repeat_interleave(2, dim=dim_h).repeat_interleave(
        2, dim=dim_h + 1)


def generator_ric(p: Params, x: torch.Tensor, cfg: Dict,
                  training: bool) -> torch.Tensor:
    """GeneratorJ_RIC on NHWC ``x``: every conv a RIC conv, max-pool
    downsampling. smooth0 and smooth_bn do not reach the output (the
    published model's smooth1 reads their input), so they are left out."""
    def bn(name, t):
        return batch_norm(p, name, t, -1, training)

    out0 = leaky(bn("bn0", ric_conv(x, p["conv0.kernel"])))
    out1 = leaky(bn("bn1", ric_conv(_maxpool(out0), p["conv1.kernel"])))
    out2 = leaky(bn("bn2", ric_conv(_maxpool(out1), p["conv2.kernel"])))
    h = out2
    for i in range(cfg["resnet_blocks"]):
        t = ric_conv(F.relu(h), p[f"res{i}_conv0.kernel"])
        t = F.relu(bn(f"res{i}_bn", t))
        h = ric_conv(t, p[f"res{i}_conv1.kernel"]) + h
    h = _up(torch.cat([h, out2], dim=-1), 1)
    h = F.relu(bn("up2_bn", ric_conv(h, p["upconv2.kernel"])))
    h = _up(torch.cat([h, out1], dim=-1), 1)
    h = F.relu(bn("up1_bn", ric_conv(h, p["upconv1.kernel"])))
    h = F.relu(ric_conv(torch.cat([h, out0, x], dim=-1), p["conv_11.kernel"]))
    if cfg["append_smoothers"]:
        h = F.relu(ric_conv(h, p["smooth1.kernel"]))
    y = h @ p["head.weight"].flatten(1).t() + p["head.bias"]
    return torch.tanh(y) if cfg["tanh"] else y


def _conv_block(p: Params, name: str, x: torch.Tensor, stride: int,
                padding: int, norm, act, training: bool) -> torch.Tensor:
    y = F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                 stride=stride, padding=padding)
    if norm == "batch":
        y = batch_norm(p, f"{name}.norm", y, 1, training)
    elif norm == "instance":
        y = instance_norm(y)
    if act == "leaky":
        y = leaky(y)
    elif act == "relu":
        y = F.relu(y)
    return y


def generator_plain(p: Params, x: torch.Tensor, cfg: Dict,
                    training: bool) -> torch.Tensor:
    """GeneratorJ on NHWC ``x``: 7×7 conv0, two stride-2 convs, resnet
    blocks, two (nearest ×2, conv), a 7×7 skip conv, the smoothers, the
    1×1 head and tanh; NCHW inside."""
    def blk(name, t, stride=1, padding=1, norm="batch", act="leaky"):
        return _conv_block(p, name, t, stride, padding, norm, act, training)

    x = x.permute(0, 3, 1, 2)
    out0 = blk("conv0", x, padding=3)
    out1 = blk("conv1", out0, stride=2)
    out2 = blk("conv2", out1, stride=2)
    h = out2
    for i in range(cfg["resnet_blocks"]):
        t = blk(f"res{i}_conv0", F.relu(h), act="relu")
        h = blk(f"res{i}_conv1", t, norm=None, act=None) + h
    h = blk("upconv2", _up(torch.cat([h, out2], dim=1), 2), act="relu")
    h = blk("upconv1", _up(torch.cat([h, out1], dim=1), 2), act="relu")
    h = blk("conv_11", torch.cat([h, out0, x], dim=1), padding=3, norm=None,
            act="relu")
    if cfg["append_smoothers"]:
        h = blk("smooth0", h, norm=None, act="relu")
        h = batch_norm(p, "smooth_bn", h, 1, training)
        h = blk("smooth1", h, norm=None, act="relu")
    y = F.conv2d(h, p["head.weight"], p["head.bias"])
    y = torch.tanh(y) if cfg["tanh"] else y
    return y.permute(0, 2, 3, 1)


def generator(p: Params, x: torch.Tensor, cfg: Dict,
              training: bool) -> torch.Tensor:
    """``cfg``'s generator on NHWC ``x`` → NHWC (N, H, W, 3)."""
    fn = {"GeneratorJ_RIC": generator_ric,
          "GeneratorJ": generator_plain}[cfg["generator"]]
    return fn(p, x, cfg, training)


def discriminator(p: Params, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """PatchGAN with instance norm on NHWC images → NHWC logits."""
    n = cfg["disc_layers"]
    h = _conv_block(p, "conv0", x.permute(0, 3, 1, 2), 2, 1, None, "leaky",
                    True)
    for l in range(1, n + 1):
        h = _conv_block(p, f"conv_{l}", h, 2 if l < n else 1, 1, "instance",
                        "leaky", True)
    h = _conv_block(p, "conv_out", h, 1, 1, None, None, True)
    return h.permute(0, 2, 3, 1)


def vgg_taps(p: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """VGG19 features 0 (conv1_1 before its ReLU), 3 (conv1_2 after its
    ReLU) and 5 (conv2_1 after a 2×2 pool, before its ReLU), NCHW."""
    x = x.permute(0, 3, 1, 2)
    tap0 = F.conv2d(x, p["vggconv0.weight"], p["vggconv0.bias"], padding=1)
    tap3 = F.relu(F.conv2d(F.relu(tap0), p["vggconv1.weight"],
                           p["vggconv1.bias"], padding=1))
    tap5 = F.conv2d(F.max_pool2d(tap3, 2, 2), p["vggconv2.weight"],
                    p["vggconv2.bias"], padding=1)
    return [tap0, tap3, tap5]

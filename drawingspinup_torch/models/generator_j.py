"""Style-translator generators GeneratorJ and GeneratorJ_RIC, eval-mode
forward (counterpart of ``drawingspinup_tpu/models/generator_j.py``).

Public layout is the JAX one: images enter and leave as NHWC f32.
GeneratorJ_RIC stays NHWC throughout, because its convs are the RIC conv
kernel, which takes NHWC. GeneratorJ runs NCHW inside, on ``F.conv2d``.

Parameter names follow the flax module tree (``conv0.kernel``,
``res0_bn.running_mean``, ``smooth_bn.weight`` ...), so
``utils/jax_params.py`` converts a JAX checkpoint by renaming leaves.
Only inference is ported: batch norm uses its running statistics and
raises in training mode. DiscriminatorN_IN and the VGG19 taps come with
stage-3 training.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from drawingspinup_torch.kernels import ric_conv as ric_kernels
from drawingspinup_torch.models.ric_tables import ric_shifted_weights

BN_EPS = 1e-5


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _he_normal(shape, fan_in: int, device, generator) -> nn.Parameter:
    """flax ``he_normal``: truncated normal at ±2σ, rescaled to variance
    2 / fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, device=device)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    return nn.Parameter(t)


class BatchNorm(nn.Module):
    """Eval-mode batch norm over dimension ``dim`` (flax ``nn.BatchNorm``
    with ``use_running_average=True``, eps 1e-5)."""

    def __init__(self, features: int, dim: int = -1, device=None):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode batch norm is not ported; call .eval()")
        shape = [1] * x.dim()
        shape[self.dim] = -1
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return ((x - self.running_mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 of an NHWC tensor."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def _maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, stride 2, of an NHWC tensor with even H and W."""
    n, h, w, c = x.shape
    return x.view(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class ConvBlock(nn.Module):
    """conv → optional batch norm → optional activation (NCHW, OIHW)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = False,
                 norm: Optional[str] = "batch_norm",
                 act: Optional[str] = "leaky", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in ("batch_norm", None) or act not in ("leaky", "relu",
                                                           None):
            raise ValueError(f"unsupported norm {norm!r} / act {act!r}")
        self.stride, self.padding, self.act = stride, padding, act
        self.weight = _he_normal((features, in_features, kernel, kernel),
                                 in_features * kernel * kernel, device,
                                 generator)
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None
        self.norm = BatchNorm(features, dim=1, device=device) \
            if norm == "batch_norm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, self.bias, stride=self.stride,
                     padding=self.padding)
        if self.norm is not None:
            y = self.norm(y)
        if self.act == "leaky":
            y = _leaky(y)
        elif self.act == "relu":
            y = F.relu(y)
        return y


class GeneratorJ(nn.Module):
    """conv0 (7×7) → two stride-2 convs → resnet blocks → two (upsample,
    conv) → skip-concat 7×7 conv_11 → smoothers → 1×1 head → tanh.
    Takes and returns NHWC."""

    def __init__(self, filters: Sequence[int] = (32, 64, 128, 128, 128, 64),
                 resnet_blocks: int = 7, tanh: bool = True,
                 append_smoothers: bool = True, input_channels: int = 6,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = tuple(filters)
        self.resnet_blocks = resnet_blocks
        self.tanh = tanh
        self.append_smoothers = append_smoothers
        blk = functools.partial(ConvBlock, device=device,
                                generator=generator)
        self.conv0 = blk(input_channels, f[0], 7, padding=3)
        self.conv1 = blk(f[0], f[1], 3, stride=2, padding=1)
        self.conv2 = blk(f[1], f[2], 3, stride=2, padding=1)
        for i in range(resnet_blocks):
            self.add_module(f"res{i}_conv0",
                            blk(f[2], f[2], 3, padding=1, act="relu"))
            self.add_module(f"res{i}_conv1",
                            blk(f[2], f[2], 3, padding=1, norm=None,
                                act=None))
        self.upconv2 = blk(2 * f[2], f[4], 3, padding=1, act="relu")
        self.upconv1 = blk(f[4] + f[1], f[4], 3, padding=1, act="relu")
        self.conv_11 = blk(f[4] + f[0] + input_channels, f[5], 7, padding=3,
                           norm=None, act="relu")
        if append_smoothers:
            self.smooth0 = blk(f[5], f[5], 3, padding=1, norm=None,
                               act="relu")
            self.smooth_bn = BatchNorm(f[5], dim=1, device=device)
            self.smooth1 = blk(f[5], f[5], 3, padding=1, norm=None,
                               act="relu")
        self.head = ConvBlock(f[5], 3, 1, use_bias=True, norm=None, act=None,
                              device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        out0 = self.conv0(x)
        out1 = self.conv1(out0)
        out2 = self.conv2(out1)
        h = out2
        for i in range(self.resnet_blocks):
            t = getattr(self, f"res{i}_conv0")(F.relu(h))
            h = getattr(self, f"res{i}_conv1")(t) + h
        h = torch.cat([h, out2], dim=1)
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = self.upconv2(h)
        h = torch.cat([h, out1], dim=1)
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = self.upconv1(h)
        h = self.conv_11(torch.cat([h, out0, x], dim=1))
        if self.append_smoothers:
            h = self.smooth1(self.smooth_bn(self.smooth0(h)))
        y = self.head(h)
        y = torch.tanh(y) if self.tanh else y
        return y.permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=16)
def _swf(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(ric_shifted_weights(h, w).copy()).to(device)


class RICConv(nn.Module):
    """3×3 rotation-invariant conv, NHWC; ``kernel`` is (9, C, O)."""

    def __init__(self, in_features: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _he_normal((9, in_features, features),
                                 9 * in_features, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        swf = _swf(x.shape[1], x.shape[2], x.device)
        return ric_kernels.ric_conv(x.contiguous(), self.kernel, swf)


class GeneratorJ_RIC(nn.Module):
    """GeneratorJ's topology with every conv a RIC conv and max-pool
    downsampling. NHWC throughout.

    The JAX module runs ``smooth0`` and ``smooth_bn`` and then drops their
    output: ``smooth1`` reads ``h``, as the original model does. XLA removes
    that dead branch; here it is skipped in the forward, and the two
    modules stay only so checkpoints convert. One forward is 21 RIC convs
    (7 resnet blocks, smoothers on)."""

    def __init__(self, filters: Sequence[int] = (32, 64, 128, 128, 128, 64),
                 resnet_blocks: int = 7, tanh: bool = True,
                 append_smoothers: bool = True, input_channels: int = 6,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        f = tuple(filters)
        self.resnet_blocks = resnet_blocks
        self.tanh = tanh
        self.append_smoothers = append_smoothers
        conv = functools.partial(RICConv, device=device, generator=generator)
        bn = functools.partial(BatchNorm, device=device)
        self.conv0, self.bn0 = conv(input_channels, f[0]), bn(f[0])
        self.conv1, self.bn1 = conv(f[0], f[1]), bn(f[1])
        self.conv2, self.bn2 = conv(f[1], f[2]), bn(f[2])
        for i in range(resnet_blocks):
            self.add_module(f"res{i}_conv0", conv(f[2], f[2]))
            self.add_module(f"res{i}_bn", bn(f[2]))
            self.add_module(f"res{i}_conv1", conv(f[2], f[2]))
        self.upconv2, self.up2_bn = conv(2 * f[2], f[4]), bn(f[4])
        self.upconv1, self.up1_bn = conv(f[4] + f[1], f[4]), bn(f[4])
        self.conv_11 = conv(f[4] + f[0] + input_channels, f[5])
        if append_smoothers:
            self.smooth0 = conv(f[5], f[5])       # dead branch, see above
            self.smooth_bn = bn(f[5])             # dead branch, see above
            self.smooth1 = conv(f[5], f[5])
        self.head = ConvBlock(f[5], 3, 1, use_bias=True, norm=None, act=None,
                              device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out0 = _leaky(self.bn0(self.conv0(x)))
        out1 = _leaky(self.bn1(self.conv1(_maxpool2x(out0))))
        out2 = _leaky(self.bn2(self.conv2(_maxpool2x(out1))))
        h = out2
        for i in range(self.resnet_blocks):
            t = getattr(self, f"res{i}_conv0")(F.relu(h))
            t = F.relu(getattr(self, f"res{i}_bn")(t))
            h = getattr(self, f"res{i}_conv1")(t) + h
        h = upsample2x(torch.cat([h, out2], dim=-1))
        h = F.relu(self.up2_bn(self.upconv2(h)))
        h = upsample2x(torch.cat([h, out1], dim=-1))
        h = F.relu(self.up1_bn(self.upconv1(h)))
        h = F.relu(self.conv_11(torch.cat([h, out0, x], dim=-1)))
        if self.append_smoothers:
            h = F.relu(self.smooth1(h))
        # 1×1 head as a plain matmul over the channel dim
        y = F.linear(h, self.head.weight.flatten(1), self.head.bias)
        return torch.tanh(y) if self.tanh else y

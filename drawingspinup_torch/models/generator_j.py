"""Style-translator model zoo: GeneratorJ, GeneratorJ_RIC, DiscriminatorN_IN
and the PerceptualVGG19 taps (counterpart of
``drawingspinup_tpu/models/generator_j.py``), in training and eval mode.

Public layout is the JAX one: images enter and leave as NHWC f32.
GeneratorJ_RIC stays NHWC throughout, because its convs are the RIC conv
kernel, which takes NHWC. GeneratorJ, the discriminator and the VGG taps
run NCHW inside, on ``F.conv2d`` (cuDNN), as the JAX package leaves them to
XLA.

Parameter names follow the flax module tree (``conv0.kernel``,
``res0_bn.running_mean``, ``smooth_bn.weight``, ``conv_1.weight``,
``vggconv2.bias`` ...), so ``utils/jax_params.py`` converts JAX variables
by renaming leaves. Batch norm follows flax: batch statistics with the
biased variance in training, running averages with momentum 0.9.

Compute dtype (``dtype``, JAX's ConvBlock rule): the input is cast to it,
the f32 params are cast at use, batch and instance norm run in f32 and are
cast back, and each model's output is f32 at its boundary. The RIC conv
meets bf16 as JAX's training path feeds its kernel: the kernels run in f32
on the input cast up, and their output is rounded to the compute dtype,
autograd carrying the casts.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from drawingspinup_torch.kernels import ric_conv as ric_kernels
from drawingspinup_torch.models.ric_tables import ric_shifted_weights

BN_EPS = 1e-5
BN_MOMENTUM = 0.9       # flax's: running = 0.9 * running + 0.1 * batch


def _leaky(x: torch.Tensor) -> torch.Tensor:
    """Leaky ReLU, slope 0.2, in ``jax.nn.leaky_relu``'s form: at exactly 0
    its gradient is 1. ``F.leaky_relu``'s is 0.2 there, and exact zeros are
    common: a zero-initialised bias on a masked-out (all-zero) patch
    region."""
    return torch.where(x >= 0, x, 0.2 * x)


def _he_normal(shape, fan_in: int, device, generator) -> nn.Parameter:
    """flax ``he_normal``: truncated normal at ±2σ, rescaled to variance
    2 / fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, device=device)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    return nn.Parameter(t)


class BatchNorm(nn.Module):
    """Batch norm over channel dimension ``dim`` with flax ``nn.BatchNorm``'s
    semantics (momentum 0.9, eps 1e-5). Training mode normalises with the
    batch mean and the biased batch variance, ``E[x²] − E[x]²`` clipped at
    0 as flax computes it, and folds both into the running statistics
    (torch's ``F.batch_norm`` would fold in the unbiased variance). Eval
    mode uses the running statistics."""

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
        shape = [1] * x.dim()
        shape[self.dim] = -1
        if self.training:
            dims = [d for d in range(x.dim()) if d != self.dim % x.dim()]
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def _in_f32(norm, y: torch.Tensor) -> torch.Tensor:
    """``norm`` in f32 on ``y``, cast back to ``y``'s dtype (float64 stays
    float64)."""
    if y.dtype in (torch.float32, torch.float64):
        return norm(y)
    return norm(y.float()).to(y.dtype)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel normalisation over H and W of an NCHW tensor,
    biased variance, eps 1e-5, no affine (the JAX ConvBlock's)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + BN_EPS)


def _f32(y: torch.Tensor) -> torch.Tensor:
    """A model's output at its boundary: f32 (float64 stays float64)."""
    return y if y.dtype == torch.float64 else y.float()


def _compute(x: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    """The compute dtype of a layer set to ``dtype`` on input ``x``: a
    float64 input (the tests' reference runs) keeps float64."""
    return torch.float64 if x.dtype == torch.float64 else dtype


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 of an NHWC tensor."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def _maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, stride 2, of an NHWC tensor with even H and W. Its
    gradient goes to the first maximum of each window, as flax's
    ``max_pool`` sends it."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class ConvBlock(nn.Module):
    """conv → optional batch or instance norm → optional activation (NCHW,
    OIHW)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = False,
                 norm: Optional[str] = "batch_norm",
                 act: Optional[str] = "leaky", device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if norm not in ("batch_norm", "instance_norm", None) \
                or act not in ("leaky", "relu", None):
            raise ValueError(f"unsupported norm {norm!r} / act {act!r}")
        self.stride, self.padding, self.act = stride, padding, act
        self.instance_norm = norm == "instance_norm"
        self.weight = _he_normal((features, in_features, kernel, kernel),
                                 in_features * kernel * kernel, device,
                                 generator)
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None
        self.norm = BatchNorm(features, dim=1, device=device) \
            if norm == "batch_norm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute(x, self.dtype)
        y = F.conv2d(x.to(dt), self.weight.to(dt),
                     None if self.bias is None else self.bias.to(dt),
                     stride=self.stride, padding=self.padding)
        if self.norm is not None:
            y = _in_f32(self.norm, y)
        elif self.instance_norm:
            y = _in_f32(instance_norm, y)
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
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = tuple(filters)
        self.resnet_blocks = resnet_blocks
        self.tanh = tanh
        self.append_smoothers = append_smoothers
        self.dtype = dtype
        blk = functools.partial(ConvBlock, device=device,
                                generator=generator, dtype=dtype)
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
                              device=device, generator=generator,
                              dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_compute(x, self.dtype))
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
            h = self.smooth1(_in_f32(self.smooth_bn, self.smooth0(h)))
        # f32 at the model boundary (losses, output)
        y = _f32(self.head(h))
        y = torch.tanh(y) if self.tanh else y
        return y.permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=16)
def _swf(h: int, w: int, device: torch.device,
         dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(ric_shifted_weights(h, w).copy()).to(device,
                                                                 dtype)


# The open ``tables_read`` scopes' lists.
_READERS: List[List[torch.Tensor]] = []


@contextlib.contextmanager
def tables_read() -> Iterator[List[torch.Tensor]]:
    """A list of the RIC tables the forwards inside read. A CUDA graph
    captured there reads them at their addresses on every replay, so it
    holds them after ``_swf``'s cache has let them go."""
    read: List[torch.Tensor] = []
    _READERS.append(read)
    try:
        yield read
    finally:
        _READERS.remove(read)


class RICConv(nn.Module):
    """3×3 rotation-invariant conv, NHWC; ``kernel`` is (9, C, O)."""

    def __init__(self, in_features: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _he_normal((9, in_features, features),
                                 9 * in_features, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in x's dtype: a float64 model runs the plain twin in float64 (the
        # kernels take float32 and refuse anything else); a bf16 input is
        # cast up for the kernels and their output rounded back, as JAX's
        # training path feeds its kernel
        wide = x.dtype if x.dtype == torch.float64 else torch.float32
        swf = _swf(x.shape[1], x.shape[2], x.device, wide)
        for read in _READERS:
            read.append(swf)
        out = ric_kernels.ric_conv(x.to(wide).contiguous(),
                                   self.kernel.to(wide), swf)
        return out.to(x.dtype)


class GeneratorJ_RIC(nn.Module):
    """GeneratorJ's topology with every conv a RIC conv and max-pool
    downsampling. NHWC throughout.

    The JAX module runs ``smooth0`` and ``smooth_bn`` and then drops their
    output: ``smooth1`` reads ``h``, as the original model does. In eval
    mode the branch is dead (XLA removes it) and is skipped here: 21 RIC
    convs per forward (7 resnet blocks, smoothers on). In training mode it
    runs, because ``smooth_bn``'s running statistics change every step: 22
    RIC convs per forward, and still no gradient reaches ``smooth0`` or
    ``smooth_bn``."""

    def __init__(self, filters: Sequence[int] = (32, 64, 128, 128, 128, 64),
                 resnet_blocks: int = 7, tanh: bool = True,
                 append_smoothers: bool = True, input_channels: int = 6,
                 device=None, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = tuple(filters)
        self.resnet_blocks = resnet_blocks
        self.tanh = tanh
        self.append_smoothers = append_smoothers
        self.dtype = dtype
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
            self.smooth0 = conv(f[5], f[5])       # output dropped, see above
            self.smooth_bn = bn(f[5])             # output dropped, see above
            self.smooth1 = conv(f[5], f[5])
        self.head = ConvBlock(f[5], 3, 1, use_bias=True, norm=None, act=None,
                              device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def bn(name: str, t: torch.Tensor) -> torch.Tensor:
            return _in_f32(getattr(self, name), t)

        x = x.to(_compute(x, self.dtype))
        out0 = _leaky(bn("bn0", self.conv0(x)))
        out1 = _leaky(bn("bn1", self.conv1(_maxpool2x(out0))))
        out2 = _leaky(bn("bn2", self.conv2(_maxpool2x(out1))))
        h = out2
        for i in range(self.resnet_blocks):
            t = getattr(self, f"res{i}_conv0")(F.relu(h))
            t = F.relu(bn(f"res{i}_bn", t))
            h = getattr(self, f"res{i}_conv1")(t) + h
        h = upsample2x(torch.cat([h, out2], dim=-1))
        h = F.relu(bn("up2_bn", self.upconv2(h)))
        h = upsample2x(torch.cat([h, out1], dim=-1))
        h = F.relu(bn("up1_bn", self.upconv1(h)))
        h = F.relu(self.conv_11(torch.cat([h, out0, x], dim=-1)))
        if self.append_smoothers:
            if self.training:
                bn("smooth_bn", F.relu(self.smooth0(h)))
            h = F.relu(self.smooth1(h))
        # 1×1 head as a plain matmul over the channel dim, f32 at the
        # model boundary
        y = _f32(F.linear(h, self.head.weight.flatten(1).to(h.dtype),
                          self.head.bias.to(h.dtype)))
        return torch.tanh(y) if self.tanh else y


class DiscriminatorN_IN(nn.Module):
    """PatchGAN with instance norm: 4×4 convs with bias, stride 2 then 1.
    Takes NHWC images and returns NHWC f32 logits (the JAX module returns
    them with a ``None`` beside)."""

    def __init__(self, num_filters: int = 12, n_layers: int = 2, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        blk = functools.partial(ConvBlock, kernel=4, padding=1, use_bias=True,
                                device=device, generator=generator,
                                dtype=dtype)
        self.n_layers = n_layers
        self.conv0 = blk(3, num_filters, stride=2, norm=None)
        ch = num_filters
        for l in range(1, n_layers):
            mult = min(2 ** l, 8)
            self.add_module(f"conv_{l}", blk(ch, num_filters * mult,
                                             stride=2, norm="instance_norm"))
            ch = num_filters * mult
        mult = min(2 ** n_layers, 8)
        self.add_module(f"conv_{n_layers}", blk(ch, num_filters * mult,
                                                norm="instance_norm"))
        self.conv_out = blk(num_filters * mult, 1, norm=None, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv0(x.permute(0, 3, 1, 2))
        for l in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{l}")(h)
        return _f32(self.conv_out(h)).permute(0, 2, 3, 1)


class PerceptualVGG19(nn.Module):
    """The VGG19 prefix the perceptual loss reads, with its maps at feature
    indices (0, 3, 5): conv1_1 before its ReLU, conv1_2 after its ReLU, and
    conv2_1 (after a 2×2 pool) before its ReLU. Weights are a fixed random
    init unless ``load_vgg_weights_npz`` overlays real ones. Frozen by its
    users: it has no optimizer."""

    def __init__(self, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        blk = functools.partial(ConvBlock, kernel=3, padding=1, use_bias=True,
                                norm=None, act=None, device=device,
                                generator=generator, dtype=dtype)
        self.vggconv0 = blk(3, 64)       # features.0
        self.vggconv1 = blk(64, 64)      # features.2
        self.vggconv2 = blk(64, 128)     # features.5

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NHWC images → the three NHWC feature maps, f32 at the boundary
        (the perceptual loss's squared sums)."""
        tap0 = self.vggconv0(x.permute(0, 3, 1, 2))
        tap3 = F.relu(self.vggconv1(F.relu(tap0)))
        tap5 = self.vggconv2(F.max_pool2d(tap3, 2, 2))
        return [_f32(t).permute(0, 2, 3, 1) for t in (tap0, tap3, tap5)]


def load_vgg_weights_npz(vgg: PerceptualVGG19, npz_path: str
                         ) -> PerceptualVGG19:
    """Overlay real VGG19 conv weights from an npz with keys
    ``features.N.weight`` / ``features.N.bias`` in torch OIHW layout (what
    ``scripts/export_vgg19_npz.py`` writes) onto ``vgg``'s convs, in place.
    Convs whose keys the npz lacks are left alone."""
    data = np.load(npz_path)
    with torch.no_grad():
        for conv_i, torch_idx in enumerate((0, 2, 5)):
            key = f"features.{torch_idx}"
            if f"{key}.weight" in data:
                conv = getattr(vgg, f"vggconv{conv_i}")
                conv.weight.copy_(torch.from_numpy(
                    np.asarray(data[f"{key}.weight"], np.float32)))
                conv.bias.copy_(torch.from_numpy(
                    np.asarray(data[f"{key}.bias"], np.float32)))
    return vgg

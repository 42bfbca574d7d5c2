"""The pix2pixHD generator and discriminator zoo of LaMa's stage-1
backbones, NCHW: the port of ``drawingspinup_tpu/models/pix2pixhd.py``.

``GlobalGenerator`` is the ``lama-regular.yaml`` generator;
``MultiDilatedGlobalGenerator`` and ``ConfigGlobalGenerator`` share its
topology (``_GlobalBase``) with other bottleneck blocks;
``GlobalGeneratorFromSuperChannels`` takes its widths from a
super-channels schedule; ``NLayerDiscriminator`` and
``MultidilatedNLayerDiscriminator`` are the PatchGAN discriminators;
``LearnableSpatialTransformWrapper`` (``rotate_image``) and
``SimpleMultiStepGenerator`` wrap other generators. Module names follow upstream's ``nn.Sequential``
layouts (``saicinpainting/training/modules/pix2pixhd.py``; the JAX
package's ``utils/torch_port.py::global_generator_key_map`` lists them),
so a reference ``.ckpt`` loads with ``load_state_dict(strict=True)`` once
its ``num_batches_tracked`` counters are dropped:

* generator ``model``: 0 pad, 1 conv, 2 norm, 3 ReLU; per downsample
  [conv, norm, ReLU]; the bottleneck blocks (``conv_block`` Sequentials:
  [pad, conv, norm, ReLU, pad, conv, norm] for a ResnetBlock, [conv, norm,
  ReLU, conv, norm] for a MultidilatedResnetBlock); per upsample
  [ConvTranspose, norm, ReLU] (or [Upsample, depthwise-separable conv,
  norm, ReLU] for ``deconv_kind="bilinear"``); pad, the 7×7 head;
* discriminator ``model0`` … ``model{n_layers + 1}``.

Conv kinds (``make_conv``) are upstream's ``get_conv_block_ctor``:
``default`` (``nn.Conv2d``), ``depthwise`` (depthwise-separable: a
``depthwise`` and a ``pointwise`` conv) and ``multidilated`` (parallel
dilations 1, 2, 4 … under ``convs``, summed or interleaved). Batch norm is
``models/ffc.py::BatchNorm2d`` (flax's, no ``num_batches_tracked``);
``in`` is an instance norm without affine parameters; reflect pads are
``models/ffc.py::reflect_pad2d``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from drawingspinup_torch.models.ffc import (BatchNorm2d, Conv2d, LeakyReLU,
                                            ReflectionPad2d)


def norm_layer(kind: Optional[str], features: int) -> nn.Module:
    """JAX's ``norm_apply``: ``bn`` batch norm, ``in`` instance norm (eps
    1e-5, no parameters), anything else none."""
    if kind == "bn":
        return BatchNorm2d(features)
    if kind == "in":
        return nn.InstanceNorm2d(features, eps=1e-5)
    return nn.Identity()


def _out_act(name: str) -> nn.Module:
    return {"tanh": nn.Tanh, "sigmoid": nn.Sigmoid}.get(name, nn.Identity)()


class DepthwiseSeparableConv(nn.Module):
    """A per-channel ``k×k`` conv then a 1×1 conv, both with biases
    (upstream's ``DepthWiseSeperableConv``)."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.depthwise = nn.Conv2d(in_dim, in_dim, kernel, stride, padding,
                                   groups=in_dim)
        self.pointwise = nn.Conv2d(in_dim, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class MultiDilatedConv(nn.Module):
    """``dilation_num`` parallel convs of dilation ``min_dilation · 2^i``,
    each padded by ``padding · dilation`` (or ``padding[i]`` for a
    sequence) with ``padding_mode``: ``comb_mode="sum"`` sums full-width
    branches; ``"cat_out"`` concatenates branches of ``out_dim / n``
    channels interleaved so that output channel k cycles through them."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int = 3,
                 stride: int = 1, dilation_num: int = 3,
                 comb_mode: str = "sum", min_dilation: int = 1,
                 padding: Union[int, Sequence[int]] = 1,
                 padding_mode: str = "zeros"):
        super().__init__()
        if comb_mode not in ("sum", "cat_out"):
            raise NotImplementedError(
                f"comb_mode {comb_mode!r} (cat_in/cat_both are unused by "
                f"every reference config)")
        n = dilation_num
        if comb_mode == "cat_out" and out_dim % n:
            raise ValueError("cat_out needs dilation_num | out_dim")
        width = out_dim // n if comb_mode == "cat_out" else out_dim
        convs, d = [], min_dilation
        for i in range(n):
            pad = int(padding[i]) if isinstance(padding, (tuple, list)) \
                else int(padding) * d
            convs.append(Conv2d(in_dim, width, kernel, stride, pad,
                                dilation=d,
                                padding_mode=padding_mode if pad
                                else "zeros"))
            d *= 2
        self.convs = nn.ModuleList(convs)
        self.comb_mode = comb_mode
        if comb_mode == "cat_out":
            self.register_buffer("index", torch.tensor(
                [i + j * width for i in range(width) for j in range(n)]),
                persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [conv(x) for conv in self.convs]
        if self.comb_mode == "sum":
            return sum(outs[1:], outs[0])
        return torch.cat(outs, dim=1)[:, self.index]


def make_conv(kind: str, in_dim: int, out_dim: int, kernel: int = 3,
              stride: int = 1, padding: int = 0) -> nn.Module:
    """Upstream's ``get_conv_block_ctor``: ``default``, ``depthwise`` or
    ``multidilated``, all with biases."""
    if kind == "depthwise":
        return DepthwiseSeparableConv(in_dim, out_dim, kernel, stride,
                                      padding)
    if kind == "multidilated":
        return MultiDilatedConv(in_dim, out_dim, kernel, stride=stride,
                                padding=padding)
    if kind != "default":
        raise ValueError(f"unknown conv kind {kind!r}")
    return nn.Conv2d(in_dim, out_dim, kernel, stride, padding)


class ResnetBlock(nn.Module):
    """Two ``kernel×kernel`` convs with reflect pads of ``dilation ·
    (kernel // 2)``, norms and a ReLU between, plus the skip (through a 1×1
    ``input_conv`` when ``in_dim`` is given). A ``multidilated`` conv kind
    pads inside its branches (zeros, no reflect pad), JAX's repair of a
    combination upstream cannot build."""

    def __init__(self, dim: int, kernel: int = 3, conv_kind: str = "default",
                 norm: str = "bn", dilation: int = 1,
                 second_dilation: Optional[int] = None,
                 in_dim: Optional[int] = None):
        super().__init__()
        cin = in_dim or dim

        def half(c: int, d: int):
            if conv_kind == "multidilated":
                return [nn.Identity(), MultiDilatedConv(
                    c, dim, kernel, padding=kernel // 2)]
            conv = make_conv(conv_kind, c, dim, kernel) if d == 1 \
                else nn.Conv2d(c, dim, kernel, dilation=d)
            return [ReflectionPad2d(d * (kernel // 2)), conv]

        self.conv_block = nn.Sequential(
            *half(cin, dilation), norm_layer(norm, dim), nn.ReLU(),
            *half(dim, second_dilation or dilation), norm_layer(norm, dim))
        self.input_conv = nn.Conv2d(in_dim, dim, 1) if in_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.input_conv is None else self.input_conv(x)
        return skip + self.conv_block(x)


class MultidilatedResnetBlock(nn.Module):
    """Two reflect-padded multidilated convs with norms and a ReLU between,
    plus the skip."""

    def __init__(self, dim: int, norm: str = "bn", comb_mode: str = "sum",
                 dilation_num: int = 3):
        super().__init__()

        def conv():
            return MultiDilatedConv(dim, dim, comb_mode=comb_mode,
                                    dilation_num=dilation_num,
                                    padding_mode="reflect")

        self.conv_block = nn.Sequential(conv(), norm_layer(norm, dim),
                                        nn.ReLU(), conv(),
                                        norm_layer(norm, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class _GlobalBase(nn.Module):
    """pix2pixHD's topology: a 7×7 stem → ``n_downsampling`` stride-2
    convs → the bottleneck blocks → upsamplings → a reflect-padded 7×7
    head → ``out_act``. ``logits`` is the head before the activation."""

    block_kind = "default"      # default | multidilated

    def __init__(self, input_nc: int = 4, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9,
                 conv_kind: str = "default", norm: str = "bn",
                 out_act: str = "tanh", deconv_kind: str = "convtranspose"):
        super().__init__()
        self.conv_kind, self.norm, self.n_blocks = conv_kind, norm, n_blocks
        if conv_kind == "multidilated":
            stem = [nn.Identity(), MultiDilatedConv(input_nc, ngf, 7,
                                                    padding=3)]
        else:
            stem = [ReflectionPad2d(3),
                    make_conv(conv_kind, input_nc, ngf, 7)]
        layers = stem + [norm_layer(norm, ngf), nn.ReLU()]
        for i in range(n_downsampling):
            c = ngf * 2 ** i
            layers += [make_conv(conv_kind, c, 2 * c, 3, stride=2,
                                 padding=1),
                       norm_layer(norm, 2 * c), nn.ReLU()]
        layers += self._bottleneck(ngf * 2 ** n_downsampling)
        for i in range(n_downsampling):
            c = ngf * 2 ** (n_downsampling - i)
            if deconv_kind == "bilinear":
                layers += [nn.Upsample(scale_factor=2, mode="bilinear",
                                       align_corners=False),
                           DepthwiseSeparableConv(c, c // 2, 3, 1, 1)]
            else:
                layers.append(nn.ConvTranspose2d(c, c // 2, 3, stride=2,
                                                 padding=1,
                                                 output_padding=1))
            layers += [norm_layer(norm, c // 2), nn.ReLU()]
        layers += [ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7)]
        self.model = nn.Sequential(*layers)
        self.out_act = _out_act(out_act)

    def _bottleneck(self, dim: int):
        if self.block_kind == "multidilated":
            return [MultidilatedResnetBlock(dim, norm=self.norm)
                    for _ in range(self.n_blocks)]
        return [ResnetBlock(dim, conv_kind=self.conv_kind, norm=self.norm)
                for _ in range(self.n_blocks)]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_act(self.model(x))


class GlobalGenerator(_GlobalBase):
    """The ``lama-regular.yaml`` generator."""


class MultiDilatedGlobalGenerator(_GlobalBase):
    """GlobalGenerator with multidilated bottleneck blocks; the stem,
    downsamplings and upsamplings keep ``conv_kind``."""

    block_kind = "multidilated"


class ConfigGlobalGenerator(_GlobalBase):
    """GlobalGenerator whose bottleneck follows ``manual_block_spec``: runs
    of blocks, each spec a mapping with ``n_blocks`` and optionally
    ``use_default`` (take the instance's kinds), ``resnet_block_kind``
    (``multidilatedresnetblock``, ``resnetblock``, ``resnetblock5x5``,
    ``resnetblockdwdil``), ``resnet_conv_kind`` and ``resnet_dilation``;
    an empty spec means ``n_blocks`` blocks of the instance's kinds."""

    def __init__(self, *args, manual_block_spec: Tuple = (),
                 resnet_block_kind: str = "multidilatedresnetblock",
                 resnet_conv_kind: str = "multidilated",
                 resnet_dilation: int = 1, **kwargs):
        self.spec = ([dict(s) for s in manual_block_spec], resnet_block_kind,
                     resnet_conv_kind, resnet_dilation)
        super().__init__(*args, **kwargs)

    def _bottleneck(self, dim: int):
        specs, block_kind, conv_kind, dilation = self.spec
        blocks = []
        for spec in specs or [{"n_blocks": self.n_blocks,
                               "use_default": True}]:
            kind, ck, dil = block_kind, conv_kind, dilation
            if not spec.get("use_default"):
                kind = spec.get("resnet_block_kind", kind)
                ck = spec.get("resnet_conv_kind", ck)
                if spec.get("resnet_dilation") is not None:
                    dil = spec["resnet_dilation"]
            for _ in range(int(spec["n_blocks"])):
                if kind == "multidilatedresnetblock":
                    blocks.append(MultidilatedResnetBlock(dim,
                                                          norm=self.norm))
                elif kind in ("resnetblock", "resnetblock5x5"):
                    blocks.append(ResnetBlock(
                        dim, kernel=5 if kind.endswith("5x5") else 3,
                        conv_kind=ck, norm=self.norm))
                elif kind == "resnetblockdwdil":
                    blocks.append(ResnetBlock(dim, conv_kind=ck,
                                              norm=self.norm, dilation=dil,
                                              second_dilation=dil))
                else:
                    raise ValueError(
                        f"unknown resnet_block_kind {kind!r}")
        return blocks


class NLayerDiscriminator(nn.Module):
    """pix2pixHD's PatchGAN: 4×4 convs padded by 2, ``model0`` stride 2
    with a leaky ReLU 0.2, ``model1`` … ``model{n_layers - 1}`` stride 2
    (conv kind ``middle_kind``) and ``model{n_layers}`` stride 1, each
    with a norm and a leaky ReLU, widths doubling up to 512, then the
    score conv ``model{n_layers + 1}``. Returns the score and the
    ``n_layers + 1`` activations."""

    middle_kind = "default"

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm: str = "bn", dilation_num: int = 1):
        super().__init__()
        self.n_layers = n_layers
        self.model0 = nn.Sequential(nn.Conv2d(input_nc, ndf, 4, 2, 2),
                                    LeakyReLU())
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            if self.middle_kind == "multidilated":
                # upstream's padding=[2, 3]: one branch is the only
                # spatially consistent configuration
                conv = MultiDilatedConv(prev, nf, 4, stride=2,
                                        padding=(2, 3),
                                        dilation_num=dilation_num)
            else:
                conv = make_conv(self.middle_kind, prev, nf, 4, stride=2,
                                 padding=2)
            setattr(self, f"model{n}", nn.Sequential(
                conv, norm_layer(norm, nf), LeakyReLU()))
        prev, nf = nf, min(nf * 2, 512)
        setattr(self, f"model{n_layers}", nn.Sequential(
            nn.Conv2d(prev, nf, 4, 1, 2), norm_layer(norm, nf), LeakyReLU()))
        setattr(self, f"model{n_layers + 1}",
                nn.Sequential(nn.Conv2d(nf, 1, 4, 1, 2)))

    def forward(self, x: torch.Tensor):
        feats = []
        for n in range(self.n_layers + 1):
            x = getattr(self, f"model{n}")(x)
            feats.append(x)
        return getattr(self, f"model{self.n_layers + 1}")(x), feats


class MultidilatedNLayerDiscriminator(NLayerDiscriminator):
    """NLayerDiscriminator with multidilated stride-2 middle layers."""

    middle_kind = "multidilated"


def convert_super_channels(super_channels: Sequence[int],
                           n_downsampling: int) -> list:
    """Upstream's ``convert_super_channels``: a super-channels schedule →
    the flat per-stage widths (stem and downsamplings, the three bottleneck
    groups, the upsamplings), with its index arithmetic, the upsampling
    entries' ``int`` and the error a 6-entry schedule raises on its third
    upsampling entry."""
    sc = list(super_channels)
    if n_downsampling == 2:
        n1 = 10
    elif n_downsampling == 3:
        n1 = 13
    else:
        raise NotImplementedError(f"n_downsampling={n_downsampling}")
    result, cnt = [], 0
    for i in range(n1):
        if i in (1, 4, 7, 10):
            result.append(sc[cnt] * (2 ** cnt))
            cnt += 1
    for i in range(3):
        result.append(sc[3] * 4 if len(sc) == 6 else sc[i + 3] * 4)
    cnt = 2
    for i in range(n1 + 9, n1 + 21):
        if i in (22, 25, 28):
            cnt -= 1
            ch = (sc[5 - cnt] * (2 ** cnt) if len(sc) == 6
                  else sc[7 - cnt] * (2 ** cnt))
            result.append(int(ch))
    return result


class GlobalGeneratorFromSuperChannels(nn.Module):
    """GlobalGenerator whose widths come from ``convert_super_channels``:
    the bottleneck in three groups of ``n_blocks // 3``, ``n_blocks // 3``
    and the rest, the first block of groups 2 and 3 with a 1×1
    ``input_conv`` on its skip; with batch norm the stem, down- and
    upsampling convs have no bias; tanh output."""

    def __init__(self, input_nc: int = 4, output_nc: int = 3,
                 super_channels: Sequence[int] = (8, 16, 32, 64, 64, 64, 128,
                                                  64, 96),
                 n_downsampling: int = 3, n_blocks: int = 6,
                 norm: str = "bn"):
        super().__init__()
        ch = convert_super_channels(super_channels, n_downsampling)
        nd, bias = n_downsampling, norm == "in"
        layers = [ReflectionPad2d(3), nn.Conv2d(input_nc, ch[0], 7,
                                                bias=bias),
                  norm_layer(norm, ch[0]), nn.ReLU()]
        for i in range(nd):
            layers += [nn.Conv2d(ch[i], ch[1 + i], 3, 2, 1, bias=bias),
                       norm_layer(norm, ch[1 + i]), nn.ReLU()]
        n1 = n_blocks // 3
        for dim, n, skip_in in ((ch[nd], n1, None),
                                (ch[nd + 1], n1, ch[nd]),
                                (ch[nd + 2], n_blocks - 2 * n1, ch[nd + 1])):
            layers += [ResnetBlock(dim, norm=norm,
                                   in_dim=skip_in if i == 0 else None)
                       for i in range(n)]
        prev = ch[nd + 2]
        for i in range(nd):
            out = ch[nd + 4 + i]
            layers += [nn.ConvTranspose2d(prev, out, 3, 2, 1,
                                          output_padding=1, bias=bias),
                       norm_layer(norm, out), nn.ReLU()]
            prev = out
        layers += [ReflectionPad2d(3), nn.Conv2d(prev, output_nc, 7)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.model(x))


def rotate_image(x: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """A differentiable rotation of an NCHW batch about its centre by
    ``angle_deg``: an inverse warp with bilinear sampling, zero outside the
    source (JAX's ``rotate_image``)."""
    n, c, h, w = x.shape
    a = torch.deg2rad(torch.as_tensor(angle_deg, dtype=x.dtype,
                                      device=x.device)).reshape(())
    ys, xs = torch.meshgrid(torch.arange(h, dtype=x.dtype, device=x.device),
                            torch.arange(w, dtype=x.dtype, device=x.device),
                            indexing="ij")
    yc, xc = ys - (h - 1) / 2.0, xs - (w - 1) / 2.0
    cos, sin = torch.cos(a), torch.sin(a)
    src_y = cos * yc + sin * xc + (h - 1) / 2.0
    src_x = -sin * yc + cos * xc + (w - 1) / 2.0
    y0 = torch.clamp(torch.floor(src_y).long(), 0, h - 2)
    x0 = torch.clamp(torch.floor(src_x).long(), 0, w - 2)
    fy = torch.clamp(src_y - y0, 0.0, 1.0)
    fx = torch.clamp(src_x - x0, 0.0, 1.0)
    out = ((1 - fy) * (1 - fx) * x[:, :, y0, x0]
           + (1 - fy) * fx * x[:, :, y0, x0 + 1]
           + fy * (1 - fx) * x[:, :, y0 + 1, x0]
           + fy * fx * x[:, :, y0 + 1, x0 + 1])
    inside = (src_y >= 0) & (src_y <= h - 1) & (src_x >= 0) & (src_x <= w - 1)
    return torch.where(inside, out, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


class LearnableSpatialTransformWrapper(nn.Module):
    """Rotate by the learnable ``angle`` → ``impl`` → rotate back (JAX's
    wrapper: no pad, the rotation exact)."""

    def __init__(self, impl: nn.Module, angle_init: float = 80.0):
        super().__init__()
        self.impl = impl
        self.angle = nn.Parameter(torch.tensor([float(angle_init)]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rotate_image(self.impl(rotate_image(x, self.angle)),
                            -self.angle)


class SimpleMultiStepGenerator(nn.Module):
    """A cascade: each step sees the input and every earlier output
    concatenated; the outputs come back concatenated, newest first."""

    def __init__(self, steps: Sequence[nn.Module]):
        super().__init__()
        self.steps = nn.ModuleList(steps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for step in self.steps:
            outs.append(step(x))
            x = torch.cat([x, outs[-1]], dim=1)
        return torch.cat(outs[::-1], dim=1)

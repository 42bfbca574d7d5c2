"""LaMa's Fast Fourier Convolution networks (stage 1, contour removal),
NCHW: the generator and the FFC discriminator, for inference and
training.

The port of ``drawingspinup_tpu/models/ffc.py``: SELayer, FourierUnit,
SpectralTransform (with the local Fourier unit), FFC (gated or not),
FFCBnAct, FFCResnetBlock (inline or not), FFCResNetGenerator (with
``out_ffc``) and FFCNLayerDiscriminator. Module and parameter names are
upstream LaMa's (``saicinpainting/training/modules/ffc.py``), so a LaMa
generator ``state_dict`` loads with ``load_state_dict(strict=True)`` once
its ``num_batches_tracked`` counters are dropped; the JAX package's
``utils/torch_port.py`` maps the same names onto its flax tree, and
``utils/jax_params.py::ffc_params`` maps a flax tree onto these modules.

A stream is the pair (local, global) of NCHW tensors; an absent stream
is ``None``, and so is a branch whose input or output stream has no
channels. Batch norm is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``:
in eval mode the affine map of the running statistics, in train mode the
batch's mean and biased variance, with the running statistics moved by
that same biased variance. Convolutions reflect-pad where LaMa does
(``reflect_pad2d``, whose backward is ``F.pad``'s to the bit and repeats
bit for bit on the card); the upsampling is ``ConvTranspose2d(k=3, s=2,
p=1, output_padding=1)``.

The generator also runs column-parallel over the ``tp`` axis of a
``(dp, tp)`` mesh once ``parallel/tp.py::shard_params_tp`` has sliced its
parameters and set each module's ``tp`` (the mesh's collectives; None
otherwise, and then every module is the plain one): a sharded layer
computes its slice of the output channels, an activation is gathered
where the next operation needs every channel (a conv's input, the Fourier
unit's spectrum and its (re, im) pairs, the split into streams, the
concatenation), and the batch norms take their statistics over the
global batch, summed over ``dp``.

The squeeze-excitation layer keeps JAX's biases (flax ``Dense``), where
upstream's ``Linear`` layers have none. A Fourier unit's ``fft_norm``
other than ``ortho`` raises (JAX ignores it and runs ``ortho``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from drawingspinup_torch.ops.fourier import irfft2_ortho, rfft2_ortho

Stream = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9       # flax's: running = 0.9 · running + 0.1 · batch


class LeakyReLU(nn.Module):
    """Leaky ReLU of slope 0.2 in ``jax.nn.leaky_relu``'s form: its
    gradient at exactly 0 is 1 (``F.leaky_relu``'s is 0.2)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, 0.2 * x)


def _act(name: str) -> nn.Module:
    return {"relu": nn.ReLU, "sigmoid": nn.Sigmoid, "tanh": nn.Tanh,
            "leaky_relu_0.2": LeakyReLU, "identity": nn.Identity}[name]()


def _pad_segments(n: int, p: int):
    """The (padded slice, source slice, flipped) runs of one axis of a
    reflect pad by ``p``, in the padded axis's order."""
    runs = [(slice(p, p + n), slice(0, n), False)]
    if p:
        runs = [(slice(0, p), slice(1, p + 1), True), *runs,
                (slice(p + n, n + 2 * p), slice(n - 1 - p, n - 1), True)]
    return runs


class _ReflectPad2d(torch.autograd.Function):
    """The forward from slices, flips and concatenations; the backward adds
    the at most nine runs of the padded gradient into a zero gradient, each
    run with a slice add, in the padded tensor's row-major order: every
    source pixel sums its terms in the order ``F.pad``'s CPU backward
    loops over the padded pixels, so both give the same bits. No atomics:
    the CUDA reflection pad's backward adds with them, this one repeats
    bit for bit."""

    @staticmethod
    def forward(ctx, x, ph, pw):
        ctx.pads, ctx.size = (ph, pw), x.shape[-2:]
        if pw:
            x = torch.cat([x[..., 1:pw + 1].flip(-1), x,
                           x[..., -pw - 1:-1].flip(-1)], dim=-1)
        if ph:
            x = torch.cat([x[..., 1:ph + 1, :].flip(-2), x,
                           x[..., -ph - 1:-1, :].flip(-2)], dim=-2)
        return x

    @staticmethod
    def backward(ctx, g):
        (ph, pw), (h, w) = ctx.pads, ctx.size
        gx = g.new_zeros(*g.shape[:-2], h, w)
        for rows, src_rows, flip_h in _pad_segments(h, ph):
            for cols, src_cols, flip_w in _pad_segments(w, pw):
                run = g[..., rows, cols]
                dims = [d for d, f in ((-2, flip_h), (-1, flip_w)) if f]
                gx[..., src_rows, src_cols] += run.flip(dims) if dims \
                    else run
        return gx, None, None


def reflect_pad2d(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``F.pad(x, (pw, pw, ph, ph), mode="reflect")``: the same values and,
    on the CPU, the same gradient bits; a backward without atomics, so
    that a training step repeats bit for bit on the card."""
    return _ReflectPad2d.apply(x, ph, pw)


class ReflectionPad2d(nn.Module):
    """``nn.ReflectionPad2d(p)`` on ``reflect_pad2d``."""

    def __init__(self, p: int):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad2d(x, self.p, self.p)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose ``padding_mode="reflect"`` pads with
    ``reflect_pad2d`` (same parameters and names)."""

    def _conv_forward(self, x, weight, bias):
        if self.padding_mode != "reflect":
            return super()._conv_forward(x, weight, bias)
        return F.conv2d(reflect_pad2d(x, *self.padding), weight, bias,
                        self.stride, 0, self.dilation, self.groups)


def _stream(x: Union[torch.Tensor, Stream]) -> Stream:
    return x if isinstance(x, tuple) else (x, None)


class BatchNorm2d(nn.Module):
    """Batch norm over channel dim 1 with LaMa's parameter names
    (``weight``, ``bias``, ``running_mean``, ``running_var``; no
    ``num_batches_tracked``). In train mode it normalises by the batch's
    mean and biased variance and moves the running statistics by that same
    variance, as flax does; ``F.batch_norm`` would move ``running_var`` by
    the unbiased one, so the update is written out. (flax computes the
    variance as ``mean(x²) − mean(x)²``; the two agree to rounding.)

    On a mesh with more than one dp rank the statistics are flax's over
    the global batch: the sums of x and x² over this rank's rows, summed
    over ``dp``, then ``mean(x²) − mean(x)²`` clamped at 0."""

    tp = None           # parallel/tp.py::TensorParallel under a mesh

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        if self.tp is not None and self.tp.mesh.dp > 1:
            return self._global_batch(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            for stat, batch in ((self.running_mean, mean),
                                (self.running_var, var)):
                stat.copy_(BN_MOMENTUM * stat + (1 - BN_MOMENTUM) * batch)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            BN_EPS)

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        sums = self.tp.dp_sum(torch.stack([x.sum(dim=(0, 2, 3)),
                                           (x * x).sum(dim=(0, 2, 3))]))
        count = x.shape[0] * x.shape[2] * x.shape[3] * self.tp.mesh.dp
        mean, mean2 = sums[0] / count, sums[1] / count
        var = (mean2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            for stat, batch in ((self.running_mean, mean),
                                (self.running_var, var)):
                stat.copy_(BN_MOMENTUM * stat + (1 - BN_MOMENTUM) * batch)
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]


class SELayer(nn.Module):
    """Squeeze-excitation (upstream's ``squeeze_excitation.py``): global
    average → Linear → ReLU → Linear → sigmoid, a gate per channel."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction),
                                nn.ReLU(),
                                nn.Linear(channels // reduction, channels),
                                nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class FourierUnit(nn.Module):
    """rFFT2 → [the spectral positional encoding: a row and a column
    coordinate in [0, 1] as two leading channels] → [squeeze-excitation] →
    1×1 conv + BN + ReLU over the interleaved channels ``[c0_re, c0_im,
    c1_re, …]`` (upstream's ``stack(…, -1)`` order) → irFFT2, the
    transforms in f32 at least."""

    tp = None

    def __init__(self, in_channels: int, out_channels: int, groups: int = 1,
                 spectral_pos_encoding: bool = False, use_se: bool = False,
                 fft_norm: str = "ortho"):
        super().__init__()
        self.in_channels = in_channels
        if fft_norm != "ortho":
            raise NotImplementedError(
                f"FourierUnit: fft_norm {fft_norm!r}; the port, as JAX, "
                f"runs 'ortho' only")
        self.spectral_pos_encoding = spectral_pos_encoding
        cin = in_channels * 2 + (2 if spectral_pos_encoding else 0)
        self.conv_layer = nn.Conv2d(cin, out_channels * 2, 1,
                                    groups=groups, bias=False)
        self.bn = BatchNorm2d(out_channels * 2)
        self.relu = nn.ReLU()
        self.se = SELayer(cin) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        re, im = rfft2_ortho(x)
        ff = torch.stack([re, im], dim=2).reshape(n, 2 * c, h, w // 2 + 1)
        ff = ff.to(x.dtype)
        if self.tp is not None:
            # a slice's spectrum is the spectrum's slice, pairs interleaved
            ff = self.tp.full(ff, 2 * self.in_channels)
        if self.spectral_pos_encoding:
            hh, ww = ff.shape[2:]
            kw = dict(dtype=ff.dtype, device=ff.device)
            rows = torch.arange(hh, **kw) / (hh - 1)
            cols = torch.arange(ww, **kw) / (ww - 1)
            ff = torch.cat([rows[:, None].expand(n, 1, hh, ww),
                            cols[None, :].expand(n, 1, hh, ww), ff], dim=1)
        if self.se is not None:
            ff = self.se(ff)
        if self.tp is not None:
            ff = self.tp.col(self.conv_layer, ff)
        ff = self.relu(self.bn(self.conv_layer(ff)))
        if self.tp is not None and ff.shape[1] % 2:
            ff = self.tp.full(ff, self.conv_layer.out_channels)   # a pair cut
        ff = ff.reshape(n, -1, 2, h, w // 2 + 1)
        return irfft2_ortho(ff[:, :, 0], ff[:, :, 1], (h, w)).to(x.dtype)


class SpectralTransform(nn.Module):
    """The global branch: [2× average pool] → 1×1 conv + BN + ReLU →
    FourierUnit (+ the local Fourier unit over a 2×2 split of the first
    quarter of the channels) → 1×1 conv of the sum."""

    tp = None

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 1, enable_lfu: bool = True, **fu_kwargs):
        super().__init__()
        self.enable_lfu = enable_lfu
        self.downsample = nn.AvgPool2d(2, 2) if stride == 2 else nn.Identity()
        half = out_channels // 2
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_channels, half, 1, groups=groups, bias=False),
            BatchNorm2d(half), nn.ReLU())
        self.fu = FourierUnit(half, half, groups, **fu_kwargs)
        if enable_lfu:
            self.lfu = FourierUnit(half, half, groups)
        self.conv2 = nn.Conv2d(half, out_channels, 1, groups=groups,
                               bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.downsample(x))
        out = self.fu(x)
        tp = self.tp
        if self.enable_lfu:
            xs = x if tp is None else tp.full(x, self.conv2.in_channels)
            c, s = xs.shape[1], xs.shape[2] // 2
            xs = xs[:, : c // 4]
            xs = torch.cat([xs[:, :, :s], xs[:, :, s:2 * s]], dim=1)
            xs = torch.cat([xs[..., :s], xs[..., s:2 * s]], dim=1)
            out = out + self.lfu(xs).repeat(1, 1, 2, 2)
        if tp is None:
            return self.conv2(x + out)
        return self.conv2(tp.col(self.conv2, tp.add(x, out)))


class FFC(nn.Module):
    """Two-stream convolution: local ← l2l(local) + g2l(global) · gate,
    global ← l2g(local) · gate + SpectralTransform(global); with ``gated``
    (and both a global input and a local output) the two gates are the
    sigmoid of a 1×1 conv of both input streams, else 1."""

    tp = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ratio_gin: float, ratio_gout: float, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = False, enable_lfu: bool = True,
                 padding_type: str = "reflect", gated: bool = False,
                 **spectral_kwargs):
        super().__init__()
        in_cg = int(in_channels * ratio_gin)
        in_cl = in_channels - in_cg
        out_cg = int(out_channels * ratio_gout)
        out_cl = out_channels - out_cg

        def conv(cin: int, cout: int) -> Optional[nn.Conv2d]:
            if not (cin and cout):
                return None
            return Conv2d(cin, cout, kernel_size, stride, padding,
                          dilation, groups, bias,
                          padding_mode=padding_type if padding else "zeros")

        self.convl2l = conv(in_cl, out_cl)
        self.convl2g = conv(in_cl, out_cg)
        self.convg2l = conv(in_cg, out_cl)
        self.convg2g = SpectralTransform(
            in_cg, out_cg, stride, 1 if groups == 1 else groups // 2,
            enable_lfu, **spectral_kwargs) if in_cg and out_cg else None
        self.gate = nn.Conv2d(in_channels, 2, 1) \
            if gated and in_cg and out_cl else None
        self.has_l, self.has_g = out_cl > 0, out_cg > 0
        self.in_widths = (in_cl, in_cg)

    @staticmethod
    def _sum(terms) -> Optional[torch.Tensor]:
        terms = [m(t) if g is None else m(t) * g for m, t, g in terms
                 if m is not None]
        return sum(terms[1:], terms[0]) if terms else None

    def _tp_inputs(self, x_l, x_g):
        """Under ``tp``: each input stream with every channel (gathered
        once), given to each consumer, and to the sharded ones through one
        ``copy`` a stream (one all-reduce of its gradient)."""
        tp = self.tp
        x_l, x_g = (tp.full(t, w) for t, w in zip((x_l, x_g),
                                                    self.in_widths))
        g2g = self.convg2g and self.convg2g.conv1[0]
        fed = {}
        for t, layers in ((x_l, (self.convl2l, self.convl2g)),
                          (x_g, (self.convg2l, g2g))):
            sharded = [m for m in layers if m is not None and tp.sharded(m)]
            t_col = tp.copy(t) if sharded and t is not None else t
            for m in layers:
                if m is not None:
                    fed[m] = t_col if m in sharded else t
        if g2g is not None:
            fed[self.convg2g] = fed[g2g]
        return fed

    def forward(self, x: Union[torch.Tensor, Stream]) -> Stream:
        x_l, x_g = _stream(x)
        if self.tp is not None:     # the generator builds no gate
            fed = self._tp_inputs(x_l, x_g)
            out_l = self._sum(((self.convl2l, fed.get(self.convl2l), None),
                               (self.convg2l, fed.get(self.convg2l), None))
                              ) if self.has_l else None
            out_g = self._sum(((self.convl2g, fed.get(self.convl2g), None),
                               (self.convg2g, fed.get(self.convg2g), None))
                              ) if self.has_g else None
            return out_l, out_g
        g2l = l2g = None
        if self.gate is not None:
            gates = torch.sigmoid(self.gate(torch.cat(
                [t for t in (x_l, x_g) if t is not None], dim=1)))
            g2l, l2g = gates[:, :1], gates[:, 1:]
        out_l = self._sum(((self.convl2l, x_l, None),
                           (self.convg2l, x_g, g2l))) if self.has_l else None
        out_g = self._sum(((self.convl2g, x_l, l2g),
                           (self.convg2g, x_g, None))) if self.has_g else None
        return out_l, out_g


class FFCBnAct(nn.Module):
    """FFC, then batch norm and the activation on each stream (upstream's
    ``FFC_BN_ACT``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ratio_gin: float, ratio_gout: float, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = False, activation: str = "identity",
                 padding_type: str = "reflect", enable_lfu: bool = True,
                 **kwargs):
        super().__init__()
        self.ffc = FFC(in_channels, out_channels, kernel_size, ratio_gin,
                       ratio_gout, stride, padding, dilation, groups, bias,
                       enable_lfu, padding_type=padding_type, **kwargs)
        out_cg = int(out_channels * ratio_gout)
        self.out_widths = (out_channels - out_cg, out_cg)
        self.bn_l = BatchNorm2d(out_channels - out_cg) \
            if out_channels > out_cg else None
        self.bn_g = BatchNorm2d(out_cg) if out_cg else None
        self.act = _act(activation)

    def forward(self, x: Union[torch.Tensor, Stream]) -> Stream:
        x_l, x_g = self.ffc(x)
        if x_l is not None:
            x_l = self.act(self.bn_l(x_l))
        if x_g is not None:
            x_g = self.act(self.bn_g(x_g))
        return x_l, x_g


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]
         ) -> Optional[torch.Tensor]:
    if a is None or b is None:
        return b if a is None else a
    return a + b


class FFCResnetBlock(nn.Module):
    """Two 3×3 FFCBnAct with ReLU and a residual add on each stream; an
    ``inline`` block takes and returns one tensor, its last
    ``int(dim · ratio_gin)`` channels the global stream."""

    tp = None

    def __init__(self, dim: int, ratio_gin: float, ratio_gout: float,
                 dilation: int = 1, enable_lfu: bool = True,
                 padding_type: str = "reflect", inline: bool = False):
        super().__init__()
        kw = dict(ratio_gin=ratio_gin, ratio_gout=ratio_gout,
                  padding=dilation, dilation=dilation, activation="relu",
                  padding_type=padding_type, enable_lfu=enable_lfu)
        self.conv1 = FFCBnAct(dim, dim, 3, **kw)
        self.conv2 = FFCBnAct(dim, dim, 3, **kw)
        self.inline = inline
        self.dim = dim
        self.global_in = int(dim * ratio_gin)
        self.out_widths = self.conv2.out_widths

    def forward(self, x: Union[torch.Tensor, Stream]
                ) -> Union[torch.Tensor, Stream]:
        tp = self.tp
        if self.inline:
            if tp is not None:
                x = tp.full(x, self.dim)
            cl = x.shape[1] - self.global_in
            x = (x[:, :cl], x[:, cl:] if self.global_in else None)
        id_l, id_g = _stream(x)
        x_l, x_g = self.conv2(self.conv1((id_l, id_g)))
        if tp is None:
            out = _add(id_l, x_l), _add(id_g, x_g)
        else:
            out = tuple(a if b is None else b if a is None else tp.add(a, b)
                        for a, b in ((id_l, x_l), (id_g, x_g)))
        if not self.inline:
            return out
        if tp is not None:
            out = tuple(tp.full(t, w) for t, w in zip(out, self.out_widths))
        return ConcatTupleLayer()(out)


class ConcatTupleLayer(nn.Module):
    """(local, global) → one tensor, local channels first."""

    def forward(self, x: Union[torch.Tensor, Stream]) -> torch.Tensor:
        parts = [t for t in _stream(x) if t is not None]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class FFCResNetGenerator(nn.Module):
    """The LaMa generator: reflect pad + 7×7 FFC → ``n_downsampling``
    stride-2 FFCs (the last one switches the global ratio to the resnet
    ratio) → ``n_blocks`` FFC residual blocks → transposed-conv
    upsamplings with BN + ReLU → [an inline FFC residual block at ``ngf``,
    ``out_ffc``] → reflect pad + 7×7 conv head → ``add_out_act``.
    ``model`` is upstream's ``nn.Sequential`` without the output
    activation, so ``logits`` is the head before it."""

    tp = None

    def __init__(self, input_nc: int = 4, output_nc: int = 1, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9,
                 max_features: int = 1024, init_ratio_gin: float = 0.0,
                 init_ratio_gout: float = 0.0, down_ratio_gin: float = 0.0,
                 down_ratio_gout: float = 0.0, resnet_ratio: float = 0.75,
                 enable_lfu: bool = False, add_out_act: str = "sigmoid",
                 out_ffc: bool = False):
        super().__init__()
        layers = [ReflectionPad2d(3),
                  FFCBnAct(input_nc, ngf, 7, init_ratio_gin, init_ratio_gout,
                           activation="relu", enable_lfu=enable_lfu)]
        for i in range(n_downsampling):
            mult = 2 ** i
            gout = resnet_ratio if i == n_downsampling - 1 \
                else down_ratio_gout
            layers.append(FFCBnAct(
                min(max_features, ngf * mult),
                min(max_features, ngf * mult * 2), 3, down_ratio_gin, gout,
                stride=2, padding=1, activation="relu",
                enable_lfu=enable_lfu))
        feats = min(max_features, ngf * 2 ** n_downsampling)
        layers += [FFCResnetBlock(feats, resnet_ratio, resnet_ratio,
                                  enable_lfu=enable_lfu)
                   for _ in range(n_blocks)]
        layers.append(ConcatTupleLayer())
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            cout = min(max_features, int(ngf * mult / 2))
            layers += [nn.ConvTranspose2d(min(max_features, ngf * mult), cout,
                                          3, stride=2, padding=1,
                                          output_padding=1),
                       BatchNorm2d(cout), nn.ReLU()]
        if out_ffc:
            layers.append(FFCResnetBlock(ngf, resnet_ratio, resnet_ratio,
                                         enable_lfu=enable_lfu, inline=True))
        layers += [ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7)]
        self.model = nn.Sequential(*layers)
        self.out_act = _act(add_out_act) \
            if add_out_act and add_out_act != "none" else nn.Identity()

    tp_ready = True     # parallel/tp.py::shard_params_tp takes it

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(N, input_nc, H, W) → the head's output before the activation."""
        tp = self.tp
        if tp is None:
            return self.model(x)
        widths = None
        head = self.model[-1]
        for layer in self.model:
            if isinstance(layer, ConcatTupleLayer):
                x = tuple(tp.full(t, w) for t, w in zip(_stream(x), widths))
            elif layer is self.model[-2]:       # gathered before its pad
                x = tp.full(x, head.in_channels)
            elif isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
                x = tp.col(layer, x)
            x = layer(x)
            widths = getattr(layer, "out_widths", None)
        return tp.full(x, head.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_act(self.logits(x))


class FFCNLayerDiscriminator(nn.Module):
    """LaMa's PatchGAN FFC discriminator: ``model0`` a 3×3 FFCBnAct at
    ``ndf``, ``model1``…``model{n_layers - 1}`` stride-2 FFCBnAct doubling
    the width up to ``max_features``, ``model{n_layers}`` a stride-1
    FFCBnAct (width up to 512), all with leaky ReLU 0.2 and reflect pads,
    then the 3×3 score conv ``model{n_layers + 1}``. Returns the score and
    the ``n_layers + 1`` feature maps (the streams concatenated)."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 max_features: int = 512, init_ratio_gin: float = 0.0,
                 init_ratio_gout: float = 0.0, ratio_gin: float = 0.0,
                 ratio_gout: float = 0.0, enable_lfu: bool = False):
        super().__init__()
        self.n_layers = n_layers
        kw = dict(padding=1, activation="leaky_relu_0.2",
                  enable_lfu=enable_lfu)
        setattr(self, "model0", nn.Sequential(FFCBnAct(
            input_nc, ndf, 3, init_ratio_gin, init_ratio_gout, **kw)))
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, max_features)
            setattr(self, f"model{n}", nn.Sequential(FFCBnAct(
                prev, nf, 3, ratio_gin, ratio_gout, stride=2, **kw)))
        prev, nf = nf, min(nf * 2, 512)
        setattr(self, f"model{n_layers}", nn.Sequential(
            FFCBnAct(prev, nf, 3, ratio_gin, ratio_gout, **kw),
            ConcatTupleLayer()))
        setattr(self, f"model{n_layers + 1}",
                nn.Sequential(nn.Conv2d(nf, 1, 3, padding=1)))

    def forward(self, x: torch.Tensor):
        feats = []
        h: Union[torch.Tensor, Stream] = x
        for n in range(self.n_layers + 1):
            h = getattr(self, f"model{n}")(h)
            feats.append(ConcatTupleLayer()(h))
        return getattr(self, f"model{self.n_layers + 1}")(h), feats

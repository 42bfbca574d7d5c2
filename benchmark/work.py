"""The yardstick's arithmetic: the card's published peaks, the operations and
bytes of each piece of work, and the layer lists of the two stage-3
generators, the discriminator and the VGG prefix, worked out from a
configuration's sizes.

Every multiply-add of the algorithm counts two FLOPs, once, whatever kernel
runs it; each input byte is read once and each output byte written once.
Norms, activations, pools, copies and the optimizer are left out of the
model FLOPs: they are a few per element against hundreds of products per
pixel.

``bound_ms``, ``ric_fwd_work``, ``ric_bwd_work``, ``ric_bounds``,
``RIC_SHAPES`` and ``TRAIN_SHAPES`` are copies of ``chip_smoke.py``'s at
commit 87d0b89; ``benchmark/tests/test_bench_work.py`` holds the layer
lists below to the two tables.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

# An H100 SXM's published dense peaks (NVIDIA's data sheet), at 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12               # f32 outside the tensor cores
TF32_FLOPS = 495e12             # TF32 on the tensor cores
# The card's fastest f32-accurate products are 3xTF32: three TF32 products
# each. MFU of an f32 model is taken against this rate.
F32_ACCURATE_FLOPS = TF32_FLOPS / 3

# (H = W, C, O, launches per 512² GeneratorJ_RIC forward)
RIC_SHAPES = (
    (512, 6, 32, 1),        # conv0
    (256, 32, 64, 1),       # conv1
    (128, 64, 128, 1),      # conv2
    (128, 128, 128, 14),    # res{0..6}_conv{0,1}
    (256, 256, 128, 1),     # upconv2
    (512, 192, 128, 1),     # upconv1
    (512, 166, 64, 1),      # conv_11
    (512, 64, 64, 1),       # smooth1
)

# (H = W, C, O, forward launches, backward launches) per training step on
# 40 × 32² patches: conv0 needs no dx; smooth0 runs forward only
TRAIN_SHAPES = (
    (32, 6, 32, 1, 1),      # conv0
    (16, 32, 64, 1, 1),     # conv1
    (8, 64, 128, 1, 1),     # conv2
    (8, 128, 128, 14, 14),  # res{0..6}_conv{0,1}
    (16, 256, 128, 1, 1),   # upconv2
    (32, 192, 128, 1, 1),   # upconv1
    (32, 166, 64, 1, 1),    # conv_11
    (32, 64, 64, 2, 1),     # smooth0, smooth1
)


def bound_ms(nbytes: float, flops: float, peak: float):
    """(least ms for ``nbytes`` of device memory traffic and ``flops`` at
    ``peak`` FLOP/s, "bytes" or "operations": which of the two sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ric_fwd_work(n: int, hw: int, c: int, o: int):
    """(bytes, FLOPs) of one RIC conv forward: x, wk, swf read and the
    output written once; the channel products, 2·9·C·O per pixel (the
    tap sampling's ≤ 73·min(C, O) multiply-adds per pixel left out)."""
    px = n * hw * hw
    return 4 * (px * (c + o) + 9 * c * o + 81 * hw * hw), 2 * 9 * c * o * px


def ric_bwd_work(n: int, hw: int, c: int, o: int, need_dx: bool):
    """(bytes, FLOPs) of one RIC conv backward: x, g, wk, swf read and dx
    (if needed) and dwk written once; the two products, 2·9·C·O FLOPs per
    pixel each (the sampling of dz, 73·O multiply-adds, left out)."""
    px = n * hw * hw
    nbytes = 4 * (px * (c + o + (c if need_dx else 0)) + 2 * 9 * c * o
                  + 81 * hw * hw)
    return nbytes, 2 * 9 * c * o * px * (2 if need_dx else 1)


def ric_bounds(nbytes: float, flops: float):
    """(bound ms, what sets it, bound ms at f32 outside the tensor cores)
    of RIC conv work of ``nbytes`` and ``flops`` f32 FLOPs: the card's
    fastest f32-accurate products are 3xTF32, three TF32 products each."""
    ms, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS)
    return ms, by, bound_ms(nbytes, flops, F32_FLOPS)[0]


class Conv(NamedTuple):
    """One convolution (or the 1×1 head) at its output size.

    kind: "ric" (a 3×3 rotation-invariant conv), "conv" (cuDNN) or
    "dense" (the 1×1 head as a matmul); ``hw`` is the output's side;
    ``grad``: whether the training step back-propagates through it (False
    for GeneratorJ_RIC's smooth0, whose output is dropped); ``dx``:
    whether the step needs its input gradient (False for a first layer)."""
    name: str
    kind: str
    k: int
    c: int
    o: int
    hw: int
    grad: bool = True
    dx: bool = True

    def flops(self, n: int) -> int:
        return 2 * self.k * self.k * self.c * self.o * self.hw * self.hw * n


def _out(hw: int, k: int, s: int, p: int) -> int:
    return (hw + 2 * p - k) // s + 1


def generator_layers(cfg: Dict, hw: int, training: bool) -> List[Conv]:
    """The convolutions of ``cfg``'s generator on an hw × hw input, in
    order, as the port runs them: in training GeneratorJ_RIC also runs
    smooth0 (its output dropped, no gradient); in eval it skips it."""
    f = cfg["filters"]
    c_in = cfg["input_channels"]
    blocks = cfg["resnet_blocks"]
    smooth = cfg["append_smoothers"]
    if cfg["generator"] == "GeneratorJ_RIC":
        kind, k0, k11 = "ric", 3, 3
    elif cfg["generator"] == "GeneratorJ":
        kind, k0, k11 = "conv", 7, 7
    else:
        raise ValueError(f"unknown generator {cfg['generator']!r}")
    h1, h2 = hw // 2, hw // 4
    if kind == "conv":
        h1 = _out(hw, 3, 2, 1)
        h2 = _out(h1, 3, 2, 1)
    layers = [Conv("conv0", kind, k0, c_in, f[0], hw, dx=False),
              Conv("conv1", kind, 3, f[0], f[1], h1),
              Conv("conv2", kind, 3, f[1], f[2], h2)]
    for i in range(blocks):
        layers += [Conv(f"res{i}_conv0", kind, 3, f[2], f[2], h2),
                   Conv(f"res{i}_conv1", kind, 3, f[2], f[2], h2)]
    layers += [Conv("upconv2", kind, 3, 2 * f[2], f[4], 2 * h2),
               Conv("upconv1", kind, 3, f[4] + f[1], f[4], 4 * h2),
               Conv("conv_11", kind, k11, f[4] + f[0] + c_in, f[5], 4 * h2)]
    if smooth:
        if kind == "conv":
            layers.append(Conv("smooth0", kind, 3, f[5], f[5], 4 * h2))
        elif training:
            layers.append(Conv("smooth0", kind, 3, f[5], f[5], 4 * h2,
                               grad=False))
        layers.append(Conv("smooth1", kind, 3, f[5], f[5], 4 * h2))
    layers.append(Conv("head", "dense", 1, f[5], 3, 4 * h2))
    return layers


def discriminator_layers(cfg: Dict, hw: int) -> List[Conv]:
    """DiscriminatorN_IN's 4×4 convs on an hw × hw input: stride 2 for the
    first ``disc_layers``, then stride 1, padding 1 throughout."""
    nf, nl = cfg["disc_filters"], cfg["disc_layers"]
    layers, ch, h = [], 3, hw
    for l in range(nl + 1):
        o = nf * min(2 ** l, 8)
        h = _out(h, 4, 2 if l < nl else 1, 1)
        layers.append(Conv(f"conv_{l}" if l else "conv0", "conv", 4, ch, o,
                           h, dx=l > 0))
        ch = o
    layers.append(Conv("conv_out", "conv", 4, ch, 1, _out(h, 4, 1, 1)))
    return layers


def vgg_layers(hw: int) -> List[Conv]:
    """The VGG19 prefix the perceptual loss reads (features 0, 2, 5)."""
    return [Conv("vggconv0", "conv", 3, 3, 64, hw),
            Conv("vggconv1", "conv", 3, 64, 64, hw),
            Conv("vggconv2", "conv", 3, 64, 128, hw // 2)]


def _fwd(layers: List[Conv], n: int) -> int:
    return sum(l.flops(n) for l in layers)


def _bwd(layers: List[Conv], n: int, weights: bool, input_grad: bool
         ) -> int:
    """Backward FLOPs: the weight gradient of each layer (``weights``) and
    the input gradient of each layer that needs one; the first layer's
    only where the input itself takes a gradient."""
    total = 0
    for l in layers:
        if not l.grad:
            continue
        if weights:
            total += l.flops(n)
        if l.dx or input_grad:
            total += l.flops(n)
    return total


def train_step_flops(cfg: Dict) -> int:
    """Model FLOPs of one GAN step at ``cfg``'s batch of patches: G
    forward and backward; the D step (D on the detached fake and on a real
    patch, weight gradients); the G step's VGG on fake and target (input
    gradient through the fake's) and D on the fake (input gradient, D
    frozen)."""
    n, hw = cfg["batch_size"], cfg["patch_size"]
    g = generator_layers(cfg, hw, training=True)
    d = discriminator_layers(cfg, hw)
    v = vgg_layers(hw)
    g_total = _fwd(g, n) + _bwd(g, n, weights=True, input_grad=False)
    d_step = 2 * _fwd(d, n) + 2 * _bwd(d, n, weights=True, input_grad=False)
    g_step = (2 * _fwd(v, n) + _bwd(v, n, weights=False, input_grad=True)
              + _fwd(d, n) + _bwd(d, n, weights=False, input_grad=True))
    return g_total + d_step + g_step


def frame_flops(cfg: Dict) -> int:
    """Model FLOPs of one served frame: the generator's eval forward."""
    return _fwd(generator_layers(cfg, cfg["frame_size"], training=False), 1)


def ric_launches(cfg: Dict, n: int, hw: int, training: bool):
    """([(n, hw, c, o)] forward launches, [(n, hw, c, o, need_dx)] backward
    launches) of the RIC convs of ``cfg``'s generator, per forward or per
    training step; empty for GeneratorJ."""
    fwd, bwd = [], []
    for l in generator_layers(cfg, hw, training):
        if l.kind != "ric":
            continue
        fwd.append((n, l.hw, l.c, l.o))
        if training and l.grad:
            bwd.append((n, l.hw, l.c, l.o, l.dx))
    return fwd, bwd


def ric_fwd_bound_ms(launches) -> float:
    return sum(ric_bounds(*ric_fwd_work(*s))[0] for s in launches)


def ric_bwd_bound_ms(launches) -> float:
    return sum(ric_bounds(*ric_bwd_work(*s))[0] for s in launches)

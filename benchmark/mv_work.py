"""The stage-2a cell's arithmetic: the operations and bytes of the MV UNet
and of its attention cores, worked out from a configuration's shapes, and
the card's bf16 peak.

Every multiply-add counts two FLOPs, once, whatever kernel runs it. The
UNet's model FLOPs are its convolutions, its linear maps and its attention
products (q·kᵀ and the weights times v, 4·B·Sq·Sk·C for a core whose rows
hold B sequences of Sq queries over Sk keys of width C) at the lengths the
folds give them: a view's queries over all the views of its domain, an
image's over both domains' same view, every query over the one CLIP token.
Norms, activations, the DDIM update and copies are left out. A core's
bytes are its q, k, v and output read or written once in bf16.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

from benchmark.work import HBM_BYTES_PER_S

# An H100 SXM's published dense bf16 peak (NVIDIA's data sheet), at 700 W.
BF16_FLOPS = 989.4e12
BF16_BYTES = 2


class Core(NamedTuple):
    """One attention core: its kind ("views", "domains", "cross"), its rows
    B, queries Sq and keys Sk a row, and its width C."""
    kind: str
    b: int
    sq: int
    sk: int
    c: int


def transformer_levels(cfg: Dict) -> List[tuple]:
    """(channels, latent side) of each transformer block of one UNet
    forward, in order: the down blocks' (all but the last level), the mid
    block's, the up blocks' (all but the first)."""
    u = cfg["unet"]
    bo, per = u["block_out_channels"], u["layers_per_block"]
    side = cfg["image_size"] // 8
    n = len(bo)
    down = [(ch, side >> i) for i in range(n - 1) for ch in [bo[i]] * per]
    mid = [(bo[-1], side >> (n - 1))]
    up = [(ch, side >> (n - 1 - i)) for i in range(1, n)
          for ch in [bo[n - 1 - i]] * (per + 1)]
    return down + mid + up


def attention_cores(cfg: Dict) -> List[Core]:
    """The attention cores of one UNet forward over the configuration's
    batch (views × 2 domains)."""
    u = cfg["unet"]
    batch, nv = cfg["batch"], u["num_views"]
    out = []
    for c, side in transformer_levels(cfg):
        s = side * side
        out.append(Core("views", batch // nv, nv * s, nv * s, c))
        if u["cd_attention_mid"]:
            out.append(Core("domains", batch // 2, 2 * s, 2 * s, c))
        out.append(Core("cross", batch, s, 1, c))
        if u["cd_attention_last"]:
            out.append(Core("domains", batch // 2, 2 * s, 2 * s, c))
    return out


def core_flops(a: Core) -> float:
    return 4.0 * a.b * a.sq * a.sk * a.c


def core_bytes(a: Core) -> float:
    """q and the output at Sq, k and v at Sk, in bf16."""
    return BF16_BYTES * a.b * a.c * 2.0 * (a.sq + a.sk)


def core_bound_s(a: Core) -> float:
    """The least time of one core: its operations at the bf16 peak or its
    bytes at the memory's, the larger."""
    return max(core_flops(a) / BF16_FLOPS, core_bytes(a) / HBM_BYTES_PER_S)


def uid_attention_bound_s(cfg: Dict) -> float:
    """The least time of a uid's attention cores: every step's."""
    return cfg["num_inference_steps"] * sum(
        core_bound_s(a) for a in attention_cores(cfg))


def _conv(cin: int, cout: int, k: int, side: int, batch: int) -> float:
    return 2.0 * cin * cout * k * k * side * side * batch


def unet_flops(cfg: Dict) -> float:
    """Model FLOPs of one UNet forward over the configuration's batch."""
    u = cfg["unet"]
    bo, per = u["block_out_channels"], u["layers_per_block"]
    batch, side, n = cfg["batch"], cfg["image_size"] // 8, len(bo)
    temb, cross = 4 * bo[0], u["cross_attention_dim"]
    total = _conv(u["in_channels"], bo[0], 3, side, batch)
    total += 2.0 * batch * (bo[0] * temb + temb * temb
                            + u["projection_class_embeddings_input_dim"]
                            * temb + temb * temb)

    def resnet(cin, cout, s):
        f = _conv(cin, cout, 3, s, batch) + _conv(cout, cout, 3, s, batch)
        f += 2.0 * batch * temb * cout
        return f + (_conv(cin, cout, 1, s, batch) if cin != cout else 0.0)

    def transformer(c, s):
        tokens = batch * s * s
        joints = int(u["cd_attention_mid"]) + int(u["cd_attention_last"])
        f = 2 * 2.0 * c * c * tokens                     # proj_in, proj_out
        f += (1 + joints) * 4 * 2.0 * c * c * tokens     # q, k, v, out
        f += 2 * 2.0 * c * c * tokens + 2 * 2.0 * cross * c * batch  # attn2
        return f + 24.0 * c * c * tokens                 # GEGLU, ff out

    skips, cin = [bo[0]], bo[0]
    for i, ch in enumerate(bo):
        s = side >> i
        for _ in range(per):
            total += resnet(cin, ch, s)
            cin = ch
            if i < n - 1:
                total += transformer(ch, s)
            skips.append(ch)
        if i < n - 1:
            total += _conv(ch, ch, 3, s // 2, batch)
            skips.append(ch)
    s = side >> (n - 1)
    total += 2 * resnet(bo[-1], bo[-1], s) + transformer(bo[-1], s)
    prev = bo[-1]
    for i, ch in enumerate(reversed(bo)):
        s = side >> (n - 1 - i)
        for _ in range(per + 1):
            total += resnet(prev + skips.pop(), ch, s)
            prev = ch
            if i > 0:
                total += transformer(ch, s)
        if i < n - 1:
            total += _conv(ch, ch, 3, 2 * s, batch)
    total += _conv(bo[0], u["out_channels"], 3, side, batch)
    return total + sum(core_flops(a) for a in attention_cores(cfg))


def uid_unet_flops(cfg: Dict) -> float:
    """Model FLOPs of a uid's UNet forwards: one a DDIM step."""
    return cfg["num_inference_steps"] * unet_flops(cfg)

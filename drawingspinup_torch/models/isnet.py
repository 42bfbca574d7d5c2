"""IS-Net (DIS) salient-object segmentation, the side-view background
removal of stage 2a (counterpart of ``drawingspinup_tpu/models/isnet.py``;
the reference drives the same network through onnxruntime, ``mv.py:17-18``,
``remove_background`` ``mv.py:134-151``).

The public IS-Net of "Highly Accurate Dichotomous Image Segmentation" (Qin
et al., ECCV 2022) as the JAX module builds it: a stride-2 conv-BN-ReLU
stem, a U²-Net encoder of RSU-7 … RSU-4 and two RSU-4F blocks, a decoder
of five RSU blocks, and six 3×3 side convolutions, each upsampled
(bilinear) to the input and passed through a sigmoid; inference takes the
finest (d1). Eval-mode BatchNorm (ε 1e-5), NCHW, cuDNN convolutions.

Parameter names are upstream's ``state_dict`` names, the ones JAX's
``port_isnet_torch_state`` reads: ``conv_in.conv`` / ``conv_in.bn`` for the
stem, ``<stage>.<rebnconv>.conv_s1`` / ``bn_s1`` inside the RSU blocks,
``sideN`` for the side convolutions; so an official ``isnet.pth`` loads
strictly (``load_isnet_state``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class REBNCONV(nn.Module):
    """3×3 conv (dilation d, optional stride) + BN + ReLU; the children are
    ``conv_s1`` / ``bn_s1`` inside an RSU block and ``conv`` / ``bn`` for
    the stem, as upstream names them."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1,
                 stride: int = 1, names=("conv_s1", "bn_s1")):
        super().__init__()
        self._names = names
        setattr(self, names[0], nn.Conv2d(in_ch, out_ch, 3, stride=stride,
                                          padding=dirate, dilation=dirate))
        setattr(self, names[1], nn.BatchNorm2d(out_ch, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = (getattr(self, n) for n in self._names)
        return F.relu(bn(conv(x)))


def _down(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, ceil mode."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of ``x`` to ``ref``'s spatial size (half-pixel
    centres, as ``jax.image.resize`` upsamples)."""
    if x.shape[-2:] == ref.shape[-2:]:
        return x
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear",
                         align_corners=False)


class RSU(nn.Module):
    """Residual U-block of ``height`` levels (RSU-7 … RSU-4)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2))
        for i in range(height - 1, 0, -1):
            setattr(self, f"rebnconv{i}d",
                    REBNCONV(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        enc: List[torch.Tensor] = []
        h = hxin
        for i in range(1, self.height):
            h = getattr(self, f"rebnconv{i}")(h)
            enc.append(h)
            if i < self.height - 1:
                h = _down(h)
        h = getattr(self, f"rebnconv{self.height}")(h)
        for i in range(self.height - 1, 0, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, enc[i - 1]], 1))
            if i > 1:
                h = _up_to(h, enc[i - 2])
        return h + hxin


class RSU4F(nn.Module):
    """Dilation-only RSU (no pooling), dilations 1, 2, 4, 8."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], 1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], 1))
        return self.rebnconv1d(torch.cat([h2d, h1], 1)) + hxin


class ISNetDIS(nn.Module):
    """IS-Net encoder/decoder: (N, 3, H, W) → the six sigmoid side maps
    (N, 1, H, W), finest first."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.conv_in = REBNCONV(in_ch, 64, stride=2, names=("conv", "bn"))
        self.stage1 = RSU(7, 64, 32, 64)
        self.stage2 = RSU(6, 64, 32, 128)
        self.stage3 = RSU(5, 128, 64, 256)
        self.stage4 = RSU(4, 256, 128, 512)
        self.stage5 = RSU4F(512, 256, 512)
        self.stage6 = RSU4F(512, 256, 512)
        self.stage5d = RSU4F(1024, 256, 512)
        self.stage4d = RSU(4, 1024, 128, 256)
        self.stage3d = RSU(5, 512, 64, 128)
        self.stage2d = RSU(6, 256, 32, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i, ch in enumerate((64, 64, 128, 256, 512, 512), 1):
            setattr(self, f"side{i}", nn.Conv2d(ch, 1, 3, padding=1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        hxin = self.conv_in(x)
        hx1 = self.stage1(hxin)
        hx2 = self.stage2(_down(hx1))
        hx3 = self.stage3(_down(hx2))
        hx4 = self.stage4(_down(hx3))
        hx5 = self.stage5(_down(hx4))
        hx6 = self.stage6(_down(hx5))
        hx5d = self.stage5d(torch.cat([_up_to(hx6, hx5), hx5], 1))
        hx4d = self.stage4d(torch.cat([_up_to(hx5d, hx4), hx4], 1))
        hx3d = self.stage3d(torch.cat([_up_to(hx4d, hx3), hx3], 1))
        hx2d = self.stage2d(torch.cat([_up_to(hx3d, hx2), hx2], 1))
        hx1d = self.stage1d(torch.cat([_up_to(hx2d, hx1), hx1], 1))
        return [torch.sigmoid(_up_to(getattr(self, f"side{i}")(h), x))
                for i, h in enumerate((hx1d, hx2d, hx3d, hx4d, hx5d, hx6), 1)]


def load_isnet_state(model: ISNetDIS,
                     state: Mapping[str, "np.ndarray | torch.Tensor"]
                     ) -> ISNetDIS:
    """Load an upstream-named ``state_dict`` (torch tensors or numpy arrays,
    with or without ``num_batches_tracked``) into ``model``: every other key
    must match, in name and shape."""
    sd: Dict[str, torch.Tensor] = {
        k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        for k, v in state.items() if not k.endswith("num_batches_tracked")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"ISNet state: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]}")
    return model


@torch.no_grad()
def isnet_predict(model: ISNetDIS, image: torch.Tensor) -> torch.Tensor:
    """image (H, W, 3) on the model's device, [0, 1] or [0, 255] → the
    saliency mask (H, W) in [0, 1]: /255, mean 0.5, std 1.0, the finest
    side output, clipped (the reference's preprocessing, as JAX's
    ``isnet_predict``)."""
    im = image.to(torch.float32)
    if float(im.max()) <= 1.0 + 1e-6:
        im = im * 255.0
    im = im / 255.0 - 0.5
    d1 = model(im.permute(2, 0, 1)[None])[0]
    return torch.clamp(d1[0, 0], 0.0, 1.0)

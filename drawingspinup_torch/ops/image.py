"""Image ops on tensors in (..., H, W, C) layout, as in
``drawingspinup_tpu/ops/image.py``: the Sobel edge map of a NOCS position
render (stage-3 renders) and the resize of stage 1's input and of stage
2a's images and masks. ``tests/test_torch_render.py`` and
``tests/test_torch_stage2a.py`` hold each to its JAX original.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

EDGE_THRESHOLD = 0.3    # the reference's pos2edge threshold


def _nchw(img: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(..., H, W, C) → (B, C, H, W) and the leading shape."""
    lead = tuple(img.shape[:-3])
    h, w, c = img.shape[-3:]
    return img.reshape(-1, h, w, c).permute(0, 3, 1, 2), lead


def resize(img: torch.Tensor, shape: Tuple[int, int],
           method: str = "bicubic") -> torch.Tensor:
    """Resize (..., H, W, C) → (..., h, w, C) with the semantics of
    ``jax.image.resize``. ``bicubic`` (its ``cubic``): Keys' cubic with
    a = −0.5, half-pixel centres, taps outside the image dropped and the
    weights renormalised, and a kernel stretched by the scale when it
    shrinks (antialiasing). ``F.interpolate``'s antialiased bicubic path
    computes exactly that; its plain bicubic path (a = −0.75, clamped edge
    taps, no antialiasing) does not. ``nearest``: the source pixel whose
    centre is nearest the target's, ``F.interpolate``'s ``nearest-exact``.
    In f32; float64 stays float64."""
    x, lead = _nchw(img if img.dtype == torch.float64 else img.float())
    if method == "bicubic":
        y = F.interpolate(x, size=tuple(shape), mode="bicubic",
                          align_corners=False, antialias=True)
    elif method == "nearest":
        y = F.interpolate(x, size=tuple(shape), mode="nearest-exact")
    else:
        raise ValueError(f"resize: method {method!r}; use 'bicubic' or "
                         f"'nearest'")
    return y.permute(0, 2, 3, 1).reshape(lead + (shape[0], shape[1],
                                                  img.shape[-1]))


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Per-channel Sobel gradient magnitude sqrt(gx² + gy²) with zero
    padding 1, max over channels: (..., H, W, C) float → (..., H, W)."""
    x, lead = _nchw(img.float())
    b, c, h, w = x.shape
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=x.device)
    k = torch.stack([kx, kx.t()])[:, None]                 # (2, 1, 3, 3)
    g = F.conv2d(x.reshape(b * c, 1, h, w), k, padding=1)  # (B·C, 2, H, W)
    mag = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])
    return mag.reshape(b, c, h, w).amax(dim=1).reshape(lead + (h, w))


def edge_from_pos(pos: torch.Tensor, mask: torch.Tensor,
                  threshold: float = EDGE_THRESHOLD) -> torch.Tensor:
    """NOCS position render (..., H, W, 3) → binary edge map (..., H, W):
    Sobel magnitude above ``threshold``, kept inside ``mask`` > 0.5."""
    edge = (sobel_magnitude(pos) > threshold).float()
    return edge * (mask > 0.5).float()

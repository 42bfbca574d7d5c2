"""2-D real FFTs over the last two axes (H, W) with ``norm="ortho"``, the
spectral primitive of LaMa's FourierUnit, on cuFFT (or pocketfft on the
CPU) through ``torch.fft``.

The JAX package computes the same transforms as DFT matmuls
(``drawingspinup_tpu/ops/fourier.py``) because XLA's FFT does not run on
its TPU; the port drops those. The transforms run in float32 at least
(float64 stays float64), whatever the caller's dtype, and return or take
the real and imaginary parts as two real tensors.

The inverse ignores the imaginary parts of the zero-frequency column and,
for even widths, of the Nyquist column along W, as the JAX real synthesis
does (it multiplies them by sin(0) and sin(πt)). ``torch.fft.irfft2`` would
leave that to the C2R transform, whose treatment of a non-Hermitian input
is not specified for cuFFT, so the inverse runs as a complex inverse over H,
those imaginary parts set to zero, then a C2R transform over W.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _real(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def rfft2_ortho(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real (..., H, W) → (re, im), each (..., H, W // 2 + 1)."""
    y = torch.fft.rfft2(_real(x), norm="ortho")
    return y.real, y.imag


def irfft2_ortho(y_re: torch.Tensor, y_im: torch.Tensor,
                 s: Tuple[int, int]) -> torch.Tensor:
    """(re, im) (..., H, W // 2 + 1) → real (..., H, W) with (H, W) = s."""
    h, w = s
    if y_re.shape[-2] != h or y_re.shape[-1] != w // 2 + 1:
        raise ValueError(f"irfft2_ortho: spectrum {tuple(y_re.shape)} does "
                         f"not fit an output of {s}")
    z = torch.fft.ifft(torch.complex(_real(y_re), _real(y_im)), dim=-2,
                       norm="ortho")
    z.imag[..., 0] = 0
    if w % 2 == 0:
        z.imag[..., -1] = 0
    return torch.fft.irfft(z, n=w, dim=-1, norm="ortho")

"""Packed-complex spectrum in the reference's ``four1`` layout.

The reference computes its spectrum with an in-place radix-2 complex
FFT over the PCM buffer *viewed as interleaved (re, im) pairs* (the
Numerical-Recipes ``four1`` packing, glava/render.c:783-847): for an
``n``-float buffer it transforms the ``n/2`` complex values
``c[k] = x[2k] + i*x[2k+1]`` in natural bin order, then takes
``log(|v| + 1)/3`` of every float (real and imaginary components
*separately*) and applies a linear-in-frequency boost.

This module is the plain torch version of that transform: the fused
CUDA kernel (``ops/fused.py``) computes the same values and is held
against it. Both run the FFT in float64 and round its output to
float32: float32 FFT rounding, amplified by the boost, would otherwise
exceed the 2e-5 spectrum tolerance between two correct implementations
from n = 4096 up.
"""

from __future__ import annotations

import torch


def packed_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., n) real float32 -> (re, im) float32 planes (..., n/2): the
    forward DFT of the packed pairs, natural bin order, computed in
    float64."""
    n = x.shape[-1]
    if n < 4 or n & (n - 1):
        raise ValueError(f"packed fft length must be a power of two >= 4, got {n}")
    spec = torch.fft.fft(
        torch.complex(x[..., 0::2].double(), x[..., 1::2].double()), dim=-1)
    return spec.real.float(), spec.imag.float()


def interleave(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(..., m), (..., m) -> (..., 2m) interleaved [re0, im0, re1, ...]."""
    return torch.stack([re, im], dim=-1).reshape(*re.shape[:-1], 2 * re.shape[-1])


def boost(n: int, fft_scale, fft_cutoff, device=None) -> torch.Tensor:
    """``max((j/n)*fft_scale + (1 - fft_cutoff), 1)`` over the
    interleaved float index ``j`` (render.c:841-846). Per-row (B,)
    parameters give (B, n)."""
    idx = torch.arange(n, dtype=torch.float32, device=device) / n
    fft_scale = torch.as_tensor(fft_scale, dtype=torch.float32, device=device)
    fft_cutoff = torch.as_tensor(fft_cutoff, dtype=torch.float32, device=device)
    if fft_scale.ndim:
        fft_scale = fft_scale[..., None]
    if fft_cutoff.ndim:
        fft_cutoff = fft_cutoff[..., None]
    return torch.clamp_min(idx * fft_scale + (1.0 - fft_cutoff), 1.0)


def packed_spectrum(x: torch.Tensor, fft_scale, fft_cutoff) -> torch.Tensor:
    """Windowed PCM (..., n) -> reference-layout spectrum floats (..., n):
    ``log(|v| + 1)/3`` per interleaved float, times :func:`boost`.
    Windowing is NOT applied here (see ``transforms.fft_chain``)."""
    re, im = packed_planes(x)
    mag = torch.log(torch.abs(interleave(re, im)) + 1.0) / 3.0
    return mag * boost(x.shape[-1], fft_scale, fft_cutoff, x.device)

"""The pieces of the per-uniform transform chain the standard
``window, fft, gravity, avg`` chain uses (glava/render.c:660-856).

* ``fft`` — window + packed-complex FFT + ``log(|v|+1)/3`` + linear
  frequency boost (render.c:783-847); it implies gravity and average,
  which the fused update (``ops/fused.py``) carries.
* ``wrange`` — ``[-1, 1] -> [0, 1]`` (render.c:773-781).
* ``decimate`` — the ``setbufscale`` averaging (render.c:1765-1790).
"""

from __future__ import annotations

import torch

from glava_tpu_torch.ops import windows
from glava_tpu_torch.ops.fft import packed_spectrum


def fft_chain(x: torch.Tensor, fft_scale, fft_cutoff) -> torch.Tensor:
    """Reference ``transform_fft``: window + packed FFT + log-mag + boost.

    ``x``: (..., n) raw PCM floats. Returns (..., n) spectrum floats in
    the reference's interleaved re/im layout.
    """
    w = torch.as_tensor(windows.pcm_window(x.shape[-1]), device=x.device)
    return packed_spectrum(x * w, fft_scale, fft_cutoff)


def wrange(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] (render.c:773-781)."""
    return (x + 1.0) / 2.0


def decimate(x: torch.Tensor, bufscale: int) -> torch.Tensor:
    """Average every ``bufscale`` consecutive samples (no-op at 1)."""
    if bufscale <= 1:
        return x
    n = (x.shape[-1] // bufscale) * bufscale
    return x[..., :n].reshape(*x.shape[:-1], n // bufscale, bufscale).mean(dim=-1)

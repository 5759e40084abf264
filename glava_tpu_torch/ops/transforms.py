"""The per-uniform transform chain (glava/render.c:660-856), as the JAX
package's ``glava_tpu/ops/transforms.py`` writes it, on torch.

* ``fft`` — window + packed-complex FFT + ``log(|v|+1)/3`` + linear
  frequency boost (render.c:783-847); it implies gravity and average.
  The fused update (``ops/fused.py``) carries them: its kernel on the
  accel path, ``chain_update`` (unclamped on the CPU path,
  ``setaccelfft false``) on the rows' device otherwise.
* ``gravity`` — peak-hold decay ``max(state, x) - g`` (render.c:720-736).
* ``avg`` — windowed mean over the last N updates (render.c:738-771).
* ``smooth`` — log-scale neighbourhood average, sequential and in place
  (render.c:694-718): ``ops/smooth.py``.
* ``wrange`` — ``[-1, 1] -> [0, 1]`` (render.c:773-781).
* ``decimate`` — the ``setbufscale`` averaging (render.c:1765-1790).
* ``interpolate`` — keyframe blending (render.c:1792-1809).
"""

from __future__ import annotations

import numpy as np
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


def interpolate(start: torch.Tensor, end: torch.Tensor, mod) -> torch.Tensor:
    """Linear blend between audio keyframes by ``min(mod, 1)``, ``mod =
    uratio * kcounter`` (render.c:1804-1807). ``mod`` is a number, or
    one per stream (S,) against (S, ...) keyframes, on the host or a
    float32 tensor on the keyframes' device (a compiled step's static
    input); it is taken in float32, as the JAX package takes it."""
    if isinstance(mod, torch.Tensor):
        m = torch.clamp(mod, max=1.0)
    else:
        m = torch.as_tensor(
            np.minimum(np.asarray(mod, np.float32), np.float32(1.0)),
            device=start.device)
    m = m.reshape(m.shape + (1,) * (start.ndim - m.ndim))
    return start + (end - start) * m

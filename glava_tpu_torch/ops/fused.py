"""The fused spectrum update: FFT + magnitude + gravity + average.

One audio update of every fft uniform row, in the layout of the JAX
package's ``FusedChainState`` (glava_tpu/pipeline.py:72-91):

* ``pcm``   (B, n)        raw ring snapshots (not windowed)
* ``grav``  (B, 2, m)     gravity store planes (re, im), m = n/2
* ``hist``  (B, F, 2, m)  rolling average history, a ring
* ``slot``  (B,) int32    each row's ring slot to overwrite
* ``avg``   (B, 2, m)     the age-weighted average (the texture source)

``fft_scale``, ``fft_cutoff`` and ``g`` are per-row (B,) float32
vectors; ``window`` is ``windows.pcm_window(n)`` and ``age_weights``
the averaging weights in AGE order (:func:`age_weights`), both as
tensors on the rows' device.

:func:`fused_update_plain` is the plain torch version.
:func:`fused_update` runs it for CPU tensors and launches the CUDA
kernel (``csrc/fused_update.cu``, replacing the TPU kernel
``glava_tpu/ops/pallas/fused.py:build_fused_update_inc``) for CUDA
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from glava_tpu_torch.ops import fft

# kernel launches made by fused_update (CUDA tensors only)
launches = 0

MIN_N, MAX_N = 256, 16384

_TWIDDLES: dict[tuple[int, torch.device], torch.Tensor] = {}


def age_weights(avg_weights) -> np.ndarray:
    """POSITIONAL oldest-first ``windows.avg_weights`` -> AGE order
    (age 0 = newest). The reference binds its averaging FBOs
    newest-first (render.c:2252-2256), so a ring slot's weight follows
    the age of the frame it holds: ``w_age[(slot - f) mod F]``."""
    return np.ascontiguousarray(np.asarray(avg_weights, np.float32)[::-1])


def fused_update_plain(pcm, grav, hist, slot, fft_scale, fft_cutoff, g,
                       window, age_weights):
    """Plain torch version of the fused update; returns new
    ``(grav', hist', avg)`` tensors and leaves its inputs untouched."""
    B, n = pcm.shape
    m = n // 2
    F = hist.shape[1]
    spec = fft.packed_spectrum(pcm * window, fft_scale, fft_cutoff)
    # GL_R16 per-stage clamping (render.c:512-523)
    spec = torch.clamp(spec, 0.0, 1.0).reshape(B, m, 2).transpose(1, 2)
    grav = torch.clamp(torch.maximum(grav, spec) - g[:, None, None], 0.0, 1.0)
    slot = torch.remainder(slot.long(), F)
    hist = hist.clone()
    hist[torch.arange(B, device=pcm.device), slot] = grav
    return grav, hist, ring_average(hist, slot, age_weights)


def ring_average(hist, newest, age_weights):
    """``clip(sum_f w_age[(newest - f) mod F] * hist[:, f], 0, 1)``,
    summed in f order: the texture source of a ring whose newest frame
    sits in slot ``newest`` (B,)."""
    F = hist.shape[1]
    ages = torch.remainder(
        newest.long()[:, None] - torch.arange(F, device=hist.device), F)
    w = age_weights[ages]                                   # (B, F)
    acc = torch.zeros_like(hist[:, 0])
    for f in range(F):
        acc = acc + w[:, f, None, None] * hist[:, f]
    return torch.clamp(acc, 0.0, 1.0)


def fused_update(pcm, grav, hist, slot, fft_scale, fft_cutoff, g,
                 window, age_weights):
    """The fused update, IN PLACE on ``grav`` and ``hist``; returns
    ``(grav, hist, avg)`` with ``avg`` newly allocated.

    CPU tensors take :func:`fused_update_plain`. CUDA tensors launch
    the kernel, or raise when the inputs are not what it takes."""
    if pcm.device.type == "cpu":
        g2, h2, avg = fused_update_plain(pcm, grav, hist, slot, fft_scale,
                                         fft_cutoff, g, window, age_weights)
        grav.copy_(g2)
        hist.copy_(h2)
        return grav, hist, avg
    if pcm.device.type != "cuda":
        raise ValueError(f"fused_update: unsupported device {pcm.device}")
    return _launch(pcm, grav, hist, slot, fft_scale, fft_cutoff, g,
                   window, age_weights)


def _twiddles(m: int, device: torch.device) -> torch.Tensor:
    """(m/2, 2) float64 table of exp(-2 pi i j / m)."""
    key = (m, device)
    if key not in _TWIDDLES:
        ang = -2.0 * np.pi * np.arange(m // 2, dtype=np.float64) / m
        tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
        _TWIDDLES[key] = torch.as_tensor(tw, device=device)
    return _TWIDDLES[key]


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"fused_update: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"fused_update: {name} is on {t.device}, pcm on {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_update: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_update: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"fused_update: {name} must be contiguous")


def _launch(pcm, grav, hist, slot, fft_scale, fft_cutoff, g, window,
            age_weights):
    global launches
    if pcm.ndim != 2 or hist.ndim != 4:
        raise ValueError("fused_update: pcm must be (B, n), hist (B, F, 2, m)")
    B, n = pcm.shape
    F = hist.shape[1]
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"fused_update: n must be a power of two in "
                         f"[{MIN_N}, {MAX_N}], got {n}")
    if B < 1 or F < 1:
        raise ValueError("fused_update: needs at least one row and one frame")
    m = n // 2
    dev = pcm.device
    f32 = torch.float32
    _check("pcm", pcm, (B, n), f32, dev)
    _check("grav", grav, (B, 2, m), f32, dev)
    _check("hist", hist, (B, F, 2, m), f32, dev)
    _check("slot", slot, (B,), torch.int32, dev)
    for name, t in (("fft_scale", fft_scale), ("fft_cutoff", fft_cutoff),
                    ("g", g)):
        _check(name, t, (B,), f32, dev)
    _check("window", window, (n,), f32, dev)
    _check("age_weights", age_weights, (F,), f32, dev)

    from glava_tpu_torch.ops import _build

    fn = _build.load("fused_update").lib.glava_fused_update
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tw = _twiddles(m, dev)
    avg = torch.empty((B, 2, m), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pcm.data_ptr(), window.data_ptr(), tw.data_ptr(),
                 age_weights.data_ptr(), slot.data_ptr(), fft_scale.data_ptr(),
                 fft_cutoff.data_ptr(), g.data_ptr(), grav.data_ptr(),
                 hist.data_ptr(), avg.data_ptr(), B, n, F, stream)
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error {err}")
    launches += 1
    return grav, hist, avg

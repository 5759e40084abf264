"""Log-mel spectrogram frontend on the port's packed FFT.

The port of ``glava_tpu/models/mel.py`` (BASELINE.json config 5):
Whisper-style 80-bin log-mel features from the same packed-pair complex
FFT the visualizer uses (``ops.fft.packed_planes``, float64 inside,
float32 out), recombined into the real FFT with the standard split
step, then projected onto a triangular mel filterbank with one float32
matrix product (``torch.matmul``; TF32 stays off, ``device.resolve``).
The JAX package has no Pallas kernel here (its FFT is matrix products),
so there is none to port: this is plain torch on the frames' device.

No reference equivalent (GLava has no ML frontend); parameters follow
the Whisper preprocessing convention (25 ms window / 10 ms hop at
16 kHz, 80 mels, log10 clamp + dynamic-range normalization).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from glava_tpu_torch.device import resolve
from glava_tpu_torch.ops.fft import packed_planes


def rfft_via_packed(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Real FFT of (..., n) float32 via the packed-pair complex FFT.

    Returns (re, im) of bins 0..n/2 inclusive (n/2+1 bins). Uses the
    split/recombination identity: with C = FFT(x_even + i*x_odd) of
    length m = n/2,

        X[k] = (C[k] + conj(C[m-k]))/2 - (i/2) e^{-2pi i k/n}
               (C[k] - conj(C[m-k]))
    """
    n = x.shape[-1]
    m = n // 2
    cr, ci = packed_planes(x.to(torch.float32))
    # index m-k (with C[m] == C[0])
    idx = torch.as_tensor((-np.arange(m + 1)) % m, device=x.device)
    cr_k = torch.cat([cr, cr[..., :1]], dim=-1)
    ci_k = torch.cat([ci, ci[..., :1]], dim=-1)
    cr_mk = cr[..., idx]
    ci_mk = ci[..., idx]
    # even part E = (C[k] + conj(C[m-k]))/2 ; odd part O = (C[k] - conj)/2i
    er = (cr_k + cr_mk) / 2.0
    ei = (ci_k - ci_mk) / 2.0
    orr = (ci_k + ci_mk) / 2.0
    oi = -(cr_k - cr_mk) / 2.0
    tw_r, tw_i = _twiddles(n, x.device)
    re = er + orr * tw_r - oi * tw_i
    im = ei + orr * tw_i + oi * tw_r
    return re, im


_TW: dict[tuple[int, torch.device], tuple[torch.Tensor, torch.Tensor]] = {}


def _twiddles(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin of ``-2 pi k / n`` for k <= n/2, on ``device``."""
    key = (n, torch.device(device))
    if key not in _TW:
        ang = -2.0 * np.pi * np.arange(n // 2 + 1) / n
        _TW[key] = (torch.as_tensor(np.cos(ang).astype(np.float32), device=device),
                    torch.as_tensor(np.sin(ang).astype(np.float32), device=device))
    return _TW[key]


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=None)
def mel_filterbank(
    n_fft: int, n_mels: int = 80, sample_rate: int = 16000,
    fmin: float = 0.0, fmax: float | None = None,
) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) triangular filterbank (HTK mel scale)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.arange(n_bins) * sample_rate / n_fft
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, n_bins), dtype=np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


@lru_cache(maxsize=None)
def _hann(win_length: int, n_fft: int) -> np.ndarray:
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    out = np.zeros(n_fft, dtype=np.float32)
    off = (n_fft - win_length) // 2
    out[off : off + win_length] = w
    return out


def log_mel(
    frames,
    *,
    n_mels: int = 80,
    sample_rate: int = 16000,
    win_length: int = 400,
    normalize: bool = True,
    device="cuda",
) -> torch.Tensor:
    """(..., n_fft) centered PCM frames -> (..., n_mels) float32 log-mel
    features on the frames' device (a tensor's own; a host array goes
    to ``device``, the card unless the caller asks for the CPU).

    ``n_fft`` is the trailing frame length (power of two; pad the
    Whisper 400-sample window into 512). Whisper-style post:
    log10(max(mel, 1e-10)), clamp to max-8, (x+4)/4 when ``normalize``.
    """
    if isinstance(frames, torch.Tensor):
        dev = resolve(frames.device)
    else:
        dev = resolve(device)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    n_fft = frames.shape[-1]
    window = torch.as_tensor(_hann(win_length, n_fft), device=dev)
    re, im = rfft_via_packed(frames * window)
    power = re * re + im * im
    fb = torch.as_tensor(mel_filterbank(n_fft, n_mels, sample_rate), device=dev)
    mel = torch.matmul(power, fb.T)
    logmel = torch.log10(torch.clamp_min(mel, 1e-10))
    if normalize:
        # global dynamic-range clamp (Whisper convention)
        logmel = torch.maximum(logmel, torch.max(logmel) - 8.0)
        logmel = (logmel + 4.0) / 4.0
    return logmel


def frame_track(pcm: np.ndarray, n_fft: int = 512, hop: int = 160) -> np.ndarray:
    """Host helper: center-padded framing of a PCM track into
    (n_frames, n_fft) windows."""
    pad = n_fft // 2
    x = np.pad(np.asarray(pcm, np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    out = np.stack([x[i * hop : i * hop + n_fft] for i in range(n_frames)])
    return out.astype(np.float32)

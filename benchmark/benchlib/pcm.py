"""Seeded stereo PCM: each stream's capture, made once from ``--seed``.

Every stream gets its own three tones a channel, a slow amplitude
modulation and a Gaussian noise floor, each with its own phase. The
parameters come from numpy's generator seeded by (seed, stream); the
samples are computed on the device in a few large calls (float64
phases, float32 samples) and the noise drawn from a ``torch.Generator``
seeded by the seed. The whole run's audio is made before the program
starts, so the capture threads only slice it: sample ``j`` of a stream
is ``pcm[s, :, j % N]``.

A ring snapshot taken after ``n`` pushes of ``hop`` samples holds the
``bufsize`` samples ending at ``n * hop`` (zeros before the first),
which is how the reference rebuilds the exact input every frame of the
loop took.
"""

from __future__ import annotations

import numpy as np
import torch

TONES = 3
_MASK = (1 << 63) - 1


def _stream_params(seed: int, s: int) -> np.ndarray:
    """(2 channels, 12) float64: three tones' (frequency, amplitude,
    phase), then the modulation's (rate, depth, phase) and the noise
    floor's amplitude, drawn for stream ``s``."""
    rng = np.random.default_rng([seed & _MASK, s])
    out = np.empty((2, 3 * TONES + 4), np.float64)
    for c in range(2):
        f = np.exp(rng.uniform(np.log(50.0), np.log(6000.0), TONES))
        a = rng.uniform(0.05, 0.25, TONES)
        ph = rng.uniform(0.0, 2 * np.pi, TONES)
        am = (rng.uniform(0.1, 0.8), rng.uniform(0.2, 0.7),
              rng.uniform(0.0, 2 * np.pi))
        noise = rng.uniform(0.003, 0.03)
        out[c] = np.concatenate([f, a, ph, am, [noise]])
    return out


def make_pcm(seed: int, streams: int, samples: int, rate: int,
             device="cpu", chunk: int = 16) -> np.ndarray:
    """The (streams, 2, samples) float32 capture of every stream, made on
    ``device`` in chunks of ``chunk`` streams and returned on the host."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed & _MASK)
    out = np.empty((streams, 2, samples), np.float32)
    t = torch.arange(samples, dtype=torch.float64, device=dev) / rate
    for s0 in range(0, streams, chunk):
        s1 = min(s0 + chunk, streams)
        p = torch.as_tensor(np.stack([_stream_params(seed, s)
                                      for s in range(s0, s1)]), device=dev)
        f, a, ph = (p[..., k * TONES:(k + 1) * TONES, None] for k in range(3))
        am_rate, am_depth, am_ph, noise = (p[..., 3 * TONES + k, None]
                                           for k in range(4))
        tones = (a * torch.sin(2 * np.pi * f * t + ph)).sum(dim=-2)
        am = 1.0 - am_depth * 0.5 * (1.0 + torch.sin(
            2 * np.pi * am_rate * t + am_ph))
        x = tones * am + noise * torch.randn(
            (s1 - s0, 2, samples), generator=gen, dtype=torch.float64,
            device=dev)
        out[s0:s1] = torch.clamp(x, -1.0, 1.0).float().cpu().numpy()
    return out


def last_samples(pcm: np.ndarray, s: int, pushes: np.ndarray,
                 hop: int) -> np.ndarray:
    """(len(pushes), 2) the newest sample of each channel in the ring
    after each count of pushes (0 before the first push)."""
    pushes = np.asarray(pushes, np.int64)
    idx = (pushes * hop - 1) % pcm.shape[-1]
    out = pcm[s][:, idx].T.copy()
    out[pushes <= 0] = 0.0
    return out

"""The accel-path spectrum update and the default smooth pass, plainly.

After ``tests/oracles.py`` (GLava's ``render.c:660-848`` and
``util/smooth.glsl``, ``average_pass.frag``) with the accel path's
GL_R16 clamps (``render.c:512-523``): for each row (one stream's
channel) and each new ring snapshot ``x``

    spec = clamp(log(|FFT_packed(x * window)| + 1) / 3 * boost, 0, 1)
    grav = clamp(max(grav, spec) - g, 0, 1)
    hist[count mod F] = grav;  count += 1
    avg  = clamp(sum_a w_age[a] * hist[newest - a], 0, 1)

and the texture a module samples is ``clamp(M @ avg, 0, 1)``, ``M`` the
smooth pass's resample (``smooth_audio`` of every texel). The window,
like the PCM, is float32 as the configuration states; everything after
the product is computed in float64. ``low=True`` computes the same in
the precision one step below what the configuration states: the FFT
in float32 (not float64) and the resample in TF32 (not float32 with
TF32 off) -- the check's control.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from reference.common import TWOPI


def pcm_window(n: int) -> np.ndarray:
    """render.c:794 ``window(i, sz - 1)`` as compiled (the macro's ``- 1``
    is a phase shift on the quotient), in float32."""
    i = np.arange(n, dtype=np.float64)
    return (0.53836 - 0.46164 * np.cos(TWOPI * i / n - 1.0)).astype(np.float32)


def age_weights(frames: int, windowed: bool) -> np.ndarray:
    """``average_pass.frag`` weights by age (0 = newest), over ``frames``:
    the shifted window curve, flat at 2 frames or unwindowed."""
    a = np.arange(frames, dtype=np.float64)
    if windowed and frames != 2:
        w = 0.53836 - 0.46164 * np.cos(TWOPI * a / frames - 1.0)
    else:
        w = np.ones(frames)
    return w / frames


def smooth_matrix(sz: int, factor: float, sample_range: float = 0.9,
                  sample_scale: float = 8.0) -> np.ndarray:
    """(sz, sz) float64: row i is ``smooth_audio(tex, i / sz)`` in average
    mode with the sinusoidal weight (smooth.glsl:23-64): texels
    ``round(s)`` for ``s = smin, smin + 1, .. <= smax``, weighted
    ``0.5 sin(pi x - pi/2) + 0.5`` of ``clamp((m - |rm - s|) / m, 0, 1)``,
    normalized."""
    def scale(x):
        return -math.log(-(sample_range * x) + 1.0) / sample_scale

    M = np.zeros((sz, sz), np.float64)
    for i in range(sz):
        idx = i / sz
        smin = scale(min(max(idx - factor, 0.0), 1.0)) * sz
        smax = scale(min(max(idx + factor, 0.0), 1.0)) * sz
        m = (smax - smin) / 2.0
        rm = smin + m
        count = int(math.floor(smax - smin)) + 1 if smax >= smin else 0
        s = smin + np.arange(count, dtype=np.float64)
        x = np.clip((m - np.abs(rm - s)) / m, 0.0, 1.0) if m > 0 \
            else np.ones_like(s)
        w = 0.5 * np.sin(np.pi * x - np.pi / 2) + 0.5
        if w.sum() <= 0:
            continue
        np.add.at(M[i], np.clip(np.round(s), 0, sz - 1).astype(np.int64),
                  w / w.sum())
    return M


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class Spectra:
    """The update of ``rows`` rows replayed one snapshot at a time, and
    their textures. ``dsp``: the configuration's ``dsp`` block."""

    def __init__(self, rows: int, dsp: dict, device, low: bool = False):
        self.low = low
        self.dtype = torch.float32 if low else torch.float64
        self.cdtype = torch.complex64 if low else torch.complex128
        n = int(dsp["bufsize"])
        self.n, self.F = n, int(dsp["avg_frames"])
        dev = self.device = torch.device(device)
        self.window = torch.as_tensor(pcm_window(n), device=dev)
        j = torch.arange(n, dtype=torch.float64, device=dev) / n
        self.boost = torch.clamp_min(
            j * dsp["fft_scale"] + (1.0 - dsp["fft_cutoff"]), 1.0
        ).to(self.dtype)
        self.w_age = torch.as_tensor(
            age_weights(self.F, bool(dsp["avg_window"])), device=dev,
            dtype=self.dtype)
        self.M = torch.as_tensor(
            smooth_matrix(n, dsp["smooth_factor"]), device=dev,
            dtype=self.dtype)
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=dev)  # noqa: E731
        self.grav, self.avg = z(rows, n), z(rows, n)
        self.hist = z(rows, self.F, n)
        self.count = torch.zeros(rows, dtype=torch.int64, device=dev)

    def update(self, rows: torch.Tensor, pcm: torch.Tensor,
               g: torch.Tensor) -> None:
        """One update of ``rows`` (long) from their (r, n) float32
        snapshots, each row's gravity step ``g`` (r,)."""
        x = (pcm.to(self.device, torch.float32) * self.window).to(self.dtype)
        spec = torch.fft.fft(torch.complex(x[:, 0::2], x[:, 1::2]).to(
            self.cdtype), dim=-1)
        v = torch.stack([spec.real, spec.imag], dim=-1).reshape(x.shape)
        mag = torch.clamp(torch.log(torch.abs(v) + 1.0) / 3.0 * self.boost,
                          0.0, 1.0)
        g = g.to(self.device, self.dtype)[:, None]
        grav = torch.clamp(torch.maximum(self.grav[rows], mag) - g, 0.0, 1.0)
        slot = self.count[rows] % self.F
        self.hist[rows, slot] = grav
        ages = (slot[:, None] - torch.arange(self.F, device=self.device)) \
            % self.F                                        # (r, F) slot of age a
        hist = self.hist[rows]
        acc = (self.w_age[None, :, None]
               * hist[torch.arange(len(rows), device=self.device)[:, None],
                      ages]).sum(dim=1)
        self.avg[rows] = torch.clamp(acc, 0.0, 1.0)
        self.grav[rows] = grav
        self.count[rows] += 1

    def textures(self, rows: torch.Tensor) -> torch.Tensor:
        """(r, n) float32 textures of ``rows``: the smooth pass on their
        averaged spectra."""
        with _tf32(self.low):
            tex = self.avg[rows] @ self.M.T
        return torch.clamp(tex, 0.0, 1.0).float()

    @staticmethod
    def planes(x: torch.Tensor) -> torch.Tensor:
        """(r, n) interleaved [re0, im0, re1, ..] -> (r, 2, n/2) planes,
        the program's state layout."""
        return x.reshape(x.shape[0], -1, 2).transpose(1, 2)

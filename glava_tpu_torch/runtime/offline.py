"""Offline (faster-than-realtime) rendering: WAV in, frame stream out.

With compute decoupled from presentation, a recorded track renders as
fast as the device allows: the exact realtime schedule — hop-cadence
ring updates (fifo.c:91-92) and nominal-UPS gravity decay
(render.c:728) — is precomputed on the host, then frames run one by one
through the compiled step (:meth:`Renderer.jit_step`, a CUDA graph a
branch replayed a frame; the JAX package scans a chunk of 64 frames in
one executable), each copied to the host while the next one renders
(``FrameFetch``), whatever the module; a GLSL shader module's fuel
count is read once, at the end. Offline output is deterministic for a
given track and config.

    glava-tpu-torch --offline -a wav -r 'setsource "track.wav"' \
                    --sink y4m:out.y4m
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from glava_tpu_torch.config import glsl_shader
from glava_tpu_torch.config.loader import LoadedConfig
from glava_tpu_torch.pipeline import frame_windows
from glava_tpu_torch.renderer import Renderer
from glava_tpu_torch.runtime.audio.wav import read_wav
from glava_tpu_torch.runtime.engine import FrameFetch
from glava_tpu_torch.runtime.sinks import FrameSink


def _schedule(n_samples: int, rate: int, hop: int, fps: float,
              timecycle: float):
    """Per-frame inputs mirroring the engine loop's bookkeeping."""
    ups = rate / hop
    n_frames = max(int(n_samples / rate * fps), 1)
    t = np.arange(n_frames) / fps
    # window j holds samples ending at (j+1)*hop (frame_windows): the
    # newest complete window at time t
    widx = np.floor(t * rate / hop).astype(np.int64) - 1
    widx = np.clip(widx, 0, max(n_samples // hop - 1, 0))
    modified = np.empty(n_frames, bool)
    modified[0] = True
    modified[1:] = widx[1:] != widx[:-1]
    # kcounter/uratio interpolation (engine.py run(); render.c:1792-1809)
    kcounter = np.zeros(n_frames, np.int64)
    for k in range(1, n_frames):
        kcounter[k] = 0 if modified[k] else kcounter[k - 1] + 1
    uratio = min(ups / max(fps, 1.0), 1.0)
    interp = np.minimum(uratio * np.maximum(kcounter, 1), 1.0)
    return dict(
        widx=widx,
        modified=modified,
        interp=interp.astype(np.float32),
        time=(t % timecycle).astype(np.float32),
        ups=ups,
        n_frames=n_frames,
    )


def render_wav(loaded: LoadedConfig, wav_path: str, sink: FrameSink,
               fps: float = 60.0, screen: tuple[int, int] | None = None,
               verbose: bool = False, device="cuda") -> int:
    """Render the whole track through ``sink``; returns frames written."""
    cfg = loaded.cfg
    left, right, rate = read_wav(wav_path)
    if rate != cfg.sample_rate:
        n = int(len(left) * cfg.sample_rate / rate)
        xs = np.linspace(0, len(left) - 1, n)
        left = np.interp(xs, np.arange(len(left)), left).astype(np.float32)
        right = np.interp(xs, np.arange(len(right)), right).astype(np.float32)
        rate = cfg.sample_rate
    hop = max(cfg.samplesize // 4, 1)
    wl = frame_windows(left, cfg.bufsize, hop)
    wr = frame_windows(right, cfg.bufsize, hop)
    if len(wl) == 0:
        # track shorter than one hop: render it as one silence-padded
        # window (the realtime ring would hold mostly zeros too)
        wl = np.zeros((1, cfg.bufsize), np.float32)
        wr = np.zeros((1, cfg.bufsize), np.float32)
        wl[0, -len(left):] = left
        wr[0, -len(right):] = right
    sched = _schedule(len(left), rate, hop, fps, cfg.timecycle)
    g = float(np.float32(cfg.gravity_step / sched["ups"]))

    r = Renderer(loaded, screen=screen, device=device)
    step = r.jit_step(quantize=True)
    state = r.init_state()
    # one frame in flight: its pinned copy overlaps the next step
    fetch = FrameFetch(r.device, 1)
    written = 0
    t0 = _time.monotonic()
    for k in range(sched["n_frames"]):
        i = sched["widx"][k]
        audio = torch.from_numpy(np.stack([wl[i], wr[i]]))
        state, frame = step(state, audio, bool(sched["modified"][k]),
                            float(sched["time"][k]),
                            float(sched["interp"][k]), g)
        for host, t in fetch.push(frame, float(sched["time"][k])):
            sink.submit(host, t)
        written += 1
    for host, t in fetch.drain():
        sink.submit(host, t)
    if r.module.kind == "shader":
        glsl_shader.fuel_check(r.device, force=True)
    if verbose:
        dt = _time.monotonic() - t0
        print(f"offline: {written} frames in {dt:.2f}s "
              f"({written / max(dt, 1e-9):.0f} fps, "
              f"{written / fps / max(dt, 1e-9):.1f}x realtime)")
    return written

"""Profiling and debug instrumentation, on torch.

The port of ``glava_tpu/utils/profiling.py``. The per-second FPS/UPS
line (render.c:2376-2399) lives in the engine loop; here is what the
reference lacks: a device trace (``torch.profiler``, written as a
Chrome trace) and named spans in it, and a NaN guard playing the role
of the debug GL error-on-every-call hook (render.c:598-640).

The JAX package's guard is ``jax_debug_nans``, which checks every jitted
computation. Torch runs eagerly and has no such switch, so the port's
guard is an explicit check of each frame's planes: once
:func:`enable_nan_guard` is called, the renderer's steps pass their
output planes through :func:`check_nans`, which raises on a NaN. Each
check reads one flag back from the device, a synchronisation a frame,
so it is off unless asked for.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

_NAN_GUARD = False


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace of the enclosed block into
    ``logdir`` as a Chrome trace (``chrome://tracing``, Perfetto)::

        with profiling.trace("/tmp/glava-trace"):
            engine.run(max_seconds=5)
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """Named span (shows up in :func:`trace`'s output)."""
    return torch.profiler.record_function(name)


def enable_nan_guard(on: bool = True) -> None:
    """Fail fast on NaNs in any frame the renderer produces (the
    sanitizer analogue of the reference's per-call GL error hook)."""
    global _NAN_GUARD
    _NAN_GUARD = bool(on)


def nan_guard_enabled() -> bool:
    return _NAN_GUARD


def check_nans(planes, what: str = "frame") -> None:
    """Raise ``FloatingPointError`` when a channel plane holds a NaN.
    Tensor planes are checked on their device, with one read back."""
    flags = []
    for p in planes:
        if isinstance(p, torch.Tensor):
            flags.append(torch.isnan(p).any())
        elif np.isnan(np.asarray(p, np.float32)).any():
            raise FloatingPointError(f"NaN in {what}")
    if flags and bool(torch.stack(flags).any()):
        raise FloatingPointError(f"NaN in {what}")


@dataclass
class RateCounter:
    """FPS/UPS-style rolling per-second rate accounting."""

    window: float = 1.0
    _mark: float = field(default_factory=time.monotonic)
    _count: int = 0
    rate: float = 0.0

    def tick(self, n: int = 1) -> bool:
        """Count an event; returns True when a window completed."""
        self._count += n
        now = time.monotonic()
        span = now - self._mark
        if span >= self.window:
            self.rate = self._count / span
            self._count = 0
            self._mark = now
            return True
        return False


@dataclass
class LatencyTracker:
    """Rolling latency percentiles (p50 PCM->frame, BASELINE.md)."""

    capacity: int = 240
    samples: list = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)
        if len(self.samples) > self.capacity:
            self.samples.pop(0)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        i = min(int(len(s) * q / 100.0), len(s) - 1)
        return s[i]

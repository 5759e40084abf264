"""The benchmark's side of the live loop: the capture threads that feed
the program, the sinks that take its frames, and the records both keep.

* :class:`PCMBackend` is an audio backend registered in the program's
  table (``glava_tpu_torch.runtime.audio.register``): it pushes one hop
  (``samplesize / 4`` samples) of each stream's seeded PCM at a time at
  the sample rate's pace, as a capture thread does, from one feeder
  thread for all streams, and counts each stream's pushes.
* :class:`StampSink` is a ``FrameSink`` that stamps each hand-off, keeps
  the latest frame and copies the frames sampled for the check. It
  writes nothing to disk; ``close`` does nothing, so a sink outlives the
  warm-up's run.
* :class:`Recorder` wraps each stream's ``AudioData.snapshot`` (the
  snapshot's time and which hops it holds are inputs of the check and
  of ``frame_p95_ms``), the engine's step (its gravity step, time and
  the loop's measured update rate) and the frame hand-off, in every
  run: their spans are what the host-side per-layer metrics read.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from glava_tpu_torch.runtime import audio as audio_mod
from glava_tpu_torch.runtime.sinks import FrameSink

BACKEND = "benchpcm"
perf = time.perf_counter


class PCMBackend(audio_mod.AudioBackend):
    """One stream's capture over its rows of the seeded PCM. The stream
    is the ``source`` of its AudioData (``bench:<i>``; anything else is
    stream 0). Pushes continue where the last run stopped.

    Every stream's thread (the program spawns one a stream) joins one
    feeder: the first of a run pushes for all of them and the others
    return, so the load comes from one thread however many streams are
    served. Each stream keeps its own cadence, a hop every ``hop /
    rate`` seconds at a phase of its own (spread by the golden ratio);
    the feeder sleeps until the next hop is due, at least ``TICK``
    seconds, and pushes each hop that is due. With ``CORE`` set the
    feeder runs on that CPU core alone."""

    name = BACKEND
    pcm: np.ndarray | None = None       # (S, 2, N), set by :func:`install`
    TICK = 0.001
    CORE: int | None = None
    _lock = threading.Lock()
    _members: dict = {}                 # stream -> (backend, AudioData)
    _feeding = False

    def __init__(self):
        self.count = 0
        self.stream = 0

    def init(self, audio) -> None:
        src = audio.source or ""
        self.stream = int(src.split(":", 1)[1]) if src.startswith("bench:") else 0

    def entry(self, audio) -> None:
        cls = PCMBackend
        with cls._lock:
            cls._members[self.stream] = (self, audio)
            if cls._feeding:
                return
            cls._feeding = True
        try:
            self._feed()
        finally:
            with cls._lock:
                cls._feeding = False

    def push_next(self, audio) -> None:
        rows = self.pcm[self.stream]
        N, hop = rows.shape[-1], audio.hop
        a = (self.count * hop) % N
        if a + hop <= N:
            left, right = rows[0, a:a + hop], rows[1, a:a + hop]
        else:
            idx = np.arange(a, a + hop) % N
            left, right = rows[0, idx], rows[1, idx]
        audio.push(left, right)
        self.count += 1

    @classmethod
    def _feed(cls) -> None:
        if cls.CORE is not None:
            os.sched_setaffinity(0, {cls.CORE})
        due: dict = {}
        start = time.monotonic()
        while True:
            with cls._lock:
                live = [m for m in cls._members.values()
                        if not m[1].terminate]
            if not live:
                return
            now = time.monotonic()
            nxt = float("inf")
            for be, ad in live:
                period = ad.hop / ad.rate
                t = due.get(be.stream)
                if t is None:
                    t = start + (be.stream * 0.6180339887498949) % 1.0 * period
                while t <= now:
                    be.push_next(ad)
                    t += period
                due[be.stream] = t
                nxt = min(nxt, t)
            delay = max(nxt, now + cls.TICK) - time.monotonic()
            if delay > 0:
                time.sleep(delay)


def install(pcm: np.ndarray, core: int | None = None) -> None:
    """Register the backend over ``pcm``, its feeder on ``core``; the
    program's lookup makes one instance a stream."""
    PCMBackend.pcm = pcm
    PCMBackend.CORE = core
    PCMBackend._members = {}
    audio_mod.register(BACKEND)(PCMBackend)


class StampSink(FrameSink):
    """Counts and stamps hand-offs; copies the frame handed off first at
    or after each of ``sample_at`` (host-clock times, set before the
    window; times that pass within one frame share its copy)."""

    name = "stamp"

    def __init__(self):
        self.stamps: list[float] = []
        self.sample_at: list[float] = []
        self.samples: list = []         # (frame index, (H, W, 4) copy)
        self.met = 0                    # times of sample_at reached
        self._latest = None

    def submit(self, frame, time_s) -> None:
        now = perf()
        self.stamps.append(now)
        self._latest = frame
        if self.sample_at and now >= self.sample_at[0]:
            while self.sample_at and now >= self.sample_at[0]:
                self.sample_at.pop(0)
                self.met += 1
            self.samples.append((len(self.stamps) - 1, np.array(frame)))

    def latest(self):
        return self._latest


class Recorder:
    """Records of ``S`` streams, of the loop's steps and hand-offs, and
    of each run of the loop."""

    def __init__(self, S: int):
        # (t0, t1, pushes before, pushes after, newest L, newest R, mod)
        self.snaps = [[] for _ in range(S)]
        # (t0, t1, gravity, time, the loop's measured update rate: the
        # object itself, a new one after each of its once-a-second ticks)
        self.steps: list = []
        self.fetches: list = []               # (t0, t1)
        self.runs: list = []                  # (first step, host time of the call)
        self.on_step = None                   # called before each step (tracing)

    def begin_run(self) -> None:
        """Mark the start of a run of the loop (its dynamics start anew)."""
        self.runs.append((len(self.steps), perf()))

    def wrap_snapshot(self, s: int, audio, backend) -> None:
        orig = audio.snapshot
        rec = self.snaps[s]

        def snapshot():
            c0 = backend.count
            t0 = perf()
            buf, mod = orig()
            rec.append((t0, perf(), c0, backend.count, buf[0, -1], buf[1, -1],
                        mod))
            return buf, mod

        audio.snapshot = snapshot

    def wrap_step(self, owner, gravity_arg: int, time_arg: int) -> None:
        """Wrap ``owner._step``; its positional arguments ``gravity_arg``
        and ``time_arg`` are the gravity step and the frame's time, and
        ``owner.ups`` the loop's measured update rate."""
        orig = owner._step
        steps = self.steps

        def step(*args):
            if self.on_step is not None:
                self.on_step()
            t0 = perf()
            out = orig(*args)
            steps.append((t0, perf(), args[gravity_arg], args[time_arg],
                          owner.ups))
            return out

        owner._step = step

    def span(self, fn, into: list):
        """``fn`` wrapped to append its (start, end) to ``into``."""
        def wrapped(*args, **kwargs):
            t0 = perf()
            out = fn(*args, **kwargs)
            into.append((t0, perf()))
            return out

        return wrapped

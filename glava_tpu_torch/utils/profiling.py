"""Profiling and debug instrumentation, on torch.

The port of ``glava_tpu/utils/profiling.py``. The per-second FPS/UPS
line (render.c:2376-2399) lives in the engine loop; here is what the
reference lacks: a device trace (``torch.profiler``, written as a
Chrome trace), the program's own spans beside it, and a NaN guard
playing the role of the debug GL error-on-every-call hook
(render.c:598-640).

**Spans.** The serving loops, the compiled step and the frame fetch
record where a frame's host time goes. A span is ``(kind, loop, frame,
start, end, payload)`` (:class:`Span`), start and end on
``time.perf_counter``. Each loop (an ``Engine`` or a ``FleetEngine``)
has an id of its own (:func:`new_loop`); every span of one of its
frames carries that id and the frame's number (the loop's
``frames_rendered`` when the frame began), and a span outside any
recorded frame carries ``None`` for both. Each kind lies inside its
parent in this tree::

    frame                one loop iteration (Engine._run_once, FleetEngine.run)
    ├─ snapshot          AudioData.snapshot
    ├─ step              a compiled step's call (renderer.CompiledStep,
    │  │                 parallel.batch.CompiledFleetStep, CompiledShardedStep)
    │  ├─ step.load      compiled.Step.load: packing into pinned staging and
    │  │  │              the host-to-device copy's enqueue; payload: bytes staged
    │  │  └─ step.stage_wait  the wait for a staging buffer's last copy,
    │  │                 only when it waits (never on the CPU)
    │  ├─ step.replay    the graph's replay (on the CPU: the body's eager run);
    │  │  │              payload: the graph's kernel nodes (0 on the CPU,
    │  │  │              and for a graph that holds a GLSL loop)
    │  │  └─ shader.pass one interpreted GLSL pass (render/modules/
    │  │                 glsl_module.py), on the CPU
    │  └─ step.capture   a branch's warm-up and capture
    │     └─ shader.pass each interpreted pass of both
    ├─ fetch             FrameFetch.push, drain, and ready when it hands a
    │  │                 frame out; FleetEngine.fetch's copy at once (a
    │  │                 fleet run's frames go through FrameFetch)
    │  ├─ fetch.copy     the ring copy, the pinned allocation, the copy's enqueue
    │  └─ fetch.wait     the wait for the copy (empty on the CPU); payload: 1
    │                    when the copy still ran as the wait began, else 0
    ├─ sink              the sinks' submit calls
    └─ fuel              glsl_shader.fuel_check when it reads the counters

Recording is off unless a ``torch.profiler`` session is open in the
process (``torch.autograd.profiler._is_profiler_enabled``, read through
the module at every site) or the caller is inside :func:`record`. Off,
a site costs one call that tests the two flags: :func:`begin` returns
0.0, with no clock read, no allocation and no append. On, spans go into
one store of at most :data:`MAX_SPANS`: when it is full the oldest are
dropped and counted (:func:`dropped`). The store is made when recording
first starts, and :func:`record` and :func:`trace` start a new one on
entry unless recording is on already. The spans of a ``torch.profiler``
session opened elsewhere join the store as it is, so a reader of such a
session picks its spans by their times. The recorder adds no event to any trace: it never
calls ``record_function``, so nothing of it reaches the device trace,
and :func:`trace` adds the spans to its file after the session.

The JAX package's guard is ``jax_debug_nans``, which checks every jitted
computation. Torch runs eagerly and has no such switch, so the port's
guard is an explicit check of each frame's planes: once
:func:`enable_nan_guard` is called, the renderer's steps pass their
output planes through :func:`check_nans`, which raises on a NaN. Each
check reads one flag back from the device, a synchronisation a frame,
so it is off unless asked for.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_NAN_GUARD = False

MAX_SPANS = 1 << 18
_clock = time.perf_counter


class Span(NamedTuple):
    kind: str
    loop: int | None
    frame: int | None
    start: float
    end: float
    payload: int


class _Store:
    """The spans (as plain tuples), the newest :data:`MAX_SPANS`, and the
    count of those dropped."""

    def __init__(self):
        self.spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.dropped = 0


_depth = 0          # record() blocks open
_store: _Store | None = None
_loops = itertools.count()


class _Local(threading.local):
    frame = None        # the frame this thread's loop is in: (loop, frame)


_local = _Local()


def recording() -> bool:
    """Whether spans are recorded now."""
    return _autograd_profiler._is_profiler_enabled or _depth > 0


def new_loop() -> int:
    """An id for a serving loop's spans."""
    return next(_loops)


def begin() -> float:
    """A span's start: the clock now while recording, else 0.0 (and no
    clock read). Close it with :func:`end` when it is not 0.0."""
    if _autograd_profiler._is_profiler_enabled or _depth:
        return _clock()
    return 0.0


def end(kind: str, start: float, payload: int = 0) -> None:
    """Record a span of ``kind`` from ``start`` (:func:`begin`'s) to now,
    in this thread's current frame."""
    _add(kind, start, _clock(), payload)


def frame_begin(loop: int, frame: int) -> float:
    """Start frame ``frame`` of loop ``loop``: -> its start (0.0 when not
    recording); the spans this thread records until :func:`frame_end`
    carry the frame's numbers."""
    if not (_autograd_profiler._is_profiler_enabled or _depth):
        return 0.0
    _local.frame = (loop, frame)
    return _clock()


def frame_end(loop: int, frame: int, start: float) -> None:
    """Record the frame begun by :func:`frame_begin` at ``start``."""
    _local.frame = None
    _add("frame", start, _clock(), 0, (loop, frame))


def _new_store() -> _Store:
    global _store
    _store = _Store()
    return _store


def _add(kind, start, stop, payload, where=None) -> None:
    st = _store or _new_store()
    loop, frame = where or _local.frame or (None, None)
    if len(st.spans) == MAX_SPANS:
        st.dropped += 1
    st.spans.append((kind, loop, frame, start, stop, payload))


def spans() -> list[Span]:
    """The store's spans, in the order they ended."""
    return [Span(*s) for s in _store.spans] if _store is not None else []


def dropped() -> int:
    """Spans the store dropped, oldest first, when it was full."""
    return _store.dropped if _store is not None else 0


def _session_start() -> None:
    if not recording():
        _new_store()


@contextlib.contextmanager
def record():
    """Record spans inside the block, without a profiler (operators and
    tests); :func:`spans` reads them."""
    global _depth
    _session_start()
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def _clock_offset_ns() -> int:
    """perf_counter nanoseconds minus epoch nanoseconds, now (the
    profiler stamps its events on the epoch clock)."""
    a = time.time_ns()
    p = time.perf_counter_ns()
    b = time.time_ns()
    return p - (a + b) // 2


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace of the enclosed block into
    ``logdir`` as a Chrome trace (``chrome://tracing``, Perfetto), with
    the spans recorded in it on a track of each loop's::

        with profiling.trace("/tmp/glava-trace"):
            engine.run(max_seconds=5)
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _session_start()
    offsets = []
    with profile(activities=acts) as prof:
        offsets.append(_clock_offset_ns())
        t0 = _clock()
        try:
            yield prof
        finally:
            t1 = _clock()
            offsets.append(_clock_offset_ns())
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    mine = [s for s in spans() if s.start >= t0 and s.end <= t1]
    _add_to_chrome_trace(path, mine, sum(offsets) // len(offsets))


def _add_to_chrome_trace(path: str, mine: list, offset_ns: int) -> None:
    """Write ``mine`` into the Chrome trace at ``path`` as complete
    events on its clock: the trace's times are microseconds from its
    ``baseTimeNanoseconds`` on the epoch clock, and ``offset_ns`` moves
    perf_counter onto it."""
    with open(path) as f:
        doc = json.load(f)
    base_ns = offset_ns + int(doc.get("baseTimeNanoseconds", 0))
    pid, tids = os.getpid(), {}
    events = doc.setdefault("traceEvents", [])
    for s in mine:
        loop = -1 if s.loop is None else s.loop
        tid = tids.setdefault(loop, 1_000_000 + len(tids))
        events.append({
            "ph": "X", "cat": "glava_span", "name": s.kind, "pid": pid,
            "tid": tid, "ts": (s.start * 1e9 - base_ns) / 1e3,
            "dur": (s.end - s.start) * 1e6,
            "args": {"loop": s.loop, "frame": s.frame,
                     "payload": s.payload}})
    for loop, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"glava spans, loop {loop}"}})
    with open(path, "w") as f:
        json.dump(doc, f)


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

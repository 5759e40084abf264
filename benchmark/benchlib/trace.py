"""The device trace of a traced run: torch.profiler over a stretch of the
window, read back as each card's intervals on the host's clock.

No session is open before the stretch, so the loop runs until then as
in an untraced run (a session opened in set-up slows every later frame
on the host). That leaves a CUDA graph's conditional bodies, which the
profiler misses in a graph made before the process's first session;
the cells' steps have none (PERF.md, Open questions). The stretch is
opened and closed by the loop's own thread, just before a step, so that
it holds whole frames; the devices are synchronised before it closes,
so no kernel launched inside it is lost. Kineto stamps device events on the epoch clock
(``time.time_ns``); they are moved onto ``time.perf_counter`` by the
offset between the two clocks, read beside the stretch's ends.
"""

from __future__ import annotations

import bisect
import time

import torch

from benchlib import stats

perf = time.perf_counter


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _offset() -> float:
    """perf_counter seconds minus epoch seconds, now."""
    a = time.time_ns()
    p = perf()
    b = time.time_ns()
    return p - (a + b) / 2e9


class Stretch:
    """Profiles from the first step at or after ``start`` (host clock)
    to the first at or after ``start + length``. ``hook`` is called
    before every step. ``[t0, t1]`` is the traced stretch; ``t_open``
    is when the profiler began to open."""

    def __init__(self, devices, start: float, length: float):
        self.devices = list(devices)
        self.start_at, self.length = start, length
        self.prof = None
        self.t0 = self.t1 = self.t_open = None
        self.offsets: list[float] = []

    def hook(self) -> None:
        now = perf()
        if self.prof is None and self.t0 is None and now >= self.start_at:
            self.t_open = now
            self.prof = _profile()
            self.prof.start()
            self.offsets.append(_offset())
            self.t0 = perf()
        elif self.prof is not None and now >= self.t0 + self.length:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        self.t1 = perf()
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.offsets.append(_offset())
        self.prof.stop()
        self.events = self._read()
        self.prof = None

    def _read(self) -> dict:
        """device index -> [(name, start, end)] on the host clock."""
        off = sum(self.offsets) / len(self.offsets)
        out: dict = {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns() / 1e9 + off
            out.setdefault(e.device_index(), []).append(
                (e.name(), s, s + e.duration_ns() / 1e9))
        return out

    @property
    def done(self) -> bool:
        return self.t1 is not None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def device_view(events: dict, t0: float, t1: float) -> dict:
    """Per device: busy seconds (the union of every kernel and copy in
    ``[t0, t1]``), kernel seconds, and the idle gaps."""
    out = {}
    for dev, evs in events.items():
        spans = [(s, e) for _, s, e in evs]
        out[dev] = {
            "busy": stats.union_length(spans, t0, t1),
            "kernel": sum(max(0.0, min(e, t1) - max(s, t0))
                          for n, s, e in evs if not is_copy(n)),
            "gaps": stats.gaps(spans, t0, t1),
        }
    return out


def card_time(evs, t0: float) -> float:
    """Seconds of one card's work over the operations that start at or
    after ``t0``: the larger of its compute stream's share (every kernel
    and every copy but the device-to-host ones, which run on it one after
    the other) and its device-to-host copies (a side stream's copy engine,
    which runs beside the kernels). A card kept fed turns out a frame in
    that time a frame."""
    compute = dtoh = 0.0
    for n, s, e in evs:
        if s < t0:
            continue
        if is_copy(n) and "DtoH" in n:
            dtoh += e - s
        else:
            compute += e - s
    return max(compute, dtoh)


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without ``void`` and its argument list (the first
    ``(`` outside the template arguments), at most ``limit`` long."""
    name = name.removeprefix("void ")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            name = name[:i]
            break
    return name[:limit].strip() or "(unnamed)"


def breakdown(events: dict, t0: float, t1: float, host_spans: dict) -> dict:
    """The device operations that took most time over ``[t0, t1]`` (every
    card together), and the idle time of the cards by what the host was
    doing (the span holding the gap's middle; ``loop`` outside every
    span), the mean over the cards; ten of each at most."""
    ops: dict = {}
    for evs in events.values():
        for n, s, e in evs:
            d = min(e, t1) - max(s, t0)
            if d > 0:
                ops[short_name(n)] = ops.get(short_name(n), 0.0) + d
    idle: dict = {}
    marks = sorted((s, e, name) for name, spans in host_spans.items()
                   for s, e in spans)
    starts = [m[0] for m in marks]
    for evs in events.values():
        for g0, g1 in stats.gaps([(s, e) for _, s, e in evs], t0, t1):
            mid = (g0 + g1) / 2
            i = bisect.bisect_right(starts, mid) - 1
            what = marks[i][2] if i >= 0 and marks[i][1] >= mid else "loop"
            idle[what] = idle.get(what, 0.0) + (g1 - g0) / max(len(events), 1)
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}

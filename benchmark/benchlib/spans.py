"""The program's own spans over the traced stretch.

The port records spans (``glava_tpu_torch.utils.profiling``: kind,
loop, frame, start, end, payload, on ``time.perf_counter``) while a
profiler session is open, so the traced stretch holds them, on the
clock the device events are moved onto (``benchlib.trace``). A frame
counts when its ``frame`` span lies wholly inside ``[ctx.t0, ctx.t1]``;
its child spans count with it. A program without the recorder gives
nothing, and a reader then returns ``None``.
"""

from __future__ import annotations

import bisect

from benchlib import stats


def recorded() -> list:
    """The program's spans of its newest session; [] where the program
    records none."""
    try:
        from glava_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def frames(ctx) -> dict | None:
    """(loop, frame) -> {kind: [(start, end)]} of the frames wholly
    inside the stretch; ``None`` when there is no stretch or no such
    frame."""
    if not ctx.t1 > ctx.t0:
        return None
    spans = recorded()
    out = {(s.loop, s.frame): {} for s in spans if s.kind == "frame"
           and ctx.t0 <= s.start and s.end <= ctx.t1}
    if not out:
        return None
    for s in spans:
        kinds = out.get((s.loop, s.frame))
        if kinds is not None:
            kinds.setdefault(s.kind, []).append((s.start, s.end))
    return out


def per_frame_ms(ctx, kind: str) -> float | None:
    """Milliseconds of ``kind`` spans a frame of the stretch."""
    fr = frames(ctx)
    if fr is None:
        return None
    total = sum(e - s for kinds in fr.values() for s, e in kinds.get(kind, ()))
    return total / len(fr) * 1e3


def is_dtoh(name: str) -> bool:
    """A device-to-host copy in the profiler's names."""
    return name.startswith(("Memcpy DtoH", "memcpy DtoH"))


def copy_wait_ms(ctx) -> float | None:
    """Milliseconds a frame of ``fetch.wait`` during which a card ran a
    device-to-host copy (the union of every card's)."""
    fr = frames(ctx)
    if fr is None:
        return None
    copies = stats.merged([(s, e) for d in ctx.devices
                           for n, s, e in ctx.events.get(d, ()) if is_dtoh(n)])
    ends = [e for _, e in copies]
    total = 0.0
    for kinds in fr.values():
        for a, b in kinds.get("fetch.wait", ()):
            # the merged copies are sorted and disjoint: start at the
            # first that ends after the wait begins
            i = bisect.bisect_right(ends, a)
            while i < len(copies) and copies[i][0] < b:
                s, e = copies[i]
                total += min(e, b) - max(s, a)
                i += 1
    return total / len(fr) * 1e3

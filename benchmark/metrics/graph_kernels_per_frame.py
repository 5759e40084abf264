"""Kernels a frame's compiled step replays: the mean payload of the
``step.replay`` spans (the kernel nodes of the graph each replays,
counted once when the graph was captured) over the traced stretch's
whole frames. A program whose replays carry no count (every payload 0,
as on the CPU) gives nothing."""

from benchlib import spans


def read(ctx):
    fr = spans.frames(ctx)
    if fr is None:
        return None
    counts = [s.payload for s in spans.recorded() if s.kind == "step.replay"
              and (s.loop, s.frame) in fr]
    if not any(counts):
        return None
    return sum(counts) / len(fr)

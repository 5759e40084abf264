"""The 95th percentile, over every stream-frame handed off outside the
profiled stretch, of the time from the loop's snapshot of that stream's
audio to the frame's hand-off to its sink: ``frame_p95_ms`` read per
layer, in the cells whose runs spread too widely for that end-to-end
bound."""

from benchlib import stats


def read(ctx):
    if not len(ctx.latency_ms):
        return None
    return stats.percentile(ctx.latency_ms, 95)

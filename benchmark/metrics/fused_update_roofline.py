"""The fused update kernel (``csrc/fused_update.cu``): its least time at
the launch's bufsize and rows over the profiler's mean time a launch, in
%. The least time is the larger of its bytes over the memory rate and
its float64 FFT over the float64 rate (``benchlib.roofline``)."""

from benchlib import roofline

KERNEL = "fused_update_kernel"


def read(ctx):
    s = ctx.shapes
    times, bound = [], 0.0
    for i, d in enumerate(ctx.devices):
        mine = [e - b for n, b, e in ctx.events[d] if KERNEL in n]
        times += mine
        bound += len(mine) * roofline.update_bound_s(s["n"], s["rows"][i],
                                                     s["F"])
    if not times:
        return None
    return 100.0 * bound / sum(times)

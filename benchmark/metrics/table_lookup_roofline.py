"""The table lookup kernel (``csrc/table_lookup.cu``): the least time
to move its bytes (``benchlib.lookup_roofline``) over the profiler's
mean time a launch, in %. Counted at one launch's shapes in a
one-stream shader cell: one table row of the texture's ``n`` texels
looked up at every pixel of the ``H`` x ``W`` frame (a spectrum
texture sampled per pixel). None where no launch is seen."""

from benchlib import lookup_roofline

KERNEL = "table_lookup_kernel"


def read(ctx):
    s = ctx.shapes
    times = [e - b for d in ctx.devices for n, b, e in ctx.events[d]
             if KERNEL in n]
    if not times:
        return None
    bound = lookup_roofline.lookup_bound_s(1, s["n"], s["H"] * s["W"])
    return 100.0 * bound * len(times) / sum(times)

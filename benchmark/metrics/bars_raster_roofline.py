"""The bars raster kernel (``csrc/bars_raster.cu``): the least time to
move its inputs and outputs at the launch's shapes over the profiler's
mean time a launch, in %."""

from benchlib import roofline

KERNEL = "bars_raster_kernel"


def read(ctx):
    s = ctx.shapes
    times, bound = [], 0.0
    for i, d in enumerate(ctx.devices):
        mine = [e - b for n, b, e in ctx.events[d] if KERNEL in n]
        times += mine
        bound += len(mine) * roofline.raster_bound_s(
            s["bars_streams"][i], s["H"], s["W"], s["color_rows"][i])
    if not times:
        return None
    return 100.0 * bound / sum(times)

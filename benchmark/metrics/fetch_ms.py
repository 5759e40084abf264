"""Host time a frame in the frame hand-off (``FrameFetch.push`` for the
Engine, ``FleetEngine.fetch`` for the fleet), the wait on the copy
included; outside the profiled stretch."""


def read(ctx):
    if not ctx.host_frames or not ctx.spans["fetch"]:
        return None
    return ctx.span_s("fetch") / ctx.host_frames * 1e3

"""Host time a frame inside the compiled step's call (``Engine._step`` /
``FleetEngine._step``): staging, the host-to-device copy, the replay's
enqueue; outside the profiled stretch."""


def read(ctx):
    return ctx.span_s("step") / ctx.host_frames * 1e3 if ctx.host_frames else None

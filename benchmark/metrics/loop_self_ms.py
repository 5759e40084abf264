"""Host time a frame in the serving loop itself: the window less the
step, hand-off and snapshot spans (dynamics, pipe values, the
bookkeeping, the sinks), outside the profiled stretch."""


def read(ctx):
    if not ctx.host_frames:
        return None
    inside = sum(ctx.span_s(k) for k in ("step", "fetch", "snapshot"))
    return (ctx.host_s - inside) / ctx.host_frames * 1e3

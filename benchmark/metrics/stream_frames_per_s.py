"""Every stream's frames handed off to its sink outside the profiled
stretch, over those seconds: ``stream_frames_per_s`` read per layer, in
the cells whose runs spread too widely for that end-to-end bound."""


def read(ctx):
    if ctx.host_s <= 0 or not ctx.handed:
        return None
    return ctx.handed / ctx.host_s

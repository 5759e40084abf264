"""Host time a frame in every stream's ``AudioData.snapshot``, outside the
profiled stretch."""


def read(ctx):
    return ctx.span_s("snapshot") / ctx.host_frames * 1e3 if ctx.host_frames else None

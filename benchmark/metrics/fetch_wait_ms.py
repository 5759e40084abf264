"""Host time a frame the program's own ``fetch.wait`` spans take: the
frame fetch's wait on its copy (``FrameFetch._finish``'s event, the
fleet's stream synchronize), over the traced stretch's whole frames."""

from benchlib import spans


def read(ctx):
    return spans.per_frame_ms(ctx, "fetch.wait")

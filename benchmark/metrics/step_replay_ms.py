"""Host time a frame in the compiled step's graph replays
(``step.replay`` spans), over the traced stretch's whole frames."""

from benchlib import spans


def read(ctx):
    return spans.per_frame_ms(ctx, "step.replay")

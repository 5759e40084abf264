"""Host time a frame in the compiled step's loading of its inputs
(``step.load`` spans: packing into pinned staging, the host-to-device
copy's enqueue, staging waits included), over the traced stretch's
whole frames."""

from benchlib import spans


def read(ctx):
    return spans.per_frame_ms(ctx, "step.load")

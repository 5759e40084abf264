"""The part of the frame fetch's wait (``fetch.wait`` spans) during
which the card ran a device-to-host copy, a frame, over the traced
stretch's whole frames: the program's spans joined with the device
trace on one clock."""

from benchlib import spans


def read(ctx):
    return spans.copy_wait_ms(ctx)

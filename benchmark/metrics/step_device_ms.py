"""Kernel time a frame on the card (copies excluded), from the profiler's
trace; where a cell has several cards, the slowest card's."""


def read(ctx):
    if not ctx.frames:
        return None
    worst = max(ctx.view[d]["kernel"] for d in ctx.devices)
    return worst / ctx.frames * 1e3 if worst > 0 else None

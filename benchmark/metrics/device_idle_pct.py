"""Share of the traced stretch in which a card ran neither a kernel nor a
copy (the union of their intervals), the mean over the cards."""


def read(ctx):
    span = ctx.t1 - ctx.t0
    if span <= 0 or not any(ctx.events[d] for d in ctx.devices):
        return None
    idle = [1.0 - ctx.view[d]["busy"] / span for d in ctx.devices]
    return 100.0 * sum(idle) / len(idle)

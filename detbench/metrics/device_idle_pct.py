"""Share of the traced stretch in which no operation ran on the card: one
minus the union of the device events' intervals (overlapping kernels
count once) over the stretch's length."""

from detbench import trace


def read(ctx):
    lo, hi = ctx.span
    busy = trace.busy_us(ctx.events, ctx.span)
    if hi <= lo or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))

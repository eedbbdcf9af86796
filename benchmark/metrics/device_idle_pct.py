"""The share of the traced stretch in which the device runs nothing: one
less the union of its kernels, copies and fills over the stretch."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.busy:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

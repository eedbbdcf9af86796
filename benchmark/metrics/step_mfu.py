"""The whole train step's share of the card's peak: the model FLOPs of the
examples the window completed (forward and backward products per example,
counted from the reference at the cell's shapes) over the window's seconds
and the data-sheet peak of the cell's compute dtype."""

from benchmark.roofline import PEAK_FLOPS


def read(ctx):
    dtype = ctx.wl["compute_dtype"] or "float32"
    return 100.0 * ctx.rate * ctx.flops_per_example / PEAK_FLOPS[dtype]

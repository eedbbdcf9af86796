"""The EEG stem's two convolutions' share of their roofline: the least time
of their forward, data-gradient and weight-gradient work over the traced
steps' rows (:func:`benchmark.roofline.conv_work`) over the device time of
the library kernels listed in ``conv_roofline_pct.d``."""

from benchmark import roofline


def read(ctx):
    seconds, n = ctx.kernel_seconds("conv_roofline_pct")
    if n == 0 or seconds <= 0:
        return None
    e, f = ctx.cfg["eeg"], ctx.cfg["feat_dim"]
    dtype = ctx.wl["compute_dtype"] or "float32"
    rows = ctx.info["encoder_rows_per_step"] * ctx.steps
    ops = nbytes = 0.0
    for t, c_in, c_out, k in ((e["time"], e["channels"], e["conv1_out"], e["conv1_kernel"]),
                              (e["time"] // e["pool1"], e["conv1_out"], f, e["conv2_kernel"])):
        o, b = roofline.conv_work(rows, t, c_in, c_out, k, k // 2, dtype)
        ops, nbytes = ops + o, nbytes + b
    return 100.0 * roofline.bound_seconds(ops, nbytes, roofline.PEAK_FLOPS[dtype]) / seconds

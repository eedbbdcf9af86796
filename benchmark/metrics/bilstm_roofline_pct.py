"""The BiLSTM kernels' share of their roofline: the least time of both
layers' forward and backward over the traced steps' rows
(:func:`benchmark.roofline.bilstm_work`) over the device time of the
kernels listed in ``bilstm_roofline_pct.d``."""

from benchmark import roofline


def read(ctx):
    seconds, n = ctx.kernel_seconds("bilstm_roofline_pct")
    if n == 0 or seconds <= 0:
        return None
    e, f = ctx.cfg["eeg"], ctx.cfg["feat_dim"]
    dtype = ctx.wl["compute_dtype"] or "float32"
    steps = e["time"] // e["pool1"] // e["pool2"]
    ops, nbytes = roofline.bilstm_work(ctx.info["encoder_rows_per_step"] * ctx.steps, steps,
                                       f, f // 2, e["lstm_layers"], dtype)
    return 100.0 * roofline.bound_seconds(ops, nbytes, roofline.lstm_rate(dtype)) / seconds

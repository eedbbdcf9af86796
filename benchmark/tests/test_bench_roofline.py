"""The bound arithmetic against hand counts."""

import pytest

from benchmark import roofline


def test_one_bilstm_layer():
    r, t, i, h = 2, 3, 4, 5
    ops, nbytes = roofline.bilstm_work(r, t, i, h, 1, "float32")
    # per direction: forward 2 R T 4H (I + H) = 2160; backward twice that;
    # two directions
    assert ops == 2 * 3 * 2160
    x, y = r * t * i * 4, r * t * 2 * h * 4
    w = 2 * (4 * h * (i + h) + 8 * h)  # both directions' W_ih, W_hh, b_ih, b_hh
    assert nbytes == (x + 4 * w + y) + (x + 4 * w + y + x + 4 * w)
    assert roofline.lstm_rate("float32") == pytest.approx(165e12)


def test_one_conv_stage():
    # (2 rows, 10 steps, 3 -> 4 channels, kernel 5, padding 2): T_out 10
    ops, nbytes = roofline.conv_work(2, 10, 3, 4, 5, 2, "bfloat16")
    assert ops == 3 * 2 * 2 * 10 * 4 * 3 * 5
    x, y, w = 2 * 10 * 3 * 2, 2 * 10 * 4 * 2, 4 * (3 * 5 + 1)
    assert nbytes == (x + 2 * w + y) + (y + 2 * w + x) + (x + y + 4 * w)
    assert roofline.bound_seconds(ops, nbytes, 1.0) == ops

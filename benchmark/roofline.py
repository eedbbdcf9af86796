"""Peaks of one NVIDIA H100 SXM and the least time of each measured layer's
work, from its shapes.

The peaks are the data sheet's dense rates at the full 700 W power limit
(a card set below it reads lower shares). A layer's bound is the larger of
its products over the peak rate of its dtype and its bytes over the memory
bandwidth. Work is counted as the algorithm needs it: a multiply-add is two
operations, nothing is recomputed, each input byte is read once and each
output byte written once, so the bound is the same whatever schedule or
kernels compute the layer. Elementwise work is not counted, which only
lowers the bound.

The float32 BiLSTM's products are counted at the 3xTF32 rate (three TF32
passes, float32-accurate), as the port's float32 kernels compute them; the
float32 convolutions run on the CUDA cores with TF32 off, at the float32
rate.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0

_SIZE = {"float32": 4, "bfloat16": 2}


def lstm_rate(dtype: str) -> float:
    """Operations per second of the BiLSTM's products in ``dtype``."""
    return PEAK_FLOPS["tf32"] / 3 if dtype == "float32" else PEAK_FLOPS[dtype]


def bilstm_work(rows: int, steps: int, n_in: int, hidden: int, layers: int,
                dtype: str) -> tuple[float, float]:
    """``(operations, bytes)`` of a bidirectional LSTM's forward and
    backward over ``rows`` sequences of ``steps``. Per layer and direction
    the forward's products are ``2 R T 4H (I + H)``; the backward's
    ``dh W_hh``, ``dx``, ``dW_ih`` and ``dW_hh`` are twice that. Bytes:
    the forward reads x and the weights and writes y; the backward reads x,
    the weights and dy and writes dx and the float32 weight gradients."""
    act = _SIZE[dtype]
    ops = nbytes = 0.0
    for k in range(layers):
        i = n_in if k == 0 else 2 * hidden
        ops += 2 * 3 * 2 * rows * steps * 4 * hidden * (i + hidden)
        weights = 2 * (4 * hidden * (i + hidden) + 8 * hidden)
        x, y = rows * steps * i * act, rows * steps * 2 * hidden * act
        nbytes += (x + weights * act + y) + (x + weights * act + y + x + weights * 4)
    return ops, nbytes


def conv_work(rows: int, t_in: int, c_in: int, c_out: int, kernel: int, pad: int,
              dtype: str) -> tuple[float, float]:
    """``(operations, bytes)`` of one Conv1d's forward, data gradient and
    weight gradient: ``2 R T_out C_out C_in K`` each. Bytes: x, w, y; dy,
    w, dx; x, dy, dw (float32)."""
    act = _SIZE[dtype]
    t_out = t_in + 2 * pad - kernel + 1
    ops = 3 * 2 * rows * t_out * c_out * c_in * kernel
    x, y = rows * t_in * c_in * act, rows * t_out * c_out * act
    w = c_out * (c_in * kernel + 1)
    return ops, (x + w * act + y) + (y + w * act + x) + (x + y + w * 4)


def bound_seconds(ops: float, nbytes: float, rate: float) -> float:
    return max(ops / rate, nbytes / PEAK_BYTES_PER_S)

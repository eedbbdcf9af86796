"""The serving path's kernels as ``torch.library`` custom ops.

``torch.export`` traces with fake tensors, which have no storage, so it
cannot trace through a ``ctypes`` launch (:meth:`._build.CudaKernel.launch`
reads ``data_ptr()``). The kernels that the serving forward runs are
therefore registered here as custom ops of the namespace ``msa_torch``,
each with three implementations:

- **CPU**: the kernel's plain PyTorch version, so that a CPU tensor takes
  the plain version as before and a CPU export holds the same graph node as
  a CUDA one;
- **CUDA**: the launch path (the ``*_cuda`` functions of :mod:`.lstm` and
  :mod:`.conv_stem`), which launches the kernel or raises, plans from the
  batch it is given (cluster plan, grid limits, shared memory) and alone
  moves the launch counters: tracing never does, a run of a loaded artifact
  does;
- **fake**: the output's shape and dtype from the inputs', which
  ``torch.export`` and ``torch.library.opcheck`` trace through, the batch
  symbolic.

The ops:

- ``bilstm_fwd(x, w_ih, w_hh, bias) -> h_seq``: row 1, wrapper
  :func:`.lstm.bilstm_fwd`, JAX ``kernels/lstm.py::_fwd_xproj_kernel``;
- ``bilstm_rec(xp, w_hh) -> h_seq``: row 1's recurrence,
  :func:`.lstm.bilstm_rec`;
- ``bilstm_fwd_xp(xp, w_hh) -> (h_seq, c_seq)``: row 4 (``h_seq`` in the
  dtype of ``w_hh``, ``c_seq`` fp32),
  :func:`.lstm.bilstm_fwd_xp`, JAX ``kernels/lstm.py::_fwd_kernel``;
- ``conv_stem(x, weight, scale, shift, padding, pool) -> y``: row 3,
  :func:`.conv_stem.fused_conv_bn_gelu_pool`, JAX
  ``kernels/conv_stem.py::_stage_kernel``.

The wrappers keep their names and contracts and call the ops, so every
caller (the autograd Functions and their ``vmap`` rules, serving, the int8
forward) goes through them. The other kernels stay ``ctypes`` wrappers: no
exported path runs them.

A saved artifact that holds these ops loads in a process that has imported
this module (``torch.export.load`` resolves ``msa_torch::*`` by name), and
runs on the device it was exported on: the ops dispatch by device.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import conv_stem, lstm

NAMESPACE = "msa_torch"


def _op(name: str, plain, cuda):
    """A custom op ``msa_torch::name`` whose CPU implementation is ``plain``
    and whose CUDA implementation is ``cuda``; its fake implementation is
    registered by the caller."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(),
                                 device_types="cpu")(plain)
    op.register_kernel("cuda")(cuda)
    return op


def _bilstm_fwd(x: Tensor, w_ih: Tensor, w_hh: Tensor, bias: Tensor) -> Tensor:
    return lstm.bilstm_fwd_plain(x, w_ih, w_hh, bias)


def _bilstm_rec(xp: Tensor, w_hh: Tensor) -> Tensor:
    return lstm.bilstm_rec_plain(xp, w_hh)


def _bilstm_fwd_xp(xp: Tensor, w_hh: Tensor) -> tuple[Tensor, Tensor]:
    return lstm.bilstm_fwd_xp_plain(xp, w_hh)


def _conv_stem(x: Tensor, weight: Tensor, scale: Tensor, shift: Tensor, padding: int,
               pool: int) -> Tensor:
    return conv_stem.fused_conv_bn_gelu_pool_plain(x, weight, scale, shift, padding, pool)


bilstm_fwd = _op("bilstm_fwd", _bilstm_fwd, lstm.bilstm_fwd_cuda)
bilstm_rec = _op("bilstm_rec", _bilstm_rec, lstm.bilstm_rec_cuda)
bilstm_fwd_xp = _op("bilstm_fwd_xp", _bilstm_fwd_xp, lstm.bilstm_fwd_xp_cuda)
conv_stem_op = _op("conv_stem", _conv_stem, conv_stem.conv_stem_cuda)


@bilstm_fwd.register_fake
def _(x, w_ih, w_hh, bias):
    return x.new_empty(*x.shape[:-1], 2 * w_hh.shape[-1])


@bilstm_rec.register_fake
def _(xp, w_hh):
    return xp.new_empty(*xp.shape[:-1], 2 * w_hh.shape[-1], dtype=w_hh.dtype)


@bilstm_fwd_xp.register_fake
def _(xp, w_hh):
    *s, b, t, _ = xp.shape
    h = w_hh.shape[-1]
    return (xp.new_empty(*s, b, t, 2 * h, dtype=w_hh.dtype),
            xp.new_empty(*s, 2, t, b, h, dtype=torch.float32))


@conv_stem_op.register_fake
def _(x, weight, scale, shift, padding, pool):
    b, t, _ = x.shape
    o, _, k = weight.shape
    return x.new_empty(b, (t + 2 * padding - k + 1) // pool, o, dtype=torch.float32)


OPS = {"bilstm_fwd": bilstm_fwd, "bilstm_rec": bilstm_rec, "bilstm_fwd_xp": bilstm_fwd_xp,
       "conv_stem": conv_stem_op}

__all__ = ["NAMESPACE", "OPS", "bilstm_fwd", "bilstm_fwd_xp", "bilstm_rec", "conv_stem_op"]

"""Zero-phase IIR filtering of many series (scipy ``filtfilt``): the Hopper
kernel and its plain version.

A port-only kernel: no Pallas kernel lies behind it. The JAX package
filters with a ``lax.scan`` over time, vmapped over the series
(``multimodal_sentiment_aanalysis_tpu/ops/dsp.py::_filtfilt_1d``), and
PyTorch has no scan. :func:`sos_filtfilt` takes ``x (N, T)``, the
second-order sections ``sos (S, 6)`` (scipy rows ``b0 b1 b2 1 a1 a2``),
their steady-state initial conditions ``zi (S, 2)`` and the odd-extension
length ``padlen``, and returns the zero-phase filtered ``(N, T)``: the odd
extension, a forward pass through the S sections from ``zi * ext[0]``, a
reverse pass from ``zi * y_fwd[-1]``, the central T samples, all in one
launch of ``csrc/iir.cu`` for every series of the call: a thread per
series, a warp of 32 series a block, ``x`` and ``y`` moved as coalesced
rows through a ring of time steps in shared memory, the forward pass's last
:data:`HOLD_STEPS` steps kept there and the earlier ones in a time-major
scratch. ``x``, ``sos`` and ``zi`` share one dtype: fp32
(``msa_sos_filtfilt``) or fp64 (``msa_sos_filtfilt_f64``), each form with
its own launch count.

Kernel or raise: a CPU tensor takes :func:`sos_filtfilt_plain`, which
autograd differentiates as JAX differentiates its scan; a CUDA tensor
launches the kernel or raises. The kernel has no backward (no path
differentiates a filter): a CUDA input that requires grad under grad mode
raises. Under ``torch.func.vmap`` the batch folds into the series axis, so
a stack of trials is still one launch.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda, ptr

#: the most sections a kernel call takes (an order-8 band-pass), a template
#: parameter of ``csrc/iir.cu``
MAX_SECTIONS = 8
#: time steps of the forward pass the kernel keeps in shared memory (its
#: ring's slots, ``kSlots`` in ``csrc/iir.cu``): the most that keep 4 warps
#: an SM; the steps before them go to the scratch
HOLD_STEPS = {torch.float32: 416, torch.float64: 192}
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
#: fp32 and fp64 forms, by the dtype of ``x``
KERNELS = {torch.float32: CudaKernel("iir", "msa_sos_filtfilt", _ARGS),
           torch.float64: CudaKernel("iir", "msa_sos_filtfilt_f64", _ARGS)}
KERNEL = KERNELS[torch.float32]
F64_KERNEL = KERNELS[torch.float64]


def _odd_extension(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """``x (..., T)`` extended by ``padlen`` samples at both ends, odd about
    its first and last sample (JAX ``_filtfilt_1d``, scipy ``odd_ext``)."""
    left = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., x.shape[-1] - padlen - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _cascade_plain(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor,
                   v0: torch.Tensor) -> torch.Tensor:
    """``x (..., L)`` through the S sections in cascade, one time step at a
    time, each section's state started at ``zi * v0``: JAX ``_sosfilt_1d``,
    its operations in its order."""
    coef = [row.unbind() for row in sos]
    state = [[a * v0, b * v0] for a, b in (row.unbind() for row in zi)]
    out = []
    for t in range(x.shape[-1]):
        v = x[..., t]
        for (b0, b1, b2, _, a1, a2), z in zip(coef, state):
            y = b0 * v + z[0]
            z[0] = b1 * v - a1 * y + z[1]
            z[1] = b2 * v - a2 * y
            v = y
        out.append(v)
    return torch.stack(out, dim=-1)


def sos_filtfilt_plain(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor,
                       padlen: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel over ``x (..., T)``: vectorised
    over the series, a loop over time, in the kernel's order."""
    t = x.shape[-1]
    ext = _odd_extension(x, padlen)
    y = _cascade_plain(ext, sos, zi, ext[..., 0])
    y = _cascade_plain(y.flip(-1), sos, zi, y[..., -1]).flip(-1)
    return y[..., padlen:padlen + t]


def _check_filter(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor, padlen: int) -> None:
    s = sos.shape[0]
    if sos.dim() != 2 or sos.shape[1] != 6 or tuple(zi.shape) != (s, 2):
        raise ValueError(f"sos must be (S, 6) and zi (S, 2), got {tuple(sos.shape)} and "
                         f"{tuple(zi.shape)}")
    if padlen < 0 or x.shape[-1] <= padlen:
        raise ValueError(f"the odd extension needs more than padlen={padlen} samples, got "
                         f"{x.shape[-1]} (scipy filtfilt's rule)")


def scratch_steps(t: int, padlen: int, dtype: torch.dtype) -> int:
    """Rows of the kernel's time-major scratch: the forward pass's steps
    before the last :data:`HOLD_STEPS` of the ``T + 2 padlen`` (0 where the
    ring holds them all). The launcher refuses another count."""
    return max(t + 2 * padlen - HOLD_STEPS[dtype], 0)


def _launch(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor, padlen: int) -> torch.Tensor:
    """One launch of the kernel over ``x (N, T)``."""
    device, dtype = x.device, x.dtype
    if x.dim() != 2:
        raise ValueError(f"x must be (series, time), got {tuple(x.shape)}")
    s = sos.shape[0]
    if not 1 <= s <= MAX_SECTIONS:
        raise ValueError(f"{s} sections; the kernel takes 1 to {MAX_SECTIONS}")
    check_cuda("x", x, device, dtypes=tuple(KERNELS))
    check_cuda("sos", sos, device, dtypes=(dtype,))  # shapes: _check_filter
    check_cuda("zi", zi, device, dtypes=(dtype,))
    n, t = x.shape
    y = torch.empty_like(x)
    if n == 0:
        return y
    rows = scratch_steps(t, padlen, dtype)
    scratch = torch.empty(rows, n, device=device, dtype=dtype) if rows else None  # forward steps
    KERNELS[dtype].launch(device, ptr(x), ptr(y), ptr(scratch), ptr(sos), ptr(zi), n, t, padlen,
                          s, rows)
    return y


class _SosFiltfilt(torch.autograd.Function):
    """The kernel over ``x (N, T)``, forward only."""

    @staticmethod
    def forward(x, sos, zi, padlen):
        return _launch(x.contiguous(), sos.contiguous(), zi.contiguous(), padlen)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("the CUDA filter has no backward")

    @staticmethod
    def vmap(info, in_dims, x, sos, zi, padlen):
        """Every trial's series as one launch: the batch folds into N."""
        if in_dims[1] is not None or in_dims[2] is not None:
            raise ValueError("one filter for every series: sos and zi cannot be batched")
        x = x.movedim(in_dims[0], 0)
        y = _launch(x.reshape(-1, x.shape[-1]).contiguous(), sos.contiguous(), zi.contiguous(),
                    padlen)
        return y.reshape(x.shape), 0


def sos_filtfilt(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor,
                 padlen: int) -> torch.Tensor:
    """Zero-phase filtered ``x (N, T)`` in its dtype (fp32 or fp64), with
    ``sos`` and ``zi`` of that dtype on its device. A CPU tensor takes
    :func:`sos_filtfilt_plain`; a CUDA tensor launches the kernel, or
    raises."""
    _check_filter(x, sos, zi, padlen)
    if x.device.type == "cpu":
        return sos_filtfilt_plain(x, sos, zi, padlen)
    if x.device.type != "cuda":
        raise ValueError(f"no filter kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, sos, zi)):
        raise RuntimeError("the CUDA filter has no backward: call it under torch.no_grad() or "
                           "on tensors that do not require grad")
    return _SosFiltfilt.apply(x, sos, zi, padlen)

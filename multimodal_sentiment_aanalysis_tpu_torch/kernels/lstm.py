"""Bidirectional LSTM layer, forward and backward: the Hopper kernels and
their plain versions.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/lstm.py``:
:func:`fused_bilstm_layer` has the JAX function's contract (torch-layout
weights in, ``(B, T, 2H)`` out in ``[fwd | bwd]`` order) and is a
``torch.autograd.Function``:

- forward: the in-kernel-projection forward (``_fwd_xproj_kernel``),
  ``csrc/lstm_fwd.cu`` (:func:`bilstm_fwd`); it saves ``x``, the weights
  and ``h_seq`` only;
- backward: the JAX package's default (v9) backward in two kernels of
  ``csrc/lstm_bwd.cu``: :func:`bilstm_cbnd` (``_cbnd_kernel``: c checkpoints
  at every K-th actual time step) then :func:`bilstm_segbwd`
  (``_segbwd_kernel``: the reverse sweep over K-step segments, emitting dx
  per direction and ``dW_cat = [x | h_prev | 1]^T dgates``).

The port's layouts keep the batch first: ``x (B, T, I)``, ``h_seq
(B, T, 2H)``, checkpoints ``(2, NSEG, B, H)`` (direction, slot, batch,
unit), dx halves ``(2, B, T, I)``, ``dW_cat (2, I + H + 1, 4H)``. Stacked
weights are ``w_ih (2, 4H, I)``, ``w_hh (2, 4H, H)`` and ``bias (2, 4H)``
(``b_ih + b_hh``) in torch (i, f, g, o) order.

Every kernel and plain version also takes a leading model axis S on all of
these (``x (S, B, T, I)``, ``w_ih (S, 2, 4H, I)``, ...): one launch covers
all S models. Under ``torch.func.vmap`` (the LOSO trainer) the three
Functions' ``vmap`` rules make that one S-wide launch; the backward runs
under ``vmap`` too, so the two backward kernels are Functions of their own.
A CPU tensor takes the plain versions, a CUDA tensor launches the kernel or
raises.

Every kernel has an fp32 and a bf16 form, chosen by the dtype of ``x``
(the weights and ``h_seq``/``dh_seq`` must share it; fp16 raises
``TypeError``). As in the JAX kernels, the bf16 form reads bf16 and does
all arithmetic in fp32: ``h`` and ``c`` are carried in fp32, ``h_seq`` is
stored as bf16, and the c checkpoints, the dx halves and ``dW_cat`` are
fp32; the layer's backward rounds dx and the weight gradients to the
inputs' dtype, as ``_xproj_bwd`` does. The plain versions compute in fp32
and store as the kernels store.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import (F32, F32_BF16, MAX_MODELS, check_cuda, kernel_forms, models_first, ptr,
                     upcast, with_models)

# fp32 and bf16 forms of each kernel, by the dtype of x
KERNELS = kernel_forms("lstm_fwd", "msa_bilstm_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)
CBND_KERNELS = kernel_forms("lstm_bwd", "msa_bilstm_cbnd",
                            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6)
SEGBWD_KERNELS = kernel_forms("lstm_bwd", "msa_bilstm_segbwd",
                              [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6)
KERNEL, CBND_KERNEL, SEGBWD_KERNEL = (
    k[torch.float32] for k in (KERNELS, CBND_KERNELS, SEGBWD_KERNELS))

_ROWS_PER_BLOCK = 8  # kBt in csrc/lstm_fwd.cu and csrc/lstm_bwd.cu
_SEGBWD_MAX_HIDDEN = 128  # kSegMaxThreads / 4 in csrc/lstm_bwd.cu
_MAX_SMEM = 227 * 1024
SEG_K = 4  # segment length of the backward; any K >= 1 works for any T

Params = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def stack_params(fwd: Params, bwd: Params) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(w_ih (2, 4H, I), w_hh (2, 4H, H), bias (2, 4H))`` of both directions."""
    return (torch.stack([fwd[0], bwd[0]]), torch.stack([fwd[1], bwd[1]]),
            torch.stack([fwd[2] + fwd[3], bwd[2] + bwd[3]]))


def _num_segments(t: int, k: int) -> int:
    return -(-t // k)



def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BiLSTM kernel for device {x.device}")


def _check_layer(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                 bias: torch.Tensor) -> tuple[int, int, int, int, int]:
    """Validate a layer's CUDA operands, model axis first; returns
    ``(S, B, T, I, H)``."""
    device = x.device
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (B, T, I) or (S, B, T, I) tensor, "
                         f"got {tuple(x.shape)}")
    s, b, t, i = x.shape
    if s > MAX_MODELS:
        raise ValueError(f"{s} models > {MAX_MODELS}: the model axis is the grid's z axis")
    h = w_hh.shape[-1]
    if not 0 < 4 * h <= 1024:
        raise ValueError(f"hidden size {h}: the kernels run 4H <= 1024 threads")
    check_cuda("x", x, device, dtypes=F32_BF16)
    check_cuda("w_ih", w_ih, device, (s, 2, 4 * h, i), (x.dtype,))
    check_cuda("w_hh", w_hh, device, (s, 2, 4 * h, h), (x.dtype,))
    check_cuda("bias", bias, device, (s, 2, 4 * h), (x.dtype,))
    return s, b, t, i, h


def _check_smem(floats: int, what: str) -> None:
    if 4 * floats > _MAX_SMEM:
        raise ValueError(f"{what}: {4 * floats} bytes of shared memory > {_MAX_SMEM}")


def _transposed(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2).contiguous()


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (S, ..., K)`` times ``w (S, N, K)`` transposed, per model:
    ``(S, ..., N)``."""
    return torch.einsum("s...k,snk->s...n", a, w)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def bilstm_fwd(x, w_ih, w_hh, bias) -> torch.Tensor:
    """The forward kernel: ``h_seq (B, T, 2H)`` (or ``(S, B, T, 2H)``) on
    stacked weights. A CPU tensor takes :func:`bilstm_fwd_plain`; a CUDA
    tensor launches the kernel, or raises."""
    if x.device.type == "cpu":
        return bilstm_fwd_plain(x, w_ih, w_hh, bias)
    _check_device(x)
    (x, w_ih, w_hh, bias), one = with_models(x, w_ih, w_hh, bias)
    s, b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    _check_smem(_ROWS_PER_BLOCK * (i + 5 * h), f"input width {i}")
    # bound to names: a temporary freed before the launch could be reused
    # by the next allocation while the kernel still reads it
    w_ih_t, w_hh_t = _transposed(w_ih), _transposed(w_hh)
    out = torch.empty(s, b, t, 2 * h, device=x.device, dtype=x.dtype)
    KERNELS[x.dtype].launch(x.device, ptr(x), ptr(w_ih_t), ptr(w_hh_t), ptr(bias), ptr(out),
                            s, b, t, i, h)
    return out[0] if one else out


def bilstm_fwd_plain(x, w_ih, w_hh, bias) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: each direction's input
    projection in one product, then the recurrence step by step, in fp32;
    ``h_seq`` comes back in the dtype of ``x``."""
    dtype = x.dtype
    (x, w_ih, w_hh, bias), one = with_models(*map(upcast, (x, w_ih, w_hh, bias)))
    t = x.shape[2]
    halves = []
    for d in (0, 1):
        xp = _mm(x, w_ih[:, d]) + bias[:, d, None, None]  # (S, B, T, 4H)
        h = x.new_zeros(*x.shape[:2], w_hh.shape[-1])
        c = h
        hs = [h] * t
        for a in (range(t) if d == 0 else reversed(range(t))):
            i, f, g, o = (xp[:, :, a] + _mm(h, w_hh[:, d])).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs[a] = h
        halves.append(torch.stack(hs, dim=2))
    out = torch.cat(halves, dim=-1).to(dtype)
    return out[0] if one else out


def fused_bilstm_layer_plain(x: torch.Tensor, fwd: Params, bwd: Params) -> torch.Tensor:
    """:func:`bilstm_fwd_plain` on torch-layout parameter tuples."""
    return bilstm_fwd_plain(x, *stack_params(fwd, bwd))


class _FusedBiLSTM(torch.autograd.Function):
    """``h_seq`` of one layer on stacked weights; its backward runs the two
    backward kernels."""

    @staticmethod
    def forward(x, w_ih, w_hh, bias):
        return bilstm_fwd(*(t.contiguous() for t in (x, w_ih, w_hh, bias)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, dh_seq):
        x, w_ih, w_hh, bias, h_seq = ctx.saved_tensors
        c_bnd = _Cbnd.apply(x, h_seq, w_ih, w_hh, bias, SEG_K)
        dx_pk, dw_cat = _SegBwd.apply(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias, SEG_K)
        i, h = x.shape[-1], w_hh.shape[-1]
        return ((dx_pk[0] + dx_pk[1]).to(x.dtype), dw_cat[:, :i].transpose(1, 2).to(w_ih.dtype),
                dw_cat[:, i:i + h].transpose(1, 2).to(w_hh.dtype), dw_cat[:, i + h].to(bias.dtype))

    @staticmethod
    def vmap(info, in_dims, *args):
        return bilstm_fwd(*models_first(info, in_dims, *args)), 0


def fused_bilstm_layer(x: torch.Tensor, fwd: Params, bwd: Params) -> torch.Tensor:
    """One bidirectional LSTM layer, ``(B, T, I) -> (B, T, 2H)``, with its
    kernel backward.

    ``fwd``/``bwd`` are ``(w_ih (4H, I), w_hh (4H, H), b_ih (4H,),
    b_hh (4H,))`` in torch layout and (i, f, g, o) gate order. A CPU tensor
    takes the plain versions of the forward and of both backward kernels; a
    CUDA tensor launches the kernels, or raises. Under ``torch.func.vmap``
    over S models every kernel is one S-wide launch.
    """
    _check_device(x)
    return _FusedBiLSTM.apply(x, *stack_params(fwd, bwd))


# --------------------------------------------------------------------------
# backward (a): c checkpoints
# --------------------------------------------------------------------------


def _h_prev(h_seq: torch.Tensor, d: int, h: int) -> torch.Tensor:
    """h at the previous recurrence step of direction ``d``, per actual
    time: shifted right (d=0) or left (d=1) along T, zero at the start.
    ``h_seq (S, B, T, 2H)``."""
    hd = h_seq[..., d * h:(d + 1) * h]
    zero = torch.zeros_like(hd[:, :, :1])
    return torch.cat([zero, hd[:, :, :-1]], 2) if d == 0 else torch.cat([hd[:, :, 1:], zero], 2)


def _gates(x, hp, w_ih, w_hh, bias):
    """Gate activations ``(i, f, g, o)`` from the input and the stored
    h_prev, per model: ``x (S, ..., I)``, ``w_ih (S, 4H, I)``."""
    z = _mm(x, w_ih) + _mm(hp, w_hh) + bias.reshape(bias.shape[:1] + (1,) * (x.dim() - 2)
                                                     + bias.shape[1:])
    i, f, g, o = z.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def _is_boundary(d: int, a: int, k: int) -> bool:
    return a % k == k - 1 if d == 0 else a % k == 0


def bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias, k: int = SEG_K) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_cbnd` (fp32)."""
    (x, h_seq, w_ih, w_hh, bias), one = with_models(*map(upcast, (x, h_seq, w_ih, w_hh, bias)))
    s, b, t, _ = x.shape
    h = w_hh.shape[-1]
    out = x.new_zeros(s, 2, _num_segments(t, k), b, h)
    for d in (0, 1):
        i, f, g, _ = _gates(x, _h_prev(h_seq, d, h), w_ih[:, d], w_hh[:, d], bias[:, d])
        c = x.new_zeros(s, b, h)
        for a in (range(t) if d == 0 else reversed(range(t))):
            c = f[:, :, a] * c + i[:, :, a] * g[:, :, a]
            if _is_boundary(d, a, k):
                out[:, d, a // k] = c
    return out[0] if one else out


def bilstm_cbnd(x, h_seq, w_ih, w_hh, bias, k: int = SEG_K) -> torch.Tensor:
    """c checkpoints ``(2, NSEG, B, H)`` (or ``(S, 2, NSEG, B, H)``),
    ``NSEG = ceil(T / k)``, rebuilt in recurrence order from ``x`` and the
    stored ``h_seq``, in fp32. Slot ``m`` of direction 0 holds c at actual time
    ``m k + k - 1`` (the entry of block ``m + 1``); of direction 1, c at
    ``m k`` (the entry of block ``m - 1``). Slots no block reads are zero on
    the CPU and unspecified on the card."""
    if x.device.type == "cpu":
        return bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias, k)
    _check_device(x)
    (x, h_seq, w_ih, w_hh, bias), one = with_models(x, h_seq, w_ih, w_hh, bias)
    s, b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    check_cuda("h_seq", h_seq, x.device, (s, b, t, 2 * h), (x.dtype,))
    if k < 1:
        raise ValueError(f"segment length {k} < 1")
    _check_smem(_ROWS_PER_BLOCK * (i + 5 * h), f"input width {i}")
    w_ih_t, w_hh_t = _transposed(w_ih), _transposed(w_hh)
    out = torch.zeros(s, 2, _num_segments(t, k), b, h, device=x.device, dtype=torch.float32)
    CBND_KERNELS[x.dtype].launch(x.device, ptr(x), ptr(h_seq), ptr(w_ih_t), ptr(w_hh_t),
                                 ptr(bias), ptr(out), s, b, t, i, h, k)
    return out[0] if one else out


class _Cbnd(torch.autograd.Function):
    """:func:`bilstm_cbnd` as a Function, so the layer's backward makes one
    S-wide launch when it runs under ``vmap``. Not differentiable."""

    @staticmethod
    def forward(x, h_seq, w_ih, w_hh, bias, k):
        return bilstm_cbnd(*(t.contiguous() for t in (x, h_seq, w_ih, w_hh, bias)), k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the BiLSTM backward kernels have no backward")

    @staticmethod
    def vmap(info, in_dims, *args):
        return bilstm_cbnd(*models_first(info, in_dims, *args)), 0


# --------------------------------------------------------------------------
# backward (b): reverse sweep over K-step segments
# --------------------------------------------------------------------------


def bilstm_segbwd_plain(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias,
                        k: int = SEG_K) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bilstm_segbwd`, block by block as the
    kernel walks them, in fp32."""
    (x, dh_seq, h_seq, c_bnd, w_ih, w_hh, bias), one = with_models(
        *map(upcast, (x, dh_seq, h_seq, c_bnd, w_ih, w_hh, bias)))
    s, b, t, i_dim = x.shape
    h = w_hh.shape[-1]
    nseg = _num_segments(t, k)
    dx_pk = x.new_zeros(s, 2, b, t, i_dim)
    dw_cat = x.new_zeros(s, 2, i_dim + h + 1, 4 * h)
    ones = x.new_ones(s, b, 1)
    for d in (0, 1):
        hp = _h_prev(h_seq, d, h)
        wi, wh, bd = w_ih[:, d], w_hh[:, d], bias[:, d]
        dh_c, dc_c = x.new_zeros(s, b, h), x.new_zeros(s, b, h)
        for gi in range(nseg):
            m = nseg - 1 - gi if d == 0 else gi
            rows = list(range(m * k, min(m * k + k, t)))  # recurrence order
            if d == 1:
                rows.reverse()
            c = (x.new_zeros(s, b, h) if gi == nseg - 1
                 else c_bnd[:, d, m - 1 if d == 0 else m + 1])
            acts, cs = [], [c]
            for a in rows:
                ig, fg, gg, og = _gates(x[:, :, a], hp[:, :, a], wi, wh, bd)
                c = fg * c + ig * gg
                acts.append((ig, fg, gg, og))
                cs.append(c)
            for r in reversed(range(len(rows))):
                a = rows[r]
                ig, fg, gg, og = acts[r]
                dh = dh_seq[:, :, a, d * h:(d + 1) * h] + dh_c
                tc = torch.tanh(cs[r + 1])
                dc = dc_c + dh * og * (1 - tc * tc)
                dgates = torch.cat([dc * gg * ig * (1 - ig), dc * cs[r] * fg * (1 - fg),
                                    dc * ig * (1 - gg * gg), dh * tc * og * (1 - og)], dim=-1)
                dh_c = dgates @ wh
                dc_c = dc * fg
                dx_pk[:, d, :, a] = dgates @ wi
                dw_cat[:, d] += torch.cat([x[:, :, a], hp[:, :, a], ones],
                                          dim=-1).transpose(1, 2) @ dgates
    return (dx_pk[0], dw_cat[0]) if one else (dx_pk, dw_cat)


def bilstm_segbwd(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias,
                  k: int = SEG_K) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse sweep: ``(dx_pk (2, B, T, I), dW_cat (2, I + H + 1, 4H))``
    in fp32 (each with a leading S where the inputs have one) from the output
    gradient ``dh_seq (B, T, 2H)`` and the checkpoints of
    :func:`bilstm_cbnd` at the same ``k``. ``dx = dx_pk[0] + dx_pk[1]``;
    rows ``:I`` of ``dW_cat[d]`` are ``dW_ih[d]^T``, rows ``I:I+H``
    ``dW_hh[d]^T`` and row ``I+H`` is ``db[d]``.

    The kernel accumulates dW_cat per (model, batch tile of 8 rows), each in
    its own slice, no atomics; the tiles are summed here, so the result is
    deterministic but sums B*T terms in another order than the plain
    version."""
    if x.device.type == "cpu":
        return bilstm_segbwd_plain(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias, k)
    _check_device(x)
    (x, dh_seq, h_seq, c_bnd, w_ih, w_hh, bias), one = with_models(
        x, dh_seq, h_seq, c_bnd, w_ih, w_hh, bias)
    s, b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    device = x.device
    nseg = _num_segments(t, k)
    check_cuda("dh_seq", dh_seq, device, (s, b, t, 2 * h), (x.dtype,))
    check_cuda("h_seq", h_seq, device, (s, b, t, 2 * h), (x.dtype,))
    check_cuda("c_bnd", c_bnd, device, (s, 2, nseg, b, h), F32)
    if k < 1:
        raise ValueError(f"segment length {k} < 1")
    if h > _SEGBWD_MAX_HIDDEN:
        raise ValueError(f"hidden size {h} > {_SEGBWD_MAX_HIDDEN}: the reverse sweep runs "
                         f"4H <= {4 * _SEGBWD_MAX_HIDDEN} threads")
    _check_smem(_ROWS_PER_BLOCK * (k * (i + 5 * h) + (k + 1) * h + 5 * h),
                f"segment length {k}, input width {i}")
    tiles = -(-b // _ROWS_PER_BLOCK)
    w_ih_t, w_hh_t = _transposed(w_ih), _transposed(w_hh)
    dx_pk = torch.empty(s, 2, b, t, i, device=device, dtype=torch.float32)
    dw_part = torch.zeros(s, tiles, 2, i + h + 1, 4 * h, device=device, dtype=torch.float32)
    SEGBWD_KERNELS[x.dtype].launch(device, ptr(dh_seq), ptr(x), ptr(h_seq), ptr(c_bnd),
                                   ptr(w_ih_t), ptr(w_hh_t), ptr(w_ih), ptr(w_hh), ptr(bias),
                                   ptr(dx_pk), ptr(dw_part), s, b, t, i, h, k)
    dw_cat = dw_part.sum(1)
    return (dx_pk[0], dw_cat[0]) if one else (dx_pk, dw_cat)


class _SegBwd(torch.autograd.Function):
    """:func:`bilstm_segbwd` as a Function (see :class:`_Cbnd`)."""

    @staticmethod
    def forward(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias, k):
        return bilstm_segbwd(*(t.contiguous() for t in (dh_seq, x, h_seq, c_bnd, w_ih, w_hh,
                                                         bias)), k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the BiLSTM backward kernels have no backward")

    @staticmethod
    def vmap(info, in_dims, *args):
        return bilstm_segbwd(*models_first(info, in_dims, *args)), (0, 0)

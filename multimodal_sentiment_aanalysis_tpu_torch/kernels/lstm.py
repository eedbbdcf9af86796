"""Bidirectional LSTM layer, forward and backward: the Hopper kernels and
their plain versions.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/lstm.py``:
:func:`fused_bilstm_layer` has the JAX function's contract (torch-layout
weights in, ``(B, T, 2H)`` out in ``[fwd | bwd]`` order) and is a
``torch.autograd.Function``:

- forward: the in-kernel-projection forward (``_fwd_xproj_kernel``),
  ``csrc/lstm_fwd.cu``; it saves ``x``, the weights and ``h_seq`` only;
- backward: the JAX package's default (v9) backward in two kernels of
  ``csrc/lstm_bwd.cu``: :func:`bilstm_cbnd` (``_cbnd_kernel``: c checkpoints
  at every K-th actual time step) then :func:`bilstm_segbwd`
  (``_segbwd_kernel``: the reverse sweep over K-step segments, emitting dx
  per direction and ``dW_cat = [x | h_prev | 1]^T dgates``).

The port's layouts keep the batch first: ``x (B, T, I)``, ``h_seq
(B, T, 2H)``, checkpoints ``(2, NSEG, B, H)`` (direction, slot, batch,
unit), dx halves ``(2, B, T, I)``, ``dW_cat (2, I + H + 1, 4H)``. Stacked
weights are ``w_ih (2, 4H, I)``, ``w_hh (2, 4H, H)`` and ``bias (2, 4H)``
(``b_ih + b_hh``) in torch (i, f, g, o) order. Every kernel has a plain
version with the same outputs; a CPU tensor takes it, a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda_f32, ptr

KERNEL = CudaKernel(
    "lstm_fwd", "msa_bilstm_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4,
)
CBND_KERNEL = CudaKernel(
    "lstm_bwd", "msa_bilstm_cbnd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
)
SEGBWD_KERNEL = CudaKernel(
    "lstm_bwd", "msa_bilstm_segbwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5,
)

_ROWS_PER_BLOCK = 8  # kBt in csrc/lstm_fwd.cu and csrc/lstm_bwd.cu
_MAX_SMEM = 227 * 1024
SEG_K = 4  # segment length of the backward; any K >= 1 works for any T

Params = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def stack_params(fwd: Params, bwd: Params) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(w_ih (2, 4H, I), w_hh (2, 4H, H), bias (2, 4H))`` of both directions."""
    return (torch.stack([fwd[0], bwd[0]]), torch.stack([fwd[1], bwd[1]]),
            torch.stack([fwd[2] + fwd[3], bwd[2] + bwd[3]]))


def _num_segments(t: int, k: int) -> int:
    return -(-t // k)


def _check_layer(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                 bias: torch.Tensor) -> tuple[int, int, int, int]:
    """Validate a layer's CUDA operands; returns ``(B, T, I, H)``."""
    device = x.device
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (B, T, I) tensor, got {tuple(x.shape)}")
    b, t, i = x.shape
    h = w_hh.shape[-1]
    if not 0 < 4 * h <= 1024:
        raise ValueError(f"hidden size {h}: the kernels run 4H <= 1024 threads")
    check_cuda_f32("x", x, device)
    check_cuda_f32("w_ih", w_ih, device, (2, 4 * h, i))
    check_cuda_f32("w_hh", w_hh, device, (2, 4 * h, h))
    check_cuda_f32("bias", bias, device, (2, 4 * h))
    return b, t, i, h


def _check_smem(floats: int, what: str) -> None:
    if 4 * floats > _MAX_SMEM:
        raise ValueError(f"{what}: {4 * floats} bytes of shared memory > {_MAX_SMEM}")


def _transposed(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(1, 2).contiguous()


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _launch_fwd(x, w_ih, w_hh, bias) -> torch.Tensor:
    b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    _check_smem(_ROWS_PER_BLOCK * (i + 5 * h), f"input width {i}")
    # bound to names: a temporary freed before the launch could be reused
    # by the next allocation while the kernel still reads it
    w_ih_t, w_hh_t = _transposed(w_ih), _transposed(w_hh)
    out = torch.empty(b, t, 2 * h, device=x.device, dtype=torch.float32)
    KERNEL.launch(x.device, ptr(x), ptr(w_ih_t), ptr(w_hh_t), ptr(bias), ptr(out), b, t, i, h)
    return out


class _FusedBiLSTM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wif, whf, bif, bhf, wib, whb, bib, bhb):
        fwd, bwd = (wif, whf, bif, bhf), (wib, whb, bib, bhb)
        w_ih, w_hh, bias = stack_params(fwd, bwd)
        if x.device.type == "cpu":
            h_seq = fused_bilstm_layer_plain(x, fwd, bwd)
        else:
            x = x.contiguous()
            h_seq = _launch_fwd(x, w_ih, w_hh, bias)
        ctx.save_for_backward(x, w_ih, w_hh, bias, h_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        x, w_ih, w_hh, bias, h_seq = ctx.saved_tensors
        dh_seq = dh_seq.contiguous()
        c_bnd = bilstm_cbnd(x, h_seq, w_ih, w_hh, bias, SEG_K)
        dx_pk, dw_cat = bilstm_segbwd(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias, SEG_K)
        i_dim, h = x.shape[-1], w_hh.shape[-1]
        dw_ih = dw_cat[:, :i_dim].transpose(1, 2)
        dw_hh = dw_cat[:, i_dim:i_dim + h].transpose(1, 2)
        db = dw_cat[:, i_dim + h]
        return (dx_pk[0] + dx_pk[1], dw_ih[0], dw_hh[0], db[0], db[0],
                dw_ih[1], dw_hh[1], db[1], db[1])


def fused_bilstm_layer(x: torch.Tensor, fwd: Params, bwd: Params) -> torch.Tensor:
    """One bidirectional LSTM layer, ``(B, T, I) -> (B, T, 2H)``, with its
    kernel backward.

    ``fwd``/``bwd`` are ``(w_ih (4H, I), w_hh (4H, H), b_ih (4H,),
    b_hh (4H,))`` in torch layout and (i, f, g, o) gate order. A CPU tensor
    takes the plain versions of the forward and of both backward kernels; a
    CUDA tensor launches the kernels, or raises.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BiLSTM kernel for device {x.device}")
    return _FusedBiLSTM.apply(x, *fwd, *bwd)


def fused_bilstm_layer_plain(x: torch.Tensor, fwd: Params, bwd: Params) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: two single-direction
    :func:`..ops.rnn.lstm` sweeps, concatenated."""
    from ..ops.rnn import lstm

    return torch.cat([lstm(x, *fwd), lstm(x, *bwd, reverse=True)], dim=-1)


# --------------------------------------------------------------------------
# backward (a): c checkpoints
# --------------------------------------------------------------------------


def _h_prev(h_seq: torch.Tensor, d: int, h: int) -> torch.Tensor:
    """h at the previous recurrence step of direction ``d``, per actual
    time: shifted right (d=0) or left (d=1) along T, zero at the start."""
    hd = h_seq[..., d * h:(d + 1) * h]
    zero = torch.zeros_like(hd[:, :1])
    return torch.cat([zero, hd[:, :-1]], 1) if d == 0 else torch.cat([hd[:, 1:], zero], 1)


def _gates(x, hp, w_ih, w_hh, bias):
    """Gate activations ``(i, f, g, o)`` from the input and the stored h_prev."""
    z = x @ w_ih.T + hp @ w_hh.T + bias
    i, f, g, o = z.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def _is_boundary(d: int, a: int, k: int) -> bool:
    return a % k == k - 1 if d == 0 else a % k == 0


def bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias, k: int = SEG_K) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_cbnd`."""
    b, t, _ = x.shape
    h = w_hh.shape[-1]
    out = x.new_zeros(2, _num_segments(t, k), b, h)
    for d in (0, 1):
        i, f, g, _ = _gates(x, _h_prev(h_seq, d, h), w_ih[d], w_hh[d], bias[d])
        c = x.new_zeros(b, h)
        for a in (range(t) if d == 0 else reversed(range(t))):
            c = f[:, a] * c + i[:, a] * g[:, a]
            if _is_boundary(d, a, k):
                out[d, a // k] = c
    return out


def bilstm_cbnd(x, h_seq, w_ih, w_hh, bias, k: int = SEG_K) -> torch.Tensor:
    """c checkpoints ``(2, NSEG, B, H)``, ``NSEG = ceil(T / k)``, rebuilt in
    recurrence order from ``x`` and the stored ``h_seq``. Slot ``m`` of
    direction 0 holds c at actual time ``m k + k - 1`` (the entry of block
    ``m + 1``); of direction 1, c at ``m k`` (the entry of block ``m - 1``).
    Slots no block reads are zero on the CPU and unspecified on the card."""
    if x.device.type == "cpu":
        return bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias, k)
    if x.device.type != "cuda":
        raise ValueError(f"no BiLSTM kernel for device {x.device}")
    b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    check_cuda_f32("h_seq", h_seq, x.device, (b, t, 2 * h))
    if k < 1:
        raise ValueError(f"segment length {k} < 1")
    _check_smem(_ROWS_PER_BLOCK * (i + 5 * h), f"input width {i}")
    w_ih_t, w_hh_t = _transposed(w_ih), _transposed(w_hh)
    out = torch.zeros(2, _num_segments(t, k), b, h, device=x.device, dtype=torch.float32)
    CBND_KERNEL.launch(x.device, ptr(x), ptr(h_seq), ptr(w_ih_t), ptr(w_hh_t), ptr(bias),
                       ptr(out), b, t, i, h, k)
    return out


# --------------------------------------------------------------------------
# backward (b): reverse sweep over K-step segments
# --------------------------------------------------------------------------


def bilstm_segbwd_plain(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias,
                        k: int = SEG_K) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bilstm_segbwd`, block by block as the
    kernel walks them."""
    b, t, i_dim = x.shape
    h = w_hh.shape[-1]
    nseg = _num_segments(t, k)
    dx_pk = x.new_zeros(2, b, t, i_dim)
    dw_cat = x.new_zeros(2, i_dim + h + 1, 4 * h)
    ones = x.new_ones(b, 1)
    for d in (0, 1):
        hp = _h_prev(h_seq, d, h)
        dh_c, dc_c = x.new_zeros(b, h), x.new_zeros(b, h)
        for gi in range(nseg):
            m = nseg - 1 - gi if d == 0 else gi
            rows = list(range(m * k, min(m * k + k, t)))  # recurrence order
            if d == 1:
                rows.reverse()
            c = x.new_zeros(b, h) if gi == nseg - 1 else c_bnd[d, m - 1 if d == 0 else m + 1]
            acts, cs = [], [c]
            for a in rows:
                ig, fg, gg, og = _gates(x[:, a], hp[:, a], w_ih[d], w_hh[d], bias[d])
                c = fg * c + ig * gg
                acts.append((ig, fg, gg, og))
                cs.append(c)
            for r in reversed(range(len(rows))):
                a = rows[r]
                ig, fg, gg, og = acts[r]
                dh = dh_seq[:, a, d * h:(d + 1) * h] + dh_c
                tc = torch.tanh(cs[r + 1])
                dc = dc_c + dh * og * (1 - tc * tc)
                dgates = torch.cat([dc * gg * ig * (1 - ig), dc * cs[r] * fg * (1 - fg),
                                    dc * ig * (1 - gg * gg), dh * tc * og * (1 - og)], dim=-1)
                dh_c = dgates @ w_hh[d]
                dc_c = dc * fg
                dx_pk[d, :, a] = dgates @ w_ih[d]
                dw_cat[d] += torch.cat([x[:, a], hp[:, a], ones], dim=-1).T @ dgates
    return dx_pk, dw_cat


def bilstm_segbwd(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias,
                  k: int = SEG_K) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse sweep: ``(dx_pk (2, B, T, I), dW_cat (2, I + H + 1, 4H))``
    from the output gradient ``dh_seq (B, T, 2H)`` and the checkpoints of
    :func:`bilstm_cbnd` at the same ``k``. ``dx = dx_pk[0] + dx_pk[1]``;
    rows ``:I`` of ``dW_cat[d]`` are ``dW_ih[d]^T``, rows ``I:I+H``
    ``dW_hh[d]^T`` and row ``I+H`` is ``db[d]``.

    The kernel accumulates dW_cat per batch tile of 8 rows (each tile in its
    own slice, no atomics); the tiles are summed here, so the result is
    deterministic but sums B*T terms in another order than the plain
    version."""
    if x.device.type == "cpu":
        return bilstm_segbwd_plain(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias, k)
    if x.device.type != "cuda":
        raise ValueError(f"no BiLSTM kernel for device {x.device}")
    b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    device = x.device
    nseg = _num_segments(t, k)
    check_cuda_f32("dh_seq", dh_seq, device, (b, t, 2 * h))
    check_cuda_f32("h_seq", h_seq, device, (b, t, 2 * h))
    check_cuda_f32("c_bnd", c_bnd, device, (2, nseg, b, h))
    if k < 1:
        raise ValueError(f"segment length {k} < 1")
    _check_smem(_ROWS_PER_BLOCK * (k * (i + 5 * h) + (k + 1) * h + 5 * h),
                f"segment length {k}, input width {i}")
    tiles = -(-b // _ROWS_PER_BLOCK)
    w_ih_t, w_hh_t = _transposed(w_ih), _transposed(w_hh)
    dx_pk = torch.empty(2, b, t, i, device=device, dtype=torch.float32)
    dw_part = torch.zeros(tiles, 2, i + h + 1, 4 * h, device=device, dtype=torch.float32)
    SEGBWD_KERNEL.launch(device, ptr(dh_seq), ptr(x), ptr(h_seq), ptr(c_bnd), ptr(w_ih_t),
                         ptr(w_hh_t), ptr(w_ih), ptr(w_hh), ptr(bias), ptr(dx_pk), ptr(dw_part),
                         b, t, i, h, k)
    return dx_pk, dw_part.sum(0)

"""Bidirectional LSTM layer, forward and backward: the Hopper kernels and
their plain versions.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/lstm.py``:
:func:`fused_bilstm_layer` has the JAX function's contract (torch-layout
weights in, ``(B, T, 2H)`` out in ``[fwd | bwd]`` order) and is a
``torch.autograd.Function``:

- forward: :func:`bilstm_fwd` (``_fwd_xproj_kernel``), the input
  projection as a tensor-core GEMM (:func:`bilstm_gemm`, ``csrc/lstm_gemm.cu``)
  then the recurrence over it on a thread-block cluster with ``W_hh``
  resident in shared memory (:func:`bilstm_rec`, ``csrc/lstm_fwd.cu``); it
  saves ``x``, the weights and ``h_seq`` only;
- backward: the JAX package's default (v9) backward, :func:`bilstm_v9_bwd`:
  the c checkpoints of :func:`bilstm_cbnd` (``_cbnd_kernel``: c at every
  K-th actual time step) then the reverse sweep of :func:`bilstm_segbwd`
  (``_segbwd_kernel``: K-step segments, emitting dx per direction and
  ``dW_cat = [x | h_prev | 1]^T dgates``). The gate activations, which both
  need, come from one tensor-core GEMM; c is then an elementwise scan over
  them (:func:`bilstm_cscan`, ``csrc/lstm_bwd.cu``), dx and dW_cat are GEMMs
  too, and only the dh carry and the cell backward run in a serial sweep on
  a cluster (:func:`bilstm_sweep`, ``csrc/lstm_bwd.cu``).

``schedule=`` picks one of the JAX package's five BiLSTM schedules, which
it reaches through process-wide switches (``MSA_LSTM_XPROJ``,
``MSA_LSTM_BWDC``, ``MSA_LSTM_SEGBWD``, ``MSA_LSTM_CBNDK``); all compute
the same function:

======== ============================================ ======================================================
schedule forward                                      backward
======== ============================================ ======================================================
``v9``   :func:`bilstm_fwd`                           :func:`bilstm_v9_bwd` (rows 9 and 11 on one gate GEMM)
``v9.1`` :func:`bilstm_fwd`                           :func:`bilstm_v9_bwd` with row 10 (``_cbndk_kernel``)
                                                      in row 9's place: the same kernels on the card
``v8``   :func:`bilstm_fwd`                           :func:`bilstm_v8_bwd`: rows 6 and 8 (``_cseq_kernel``,
                                                      ``_bwd_bwdc_kernel``) on one gate GEMM: the c scan
                                                      and the sweep at K=1, the dx and dW_cat GEMMs
``v6``   :func:`bilstm_fwd`                           :func:`bilstm_v6_bwd`: rows 6 and 7 (``_cseq_kernel``,
                                                      ``_bwd_xproj_kernel``) on one gate GEMM: the c scan
                                                      and the sweep at K=1; then dx, dW, db from ``dxp``
                                                      by ``einsum``
``v5``   ``xp = x W_cat^T + b_cat`` by ``matmul``,    :func:`bilstm_bwd_xp` (``_bwd_kernel``: the gates GEMM
         then :func:`bilstm_fwd_xp` (``_fwd_kernel``) over ``xp``, the sweep at K=1), then dW_hh from
                                                      ``dxp`` by ``einsum``; autograd takes ``dxp`` through
                                                      the projection
======== ============================================ ======================================================

Every schedule takes fp32 and bf16 (``TypeError`` for another dtype).
The JAX package's "v7" (``MSA_LSTM_BWDC=1, MSA_LSTM_SEGBWD=0``) runs the
v8 kernels. v9.1's time-blocked checkpoints (row 10) are the v9
checkpoints computed in blocks of :data:`CBNDK_ROWS` time rows; the
blocking is the TPU's (the gate products of a block batched in VMEM), and
on the card row 10 is row 9's pieces, the gates GEMM and the c scan, so
v9.1's layer backward launches v9's kernels. The full fp32 cell state of
v8, v6 and v5 is ``c_seq (2, T, B, H)``, and their packed gate gradients
``dxp (B, T, 8H)`` are ``[fwd | bwd]`` in actual time, the gradient of
``xp``. ``c_seq`` is the
checkpoints of :func:`bilstm_cbnd` at K = 1 (slot t holds c at actual time
t in both directions), so the kernels of those schedules are the v9
kernels' pieces at K = 1: row 6 is the gates GEMM then :func:`bilstm_cscan`
at K = 1; the reverse sweeps of v8 and v6 (rows 8 and 7) are the gates
GEMM, then :func:`bilstm_sweep` over ``c_seq``, and for row 8 the dx and
dW_cat GEMMs; v5's (row 5) is the GEMM's ``"gates_xp"`` product, the gates
from the projection ``xp``, then that sweep over the forward's ``c_seq``.
The v8 and v6 layer backwards compute the gate activations once for the
scan and the sweep, as v9's does for rows 9 and 11.

The port's layouts keep the batch first: ``x (B, T, I)``, ``h_seq
(B, T, 2H)``, checkpoints ``(2, NSEG, B, H)`` (direction, slot, batch,
unit), dx halves ``(2, B, T, I)``, ``dW_cat (2, I + H + 1, 4H)``. Stacked
weights are ``w_ih (2, 4H, I)``, ``w_hh (2, 4H, H)`` and ``bias (2, 4H)``
(``b_ih + b_hh``) in torch (i, f, g, o) order.

Every kernel and plain version also takes a leading model axis S on all of
these (``x (S, B, T, I)``, ``w_ih (S, 2, 4H, I)``, ...): one launch covers
all S models. Under ``torch.func.vmap`` (the LOSO trainer) the
Functions' ``vmap`` rules make that one S-wide launch; the backward runs
under ``vmap`` too, so each backward kernel is a Function of its own.
A CPU tensor takes the plain versions, a CUDA tensor launches the kernel or
raises.

Every kernel has an fp32 and a bf16 form, chosen by the dtype of ``x``
(or of ``xp`` under v5; the weights and ``h_seq``/``dh_seq`` must share
it; fp16 raises ``TypeError``). As in the JAX kernels, the bf16 form reads
bf16 and does all arithmetic in fp32: ``h`` and ``c`` are carried in fp32,
``h_seq`` is stored as bf16, and ``c_seq``, the c checkpoints, ``dxp``, the
dx halves and ``dW_cat`` are fp32; the layer's backward rounds dx and the
weight gradients to the inputs' dtype, as ``_xproj_bwd`` and
``_recurrence_bwd`` do. v5's projection ``xp`` is a bf16 matmul outside
the kernels, as in JAX, and rows 4 and 5 read it as bf16. The plain
versions compute in fp32 and store as the kernels store.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import (F32, F32_BF16, MAX_MODELS, CudaKernel, call_counts, check_cuda, kernel_forms,
                     models_first, ptr, upcast, with_models)

_P, _I = ctypes.c_void_p, ctypes.c_int
# fp32 and bf16 forms of each kernel, by the dtype of x. Rows 1, 9 and 11
# (bilstm_fwd, bilstm_cbnd, bilstm_segbwd), and rows 7 and 8 below, launch
# several kernels a call: their counts are calls, and each kernel they launch
# counts its own launches
KERNELS, CBND_KERNELS, SEGBWD_KERNELS = call_counts(), call_counts(), call_counts()
GEMM_KERNELS = kernel_forms("lstm_gemm", "msa_bilstm_gemm", [_I] + [_P] * 8 + [_I] * 6)
REC_KERNELS = kernel_forms("lstm_fwd", "msa_bilstm_rec", [_P] * 3 + [_I] * 8)
SWEEP_KERNELS = kernel_forms("lstm_bwd", "msa_bilstm_sweep", [_P] * 4 + [_I] * 9)
# row 9's c scan, one form: its input is the fp32 gate activations in both
CSCAN_KERNEL = CudaKernel("lstm_bwd", "msa_bilstm_cscan", [_P] * 2 + [_I] * 5)
KERNEL, CBND_KERNEL, SEGBWD_KERNEL, GEMM_KERNEL, REC_KERNEL, SWEEP_KERNEL = (
    k[torch.float32] for k in (KERNELS, CBND_KERNELS, SEGBWD_KERNELS, GEMM_KERNELS, REC_KERNELS,
                               SWEEP_KERNELS))
# the other schedules' kernels, fp32 and bf16, by the dtype of x (v5: of xp)
# row 4 (v5 forward): row 1's recurrence kernel with its c store, entry points of its own
FWD_XP_KERNELS = kernel_forms("lstm_fwd", "msa_bilstm_rec_cseq", [_P] * 4 + [_I] * 8)
# rows 5, 6, 7 and 8: calls of wrappers over the GEMM and the sweep or the c scan
# and row 10 (v9.1): a call of row 9's pieces
BWD_XP_KERNELS, CSEQ_KERNELS, BWD_SPLIT_KERNELS, BWDC_KERNELS, CBNDK_KERNELS = (
    call_counts() for _ in range(5))
FWD_XP_KERNEL, BWD_XP_KERNEL, CSEQ_KERNEL, BWD_SPLIT_KERNEL, BWDC_KERNEL, CBNDK_KERNEL = (
    k[torch.float32] for k in (FWD_XP_KERNELS, BWD_XP_KERNELS, CSEQ_KERNELS, BWD_SPLIT_KERNELS,
                               BWDC_KERNELS, CBNDK_KERNELS))

SCHEDULES = ("v5", "v6", "v8", "v9", "v9.1")

_MAX_SMEM = 227 * 1024
SEG_K = 4  # segment length of the backward; any K >= 1 works for any T
CBNDK_ROWS = 8  # time rows a block of v9.1's plain checkpoint walk (the JAX _CBND_K)
# the products of csrc/lstm_gemm.cu, by its mode number
GEMM_MODES = ("proj", "gates", "dx", "dw", "gates_xp")
_GEMM_TILE = 64  # kBm = kBn in csrc/lstm_gemm.cu
_GEMM_MAX_SPLITS = 8
# the cluster kernels (csrc/lstm_cluster.cuh): cluster sizes, largest first;
# batch tiles, largest first; their kRt batch rows per thread; kClusterMaxThreads
CLUSTER_SIZES = (8, 4, 2, 1)
_CLUSTER_TILES = (64, 32, 16, 8)
_CLUSTER_ROWS = (8, 4, 2)
_CLUSTER_MAX_THREADS = 512
H100_SMS = 132

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
    ``(S, B, T, I, H)``. The hidden size's limits are each kernel's own
    (:func:`cluster_plan`'s for the cluster kernels)."""
    device = x.device
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (B, T, I) or (S, B, T, I) tensor, "
                         f"got {tuple(x.shape)}")
    s, b, t, i = x.shape
    if s > MAX_MODELS:
        raise ValueError(f"{s} models > {MAX_MODELS}: the model axis is the grid's z axis")
    h = w_hh.shape[-1]
    check_cuda("x", x, device, dtypes=F32_BF16)
    check_cuda("w_ih", w_ih, device, (s, 2, 4 * h, i), (x.dtype,))
    check_cuda("w_hh", w_hh, device, (s, 2, 4 * h, h), (x.dtype,))
    check_cuda("bias", bias, device, (s, 2, 4 * h), (x.dtype,))
    return s, b, t, i, h


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (S, ..., K)`` times ``w (S, N, K)`` transposed, per model:
    ``(S, ..., N)``."""
    return torch.einsum("s...k,snk->s...n", a, w)


def _cluster_smem(kind: str, c: int, bt: int, r: int, h: int, esize: int) -> int:
    """Bytes of shared memory of one CTA of :func:`bilstm_rec`'s (``kind``
    "rec") or :func:`bilstm_sweep`'s ("sweep") kernel: ``W_hh``'s 4U rows of
    the CTA's units (U = H / C) in the storage type, and fp32 buffers of bt
    batch rows rounded up to a multiple of r. The wrappers pass it to the
    launcher, which lays the buffers out and refuses a launch whose count
    differs from its own."""
    u, rows, h4 = h // c, -(-bt // r) * r, -(-h // 4) * 4
    weights = -(-esize * 4 * u * (h4 if kind == "rec" else h) // 16) * 16
    if kind == "rec":  # h_{t-1} and h_t, rows padded to float4s
        return weights + 4 * 2 * rows * (h4 + 4)
    return weights + 4 * rows * ((4 * u + 4) + (h + 1))  # the dgates tile, the partial dh


@functools.lru_cache(maxsize=None)
def cluster_plan(kind: str, s: int, b: int, h: int, dtype: torch.dtype,
                 sms: int = H100_SMS) -> tuple[int, int, int]:
    """``(C, bt, r)``: the cluster size, batch tile and batch rows per
    thread of :func:`bilstm_rec` (``kind="rec"``) or :func:`bilstm_sweep`
    (``"sweep"``) for S models, B rows and hidden size H, from the shapes
    alone (no host sync).

    One cluster of C CTAs runs per (model, direction, tile of bt rows); a
    thread owns one of the CTA's H / C units and r of the tile's rows. A
    plan is feasible where C divides H, the CTA's ``W_hh`` slice and buffers
    fit the 227 KB of shared memory a block may use and it runs at most 512
    threads. Plans whose grid fits one wave of ``sms`` SMs come first. A
    step's serial work on an SM sub-partition is about r x 4H multiply-adds
    for each of its warps, so among those the plan taken minimises r x
    max(1, warps / 4) (times the waves, where none fits one), then takes the
    largest C, then the fewest CTAs. For the flagship layer (B=64, H=128)
    in fp32: (8, 16, 2) at S=1 (64 CTAs), (2, 64, 8) at S=24 (96 CTAs).
    Raises ``ValueError`` where nothing fits."""
    esize = torch.finfo(dtype).bits // 8
    best = None
    for c in CLUSTER_SIZES:
        if h % c:
            continue
        for bt in sorted({min(b, t) for t in _CLUSTER_TILES}, reverse=True):
            for r in _CLUSTER_ROWS:
                warps = -(-(-(-bt // r) * (h // c)) // 32)
                if (32 * warps > _CLUSTER_MAX_THREADS
                        or _cluster_smem(kind, c, bt, r, h, esize) > _MAX_SMEM):
                    continue
                ctas = c * 2 * s * -(-b // bt)
                key = (ctas > sms, r * max(1, warps / 4) * -(-ctas // sms), -c, ctas)
                if best is None or key < best[0]:
                    best = (key, (c, bt, r))
    if best is None:
        raise ValueError(f"hidden size {h}, {dtype}: no cluster of {CLUSTER_SIZES} CTAs holds "
                         f"W_hh in {_MAX_SMEM} bytes of shared memory each with at most "
                         f"{_CLUSTER_MAX_THREADS} threads")
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# --------------------------------------------------------------------------
# the tensor-core GEMM of rows 1 and 11
# --------------------------------------------------------------------------


def bilstm_gemm_plain(mode: str, x, w_ih, w_hh, bias, h_seq=None, dg=None,
                      xp=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_gemm`, in fp32."""
    one = (xp if mode == "gates_xp" else x).dim() == 3
    x, w_ih, w_hh, bias, h_seq, dg, xp = (None if a is None else upcast(a[None] if one else a)
                                          for a in (x, w_ih, w_hh, bias, h_seq, dg, xp))
    h = w_hh.shape[-1]
    g = 4 * h
    if mode == "gates_xp":
        out = torch.cat([torch.cat(_activations(xp[..., d * g:(d + 1) * g]
                                                + _mm(_h_prev(h_seq, d, h), w_hh[:, d])), -1)
                         for d in (0, 1)], -1)
    elif mode == "proj":
        out = _projection(x, w_ih, bias)
    elif mode == "gates":
        out = torch.cat([torch.cat(_gates(x, _h_prev(h_seq, d, h), w_ih[:, d], w_hh[:, d],
                                          bias[:, d]), -1) for d in (0, 1)], -1)
    elif mode == "dx":
        out = torch.stack([_mm(dg[..., d * g:(d + 1) * g], w_ih[:, d].transpose(1, 2))
                           for d in (0, 1)], 1)
    elif mode == "dw":
        ones = x.new_ones(x.shape[:-1] + (1,))
        out = torch.stack([torch.einsum("sbtr,sbtg->srg",
                                        torch.cat([x, _h_prev(h_seq, d, h), ones], -1),
                                        dg[..., d * g:(d + 1) * g]) for d in (0, 1)], 1)
    else:
        raise ValueError(f"unknown GEMM mode {mode!r}; one of {GEMM_MODES}")
    return out[0] if one else out


def _check_widths(i: int, h: int) -> None:
    """The GEMM reads its operands as 4-vectors: I and H multiples of 4."""
    if i % 4 or h % 4:
        raise ValueError(f"input width {i}, hidden size {h}: the BiLSTM GEMM reads 4-vectors, "
                         "so both must be multiples of 4")


def gemm_splits(s: int, rows: int, i: int, h: int, sms: int = H100_SMS) -> int:
    """Ranges of the B*T rows over which :func:`bilstm_gemm` ``"dw"`` splits
    its reduction: its 2S x ceil((I+H+1) / 64) x ceil(4H / 64) output tiles
    times the splits fill about four blocks a SM, each range at least 512
    rows, at most 8. For the flagship layer: 4 at S=1 (112 tiles), 2 at
    S=2, 1 from S=3 on."""
    tiles = 2 * s * -(-(i + h + 1) // _GEMM_TILE) * -(-4 * h // _GEMM_TILE)
    return max(1, min(_GEMM_MAX_SPLITS, 4 * sms // tiles, rows // 512))


def _gemm(mode: str, x, w_ih, w_hh, bias, h_seq, dg, out) -> None:
    """Launch one mode of the GEMM on validated, model-axis-first operands.
    ``dg`` is the packed operand: the fp32 dgates (``"dx"``, ``"dw"``) or
    ``xp`` in the dtype of ``w_hh`` (``"gates_xp"``, which reads no ``x``,
    ``w_ih`` or ``bias``: None). Its copies read 16-byte vectors (8-byte for
    bf16), so every operand starts on a 16-byte boundary."""
    s, b, t, i = x.shape if x is not None else (*h_seq.shape[:3], 0)
    h = w_hh.shape[-1]
    for name, a in (("x", x), ("h_seq", h_seq), ("w_ih", w_ih), ("w_hh", w_hh), ("dg", dg)):
        if a is not None and a.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    splits, part = 1, None
    if mode == "dw":
        splits = gemm_splits(s, b * t, i, h, _sm_count(x.device.index))
        if splits > 1:
            part = torch.empty((splits,) + tuple(out.shape), device=x.device,
                               dtype=torch.float32)
    GEMM_KERNELS[w_hh.dtype].launch(w_hh.device, GEMM_MODES.index(mode), ptr(x), ptr(h_seq),
                                    ptr(w_ih), ptr(w_hh), ptr(bias), ptr(dg), ptr(out), ptr(part),
                                    s, b, t, i, h, splits)


def bilstm_gemm(mode: str, x, w_ih, w_hh, bias, h_seq=None, dg=None, xp=None) -> torch.Tensor:
    """The time-parallel products of rows 1 and 11 (``csrc/lstm_gemm.cu``),
    and of rows 5 to 8 built from them, each per model and direction, fp32
    out (a leading S where ``x``, or ``xp``, has one), on stacked weights:

    - ``"proj"``: ``xp (B, T, 8H)``, ``x W_ih^T + b`` packed ``[fwd | bwd]``;
    - ``"gates"``: the gate activations ``(B, T, 8H)``, sigmoid (tanh for
      g) of ``[x | h_prev] W_cat^T + b``, ``h_prev`` the stored ``h_seq``
      shifted by direction as :func:`_h_prev` does, in the same packing;
    - ``"dx"``: ``dx_pk (2, B, T, I)``, ``dgates_d W_ih_d`` from the packed
      ``dg (B, T, 8H)`` fp32;
    - ``"dw"``: ``dW_cat (2, I + H + 1, 4H)``, ``[x | h_prev | 1]^T
      dgates_d``, reduced over the B*T rows in :func:`gemm_splits` fixed
      ranges whose partials a second kernel sums in rank order
      (deterministic, no atomics);
    - ``"gates_xp"``: the v5 gate activations ``(B, T, 8H)``, sigmoid (tanh
      for g) of ``xp + h_prev W_hh^T`` from the packed projection ``xp (B,
      T, 8H)`` in the dtype of ``w_hh`` (bf16 in the bf16 form, as the v5
      schedule's bf16 matmul writes it), in the packing of ``"gates"``; it
      reads no ``x``, ``w_ih`` or ``bias`` (they may be None), and ``xp`` is
      added after the product, not multiplied (K = H).

    fp32 operands run as 3xTF32 on the tensor cores (fp32-accurate), bf16
    ones as stored. A CPU tensor takes :func:`bilstm_gemm_plain`; a CUDA
    tensor launches the kernel, or raises."""
    lead = xp if mode == "gates_xp" else x
    if lead.device.type == "cpu":
        return bilstm_gemm_plain(mode, x, w_ih, w_hh, bias, h_seq, dg, xp)
    _check_device(lead)
    if mode not in GEMM_MODES:
        raise ValueError(f"unknown GEMM mode {mode!r}; one of {GEMM_MODES}")
    if mode == "gates_xp":
        (xp, h_seq, w_hh), one = with_models(xp, h_seq, w_hh)
        s, b, t, h = _check_xp(xp, w_hh)
        _check_widths(0, h)
        check_cuda("h_seq", h_seq, xp.device, (s, b, t, 2 * h), (w_hh.dtype,))
        out = _gate_activations_xp(xp, h_seq, w_hh)
        return out[0] if one else out
    one = x.dim() == 3
    x, w_ih, w_hh, bias, h_seq, dg = (None if a is None else a[None] if one else a
                                      for a in (x, w_ih, w_hh, bias, h_seq, dg))
    s, b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    _check_widths(i, h)
    for name, a, need, shape, dtypes in (
            ("h_seq", h_seq, mode in ("gates", "dw"), (s, b, t, 2 * h), (x.dtype,)),
            ("dg", dg, mode in ("dx", "dw"), (s, b, t, 8 * h), F32)):
        if need:
            if a is None:
                raise ValueError(f"GEMM mode {mode!r} needs {name}")
            check_cuda(name, a, x.device, shape, dtypes)
    shape = {"proj": (s, b, t, 8 * h), "gates": (s, b, t, 8 * h), "dx": (s, 2, b, t, i),
             "dw": (s, 2, i + h + 1, 4 * h)}[mode]
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    _gemm(mode, x, w_ih, w_hh, bias, h_seq, dg, out)
    return out[0] if one else out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def bilstm_fwd(x, w_ih, w_hh, bias) -> torch.Tensor:
    """The forward, row 1: ``h_seq (B, T, 2H)`` (or ``(S, B, T, 2H)``) on
    stacked weights, through the op ``msa_torch::bilstm_fwd``
    (:mod:`.library`). A CPU tensor takes :func:`bilstm_fwd_plain`; a CUDA
    tensor :func:`bilstm_fwd_cuda`, which launches two kernels or raises."""
    _check_device(x)
    return torch.ops.msa_torch.bilstm_fwd(x, w_ih, w_hh, bias)


def bilstm_fwd_cuda(x, w_ih, w_hh, bias) -> torch.Tensor:
    """``msa_torch::bilstm_fwd`` on the card: the input projection
    (:func:`bilstm_gemm` ``"proj"``) into a transient fp32 ``xp (S, B, T,
    8H)``, then the recurrence over it (:func:`bilstm_rec_cuda`), or raises
    before the first launch. One call counts one launch of
    ``KERNELS[dtype]``."""
    (x, w_ih, w_hh, bias), one = with_models(x, w_ih, w_hh, bias)
    s, b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    _check_widths(i, h)
    cluster_plan("rec", s, b, h, x.dtype, _sm_count(x.device.index))  # raises before any launch
    xp = torch.empty(s, b, t, 8 * h, device=x.device, dtype=torch.float32)
    _gemm("proj", x, w_ih, w_hh, bias, None, None, xp)
    out = bilstm_rec_cuda(xp, w_hh)
    KERNELS[x.dtype].launches += 1
    return out[0] if one else out


def bilstm_rec_plain(xp, w_hh) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_rec`: the recurrence step by
    step in fp32, ``h_seq`` in the dtype of ``w_hh``."""
    (xp, w32), one = with_models(xp, w_hh)
    out = _recurrence_plain(xp, w32)[0].to(w_hh.dtype)
    return out[0] if one else out


def bilstm_rec(xp, w_hh) -> torch.Tensor:
    """Row 1's recurrence (``csrc/lstm_fwd.cu``): ``h_seq (B, T, 2H)`` (or
    ``(S, B, T, 2H)``, in the dtype of ``w_hh``) from the packed fp32
    projection ``xp (B, T, 8H)`` (``[fwd | bwd]`` in actual time) and
    ``w_hh (2, 4H, H)``, through the op ``msa_torch::bilstm_rec``
    (:mod:`.library`). One cluster of C CTAs per (model, direction, batch
    tile), each CTA holding its units' rows of ``W_hh`` in shared memory for
    the whole sweep and exchanging h through distributed shared memory
    (:func:`cluster_plan`). A CPU tensor takes :func:`bilstm_rec_plain`; a
    CUDA tensor :func:`bilstm_rec_cuda`, which launches the kernel or
    raises."""
    _check_device(xp)
    return torch.ops.msa_torch.bilstm_rec(xp, w_hh)


def bilstm_rec_cuda(xp, w_hh) -> torch.Tensor:
    """``msa_torch::bilstm_rec`` on the card: one launch of the cluster
    recurrence, or raises."""
    (xp, w_hh), one = with_models(xp, w_hh)
    if xp.dim() != 4 or 0 in xp.shape:
        raise ValueError(f"xp must be a non-empty (B, T, 8H) or (S, B, T, 8H) tensor, "
                         f"got {tuple(xp.shape)}")
    s, b, t, _ = xp.shape
    h = w_hh.shape[-1]
    check_cuda("xp", xp, xp.device, (s, b, t, 8 * h))
    check_cuda("w_hh", w_hh, xp.device, (s, 2, 4 * h, h), F32_BF16)
    out = torch.empty(s, b, t, 2 * h, device=xp.device, dtype=w_hh.dtype)
    _launch_rec(REC_KERNELS[w_hh.dtype], xp, w_hh, out)
    return out[0] if one else out


def _launch_rec(kernel: CudaKernel, xp, w_hh, h_seq, c_seq=None) -> None:
    """One launch of the cluster recurrence over checked ``xp (S, B, T, 8H)``
    and ``w_hh (S, 2, 4H, H)`` into ``h_seq`` (and ``c_seq (S, 2, T, B, H)``,
    row 4's form), on the plan :func:`cluster_plan` makes for the shapes
    and the dtype of ``w_hh``, which raises where none fits."""
    s, b, t, _ = xp.shape
    h = w_hh.shape[-1]
    plan = cluster_plan("rec", s, b, h, w_hh.dtype, _sm_count(xp.device.index))
    args = (ptr(xp), ptr(w_hh), ptr(h_seq)) + ((ptr(c_seq),) if c_seq is not None else ())
    kernel.launch(xp.device, *args, s, b, t, h, *plan,
                  _cluster_smem("rec", *plan, h, w_hh.element_size()))


def _projection(x, w_ih, bias) -> torch.Tensor:
    """The packed input projection ``xp (S, B, T, 8H)``, ``[fwd | bwd]``,
    both halves in actual time."""
    return torch.cat([_mm(x, w_ih[:, d]) + bias[:, d, None, None] for d in (0, 1)], -1)


def _recurrence_plain(xp, w_hh) -> tuple[torch.Tensor, torch.Tensor]:
    """``(h_seq (S, B, T, 2H), c_seq (S, 2, T, B, H))`` of the recurrence
    over the packed projection ``xp``, step by step, h and c carried in
    fp32 whatever the operands' dtype."""
    xp, w_hh = upcast(xp), upcast(w_hh)
    s, b, t, _ = xp.shape
    h = w_hh.shape[-1]
    g = 4 * h
    h_seq = xp.new_zeros(s, b, t, 2 * h)
    c_seq = xp.new_zeros(s, 2, t, b, h)
    for d in (0, 1):
        hd = c = xp.new_zeros(s, b, h)
        for a in (range(t) if d == 0 else reversed(range(t))):
            i, f, gg, o = (xp[:, :, a, d * g:(d + 1) * g] + _mm(hd, w_hh[:, d])).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            hd = torch.sigmoid(o) * torch.tanh(c)
            h_seq[:, :, a, d * h:(d + 1) * h] = hd
            c_seq[:, d, a] = c
    return h_seq, c_seq


def bilstm_fwd_plain(x, w_ih, w_hh, bias) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the input projection in
    one product per direction, then the recurrence step by step, in fp32;
    ``h_seq`` comes back in the dtype of ``x``."""
    dtype = x.dtype
    (x, w_ih, w_hh, bias), one = with_models(*map(upcast, (x, w_ih, w_hh, bias)))
    out = _recurrence_plain(_projection(x, w_ih, bias), w_hh)[0].to(dtype)
    return out[0] if one else out


def fused_bilstm_layer_plain(x: torch.Tensor, fwd: Params, bwd: Params) -> torch.Tensor:
    """:func:`bilstm_fwd_plain` on torch-layout parameter tuples."""
    return bilstm_fwd_plain(x, *stack_params(fwd, bwd))


def check_schedule(schedule: str, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for a schedule not in :data:`SCHEDULES`, and
    ``TypeError`` for a dtype other than fp32 or bf16 (every schedule's
    kernels have those two forms)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown BiLSTM schedule {schedule!r}; one of {SCHEDULES}")
    if dtype not in F32_BF16:
        raise TypeError(f"BiLSTM schedule {schedule} takes float32 or bfloat16, not {dtype}")


class _FusedBiLSTM(torch.autograd.Function):
    """``h_seq`` of one layer on stacked weights, by :func:`bilstm_fwd`; its
    backward runs the backward kernels of the schedule recorded at the
    forward (v9, v9.1, v8 or v6): v9 and v9.1 through :func:`bilstm_v9_bwd`,
    which counts the schedule's checkpoint row."""

    @staticmethod
    def forward(x, w_ih, w_hh, bias, schedule):
        return bilstm_fwd(*(t.contiguous() for t in (x, w_ih, w_hh, bias)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:4], output)
        ctx.schedule = inputs[4]

    @staticmethod
    def backward(ctx, dh_seq):
        x, w_ih, w_hh, bias, h_seq = ctx.saved_tensors
        w = (w_ih, w_hh, bias)
        if ctx.schedule == "v6":
            # dxp is fp32; the reductions read the bf16 operands upcast, as
            # JAX's do (xf = x.astype(f32)), and round at the end
            dxp = _V6Bwd.apply(dh_seq, x, h_seq, *w)
            dg = dxp.unflatten(-1, (2, -1))  # (..., B, T, 2, 4H)
            return (torch.einsum("...btdg,...dgi->...bti", dg, upcast(w_ih)).to(x.dtype),
                    torch.einsum("...btdg,...bti->...dgi", dg, upcast(x)).to(w_ih.dtype),
                    _dw_hh_packed(h_seq, dxp).to(w_hh.dtype), dg.sum((-4, -3)).to(bias.dtype),
                    None)
        if ctx.schedule == "v8":
            dx_pk, dw_cat = _V8Bwd.apply(dh_seq, x, h_seq, *w)
        else:
            dx_pk, dw_cat = _V9Bwd.apply(dh_seq, x, h_seq, *w, SEG_K, ctx.schedule)
        i, h = x.shape[-1], w_hh.shape[-1]
        return ((dx_pk[0] + dx_pk[1]).to(x.dtype), dw_cat[:, :i].transpose(1, 2).to(w_ih.dtype),
                dw_cat[:, i:i + h].transpose(1, 2).to(w_hh.dtype), dw_cat[:, i + h].to(bias.dtype),
                None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return bilstm_fwd(*models_first(info, in_dims, *args)[:4]), 0


class _RecurrenceXp(torch.autograd.Function):
    """The v5 recurrence: ``(h_seq, c_seq)`` from the packed projection ``xp``
    by :func:`bilstm_fwd_xp`; its backward is :func:`bilstm_bwd_xp`'s fp32
    ``dxp`` (the gradient of ``xp``) and dW_hh reduced from it, each
    rounded to its input's dtype at the end (JAX's ``_recurrence_bwd``).
    ``c_seq`` takes no gradient."""

    @staticmethod
    def forward(xp, w_hh):
        return bilstm_fwd_xp(xp.contiguous(), w_hh.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output)

    @staticmethod
    def backward(ctx, dh_seq, _):
        xp, w_hh, h_seq, c_seq = ctx.saved_tensors
        dxp = _BwdXp.apply(dh_seq, xp, h_seq, c_seq, w_hh)
        return dxp.to(xp.dtype), _dw_hh_packed(h_seq, dxp).to(w_hh.dtype)

    @staticmethod
    def vmap(info, in_dims, *args):
        return bilstm_fwd_xp(*models_first(info, in_dims, *args)), (0, 0)


def _dw_hh_packed(h_seq: torch.Tensor, dxp: torch.Tensor) -> torch.Tensor:
    """dW_hh ``(..., 2, 4H, H)`` fp32 from ``h_seq (..., B, T, 2H)``, upcast,
    and the fp32 packed gate gradients ``dxp (..., B, T, 8H)``: the sum over
    (B, T) of ``dgates^T h_prev`` per direction (``dw_hh_packed`` in JAX)."""
    h_seq = upcast(h_seq)
    h = h_seq.shape[-1] // 2
    hp = torch.stack([_h_prev(h_seq, 0, h), _h_prev(h_seq, 1, h)], -2)  # (..., B, T, 2, H)
    return torch.einsum("...btdg,...btdk->...dgk", dxp.unflatten(-1, (2, -1)), hp)


def fused_bilstm_layer(x: torch.Tensor, fwd: Params, bwd: Params,
                       *, schedule: str = "v9") -> torch.Tensor:
    """One bidirectional LSTM layer, ``(B, T, I) -> (B, T, 2H)``, with its
    kernel backward.

    ``fwd``/``bwd`` are ``(w_ih (4H, I), w_hh (4H, H), b_ih (4H,),
    b_hh (4H,))`` in torch layout and (i, f, g, o) gate order. ``schedule``
    is one of :data:`SCHEDULES` (the module docstring's table); the
    autograd Function records it at the forward. A CPU tensor takes the
    plain versions of the schedule's kernels; a CUDA tensor launches the
    kernels, or raises. Under ``torch.func.vmap`` over S models every
    kernel is one S-wide launch.
    """
    _check_device(x)
    check_schedule(schedule, x.dtype)
    w_ih, w_hh, bias = stack_params(fwd, bwd)
    if schedule == "v5":
        # the JAX order: one projection of both directions, (B, T, 8H), a
        # matmul in the operands' dtype (bf16 xp in bf16, as in JAX)
        xp = x @ w_ih.flatten(0, 1).T + bias.flatten()
        return _RecurrenceXp.apply(xp, w_hh)[0]
    return _FusedBiLSTM.apply(x, w_ih, w_hh, bias, schedule)


# --------------------------------------------------------------------------
# backward (a): c checkpoints
# --------------------------------------------------------------------------


def _h_prev(h_seq: torch.Tensor, d: int, h: int) -> torch.Tensor:
    """h at the previous recurrence step of direction ``d``, per actual
    time: shifted right (d=0) or left (d=1) along T, zero at the start.
    ``h_seq (..., T, 2H)``."""
    hd = h_seq[..., d * h:(d + 1) * h]
    zero = torch.zeros_like(hd[..., :1, :])
    return (torch.cat([zero, hd[..., :-1, :]], -2) if d == 0
            else torch.cat([hd[..., 1:, :], zero], -2))


def _gates(x, hp, w_ih, w_hh, bias):
    """Gate activations ``(i, f, g, o)`` from the input and the stored
    h_prev, per model: ``x (S, ..., I)``, ``w_ih (S, 4H, I)``."""
    return _activations(_mm(x, w_ih) + _mm(hp, w_hh)
                        + bias.reshape(bias.shape[:1] + (1,) * (x.dim() - 2) + bias.shape[1:]))


def _activations(z):
    """``(i, f, g, o)``: sigmoid of the pre-activation ``z (..., 4H)``'s i, f
    and o quarters, tanh of its g quarter."""
    i, f, g, o = z.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def _is_boundary(d: int, a: int, k: int) -> bool:
    return a % k == k - 1 if d == 0 else a % k == 0


def bilstm_cscan_plain(act, k: int = SEG_K) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_cscan`: ``c = f c + i g`` step
    by step in recurrence order, fp32."""
    (act,), one = with_models(act)
    s, b, t, width = act.shape
    h = width // 8
    out = act.new_zeros(s, 2, _num_segments(t, k), b, h)
    for d in (0, 1):
        i, f, g, _ = act[..., 4 * d * h:4 * (d + 1) * h].chunk(4, dim=-1)
        c = act.new_zeros(s, b, h)
        for a in (range(t) if d == 0 else reversed(range(t))):
            c = f[:, :, a] * c + i[:, :, a] * g[:, :, a]
            if _is_boundary(d, a, k):
                out[:, d, a // k] = c
    return out[0] if one else out


def _check_act(act: torch.Tensor, k: int) -> tuple[int, int, int, int]:
    """Validate model-axis-first gate activations ``act (S, B, T, 8H)``
    fp32 and the segment length; returns ``(S, B, T, H)``."""
    if act.dtype != torch.float32:
        raise TypeError(f"act is {act.dtype}; the c scan takes float32 gate activations")
    if act.dim() != 4 or 0 in act.shape or act.shape[-1] % 8:
        raise ValueError(f"act must be a non-empty (B, T, 8H) or (S, B, T, 8H) tensor, "
                         f"got {tuple(act.shape)}")
    if k < 1:
        raise ValueError(f"segment length {k} < 1")
    s, b, t, width = act.shape
    return s, b, t, width // 8


def bilstm_cscan(act, k: int = SEG_K) -> torch.Tensor:
    """Row 9's c scan (``csrc/lstm_bwd.cu``): the checkpoints of
    :func:`bilstm_cbnd`, ``(2, NSEG, B, H)`` (or ``(S, 2, NSEG, B, H)``)
    fp32 in its slots, from the gate activations ``act (B, T, 8H)`` (or
    ``(S, B, T, 8H)``) fp32 of :func:`bilstm_gemm` ``"gates"``, ``[fwd |
    bwd]`` in (i, f, g, o) order. One thread per (model, direction, batch
    row, unit) walks T in recurrence order with c in a register; every slot
    is written, the ones no block reads with zero.

    ``TypeError`` for an ``act`` other than fp32, ``ValueError`` for another
    shape or ``k < 1``, on either device. A CPU tensor takes
    :func:`bilstm_cscan_plain`; a CUDA tensor launches the kernel, or
    raises."""
    (act,), one = with_models(act)
    s, b, t, h = _check_act(act, k)
    if act.device.type == "cpu":
        out = bilstm_cscan_plain(act, k)
    else:
        _check_device(act)
        check_cuda("act", act, act.device, (s, b, t, 8 * h))
        out = torch.empty(s, 2, _num_segments(t, k), b, h, device=act.device,
                          dtype=torch.float32)
        CSCAN_KERNEL.launch(act.device, ptr(act), ptr(out), s, b, t, h, k)
    return out[0] if one else out


def bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias, k: int = SEG_K) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_cbnd` (fp32): the gate
    activations, then the c scan."""
    return bilstm_cscan_plain(bilstm_gemm_plain("gates", x, w_ih, w_hh, bias, h_seq=h_seq), k)


def _check_gemm_layer(x, h_seq, w_ih, w_hh, bias) -> tuple[int, int, int, int, int]:
    """Validate a layer's model-axis-first CUDA operands for the gates GEMM;
    returns ``(S, B, T, I, H)``."""
    s, b, t, i, h = _check_layer(x, w_ih, w_hh, bias)
    _check_widths(i, h)
    check_cuda("h_seq", h_seq, x.device, (s, b, t, 2 * h), (x.dtype,))
    return s, b, t, i, h


def _gate_activations(x, h_seq, w_ih, w_hh, bias) -> torch.Tensor:
    """The gate activations ``(S, B, T, 8H)`` fp32 of validated operands, by
    the gates GEMM."""
    act = torch.empty(*x.shape[:3], 8 * w_hh.shape[-1], device=x.device, dtype=torch.float32)
    _gemm("gates", x, w_ih, w_hh, bias, h_seq, None, act)
    return act


def _gate_activations_xp(xp, h_seq, w_hh) -> torch.Tensor:
    """The v5 gate activations ``(S, B, T, 8H)`` fp32 of validated operands,
    by the GEMM's ``"gates_xp"`` product over the projection ``xp`` (read in
    its own dtype, fp32 or bf16)."""
    act = torch.empty(xp.shape, device=xp.device, dtype=torch.float32)
    _gemm("gates_xp", None, None, w_hh, None, h_seq, xp, act)
    return act


def bilstm_cbnd(x, h_seq, w_ih, w_hh, bias, k: int = SEG_K) -> torch.Tensor:
    """c checkpoints ``(2, NSEG, B, H)`` (or ``(S, 2, NSEG, B, H)``),
    ``NSEG = ceil(T / k)``, rebuilt in recurrence order from ``x`` and the
    stored ``h_seq``, in fp32. Slot ``m`` of direction 0 holds c at actual time
    ``m k + k - 1`` (the entry of block ``m + 1``); of direction 1, c at
    ``m k`` (the entry of block ``m - 1``). Slots no block reads are zero.

    A CPU tensor takes :func:`bilstm_cbnd_plain`; a CUDA tensor launches two
    kernels, or raises: the gate activations of every (b, t)
    (:func:`bilstm_gemm` ``"gates"``, bf16 x bf16 for bf16 operands) into a
    transient fp32 ``(S, B, T, 8H)`` buffer, then :func:`bilstm_cscan`. One
    call counts one launch of ``CBND_KERNELS[dtype]``."""
    if x.device.type == "cpu":
        return bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias, k)
    out = _gates_then_scan(x, h_seq, w_ih, w_hh, bias, k)
    CBND_KERNELS[x.dtype].launches += 1
    return out


def _gates_then_scan(x, h_seq, w_ih, w_hh, bias, k: int) -> torch.Tensor:
    """Rows 9, 10 and 6 on CUDA operands: the gate activations by the GEMM
    (its form by the dtype of ``x``), then :func:`bilstm_cscan` at ``k``;
    every check before the first launch."""
    _check_device(x)
    (x, h_seq, w_ih, w_hh, bias), one = with_models(x, h_seq, w_ih, w_hh, bias)
    _check_gemm_layer(x, h_seq, w_ih, w_hh, bias)
    if k < 1:
        raise ValueError(f"segment length {k} < 1")
    out = bilstm_cscan(_gate_activations(x, h_seq, w_ih, w_hh, bias), k)
    return out[0] if one else out


def _kernel_function(fn, out_dims, doc: str):
    """``fn`` (a backward kernel's wrapper) as an ``autograd.Function``
    whose ``vmap`` rule makes one S-wide call, so the layer's backward,
    which runs under ``vmap`` in the LOSO trainer, makes one launch for all
    S models. Not differentiable."""

    class KernelFunction(torch.autograd.Function):
        @staticmethod
        def forward(*args):
            return fn(*(a.contiguous() if isinstance(a, torch.Tensor) else a for a in args))

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, *grads):
            raise NotImplementedError("the BiLSTM backward kernels have no backward")

        @staticmethod
        def vmap(info, in_dims, *args):
            return fn(*models_first(info, in_dims, *args)), out_dims

    KernelFunction.__doc__ = doc
    return KernelFunction


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
                c = c_bnd[:, d, a] if k == 1 else fg * c + ig * gg  # K = 1: the full c
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

    A CUDA tensor launches four kernels, or raises: the gate activations of
    every (b, t) (:func:`bilstm_gemm` ``"gates"``) into an fp32 ``(S, B, T,
    8H)`` buffer, the serial sweep (:func:`bilstm_sweep`), which overwrites
    that buffer in place with dgates, then dx and dW_cat (``"dx"``,
    ``"dw"``). dW_cat is reduced over the B*T rows in fixed ranges summed
    in a fixed order (:func:`gemm_splits`): deterministic, no atomics, but
    summed in another order than the plain version. One call counts one
    launch of ``SEGBWD_KERNELS[dtype]``."""
    if x.device.type == "cpu":
        return bilstm_segbwd_plain(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias, k)
    _check_device(x)
    (x, dh_seq, h_seq, c_bnd, w_ih, w_hh, bias), one = with_models(
        x, dh_seq, h_seq, c_bnd, w_ih, w_hh, bias)
    s, b, t, _, h = _check_gemm_layer(x, h_seq, w_ih, w_hh, bias)
    _check_sweep(dh_seq, k, s, b, t, h, x.dtype, x.device)
    _check_c_bnd(c_bnd, k, s, b, t, h, x.device)
    cluster_plan("sweep", s, b, h, x.dtype, _sm_count(x.device.index))  # raises before any launch
    out = _dgates_products(_gate_activations(x, h_seq, w_ih, w_hh, bias), dh_seq, c_bnd, x, h_seq,
                           w_ih, w_hh, bias, k)
    SEGBWD_KERNELS[x.dtype].launches += 1
    return (out[0][0], out[1][0]) if one else out


def _dgates_products(act, dh_seq, c_bnd, x, h_seq, w_ih, w_hh, bias, k):
    """The sweep over the gate activations ``act``, which it overwrites with
    dgates, then dx and dW_cat from them by the GEMM, on validated
    model-axis-first operands: ``(dx_pk, dW_cat)``."""
    s, b, t, i = x.shape
    h = w_hh.shape[-1]
    bilstm_sweep(act, dh_seq, c_bnd, w_hh, k)  # act now holds dgates
    dx_pk = torch.empty(s, 2, b, t, i, device=x.device, dtype=torch.float32)
    _gemm("dx", x, w_ih, w_hh, bias, h_seq, act, dx_pk)
    dw_cat = torch.empty(s, 2, i + h + 1, 4 * h, device=x.device, dtype=torch.float32)
    _gemm("dw", x, w_ih, w_hh, bias, h_seq, act, dw_cat)
    return dx_pk, dw_cat


def bilstm_v9_bwd(dh_seq, x, h_seq, w_ih, w_hh, bias, k: int = SEG_K,
                  schedule: str = "v9") -> tuple[torch.Tensor, torch.Tensor]:
    """The v9 layer backward, rows 9 and 11 together: what
    ``bilstm_segbwd(dh_seq, x, h_seq, bilstm_cbnd(x, h_seq, w_ih, w_hh, bias,
    k), w_ih, w_hh, bias, k)`` returns; under ``schedule="v9.1"`` the v9.1
    layer backward, rows 10 and 11: the checkpoints of :func:`bilstm_cbndk`
    in row 9's place, the same values.

    A CPU tensor takes :func:`bilstm_cbnd_plain` (v9.1:
    :func:`bilstm_cbndk_plain`) then :func:`bilstm_segbwd_plain`. A CUDA
    tensor launches five kernels, or raises: the gate activations, computed
    once for both rows (:func:`bilstm_gemm` ``"gates"``), the c scan over
    them (:func:`bilstm_cscan`), the sweep, which overwrites them with
    dgates (:func:`bilstm_sweep`), then dx and dW_cat (``"dx"``, ``"dw"``).
    One call counts one launch of ``CBND_KERNELS[dtype]`` (v9.1:
    ``CBNDK_KERNELS[dtype]``) and one of ``SEGBWD_KERNELS[dtype]``."""
    if schedule not in ("v9", "v9.1"):
        raise ValueError(f"schedule {schedule!r}: v9 or v9.1")
    if x.device.type == "cpu":
        cbnd = bilstm_cbndk_plain if schedule == "v9.1" else bilstm_cbnd_plain
        c_bnd = cbnd(x, h_seq, w_ih, w_hh, bias, k)
        return bilstm_segbwd_plain(dh_seq, x, h_seq, c_bnd, w_ih, w_hh, bias, k)
    _check_device(x)
    (x, dh_seq, h_seq, w_ih, w_hh, bias), one = with_models(x, dh_seq, h_seq, w_ih, w_hh, bias)
    s, b, t, _, h = _check_gemm_layer(x, h_seq, w_ih, w_hh, bias)
    _check_sweep(dh_seq, k, s, b, t, h, x.dtype, x.device)
    cluster_plan("sweep", s, b, h, x.dtype, _sm_count(x.device.index))  # raises before any launch
    act = _gate_activations(x, h_seq, w_ih, w_hh, bias)
    out = _dgates_products(act, dh_seq, bilstm_cscan(act, k), x, h_seq, w_ih, w_hh, bias, k)
    (CBNDK_KERNELS if schedule == "v9.1" else CBND_KERNELS)[x.dtype].launches += 1
    SEGBWD_KERNELS[x.dtype].launches += 1
    return (out[0][0], out[1][0]) if one else out


def _check_sweep(dh_seq, k, s, b, t, h, dtype, device) -> None:
    if k < 1:
        raise ValueError(f"segment length {k} < 1")
    check_cuda("dh_seq", dh_seq, device, (s, b, t, 2 * h), (dtype,))


def _check_c_bnd(c_bnd, k, s, b, t, h, device) -> None:
    check_cuda("c_bnd", c_bnd, device, (s, 2, _num_segments(t, k), b, h), F32)


def bilstm_sweep_plain(act, dh_seq, c_bnd, w_hh, k: int = SEG_K) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_sweep`, in fp32; returns
    dgates and leaves ``act`` as it was."""
    (act, dh_seq, c_bnd, w_hh), one = with_models(*map(upcast, (act, dh_seq, c_bnd, w_hh)))
    s, b, t, _ = act.shape
    h = w_hh.shape[-1]
    g = 4 * h
    nseg = _num_segments(t, k)
    dg = act.new_zeros(s, b, t, 2 * g)
    for d in (0, 1):
        dh_c, dc_c = act.new_zeros(s, b, h), act.new_zeros(s, b, h)
        for gi in range(nseg):
            m = nseg - 1 - gi if d == 0 else gi
            rows = list(range(m * k, min(m * k + k, t)))  # recurrence order
            if d == 1:
                rows.reverse()
            c = (act.new_zeros(s, b, h) if gi == nseg - 1
                 else c_bnd[:, d, m - 1 if d == 0 else m + 1])
            cs = [c]
            for a in rows:
                ig, fg, gg, _ = act[:, :, a, d * g:(d + 1) * g].chunk(4, dim=-1)
                c = c_bnd[:, d, a] if k == 1 else fg * c + ig * gg  # K = 1: the full c
                cs.append(c)
            for r in reversed(range(len(rows))):
                a = rows[r]
                ig, fg, gg, og = act[:, :, a, d * g:(d + 1) * g].chunk(4, dim=-1)
                dh = dh_seq[:, :, a, d * h:(d + 1) * h] + dh_c
                tc = torch.tanh(cs[r + 1])
                dc = dc_c + dh * og * (1 - tc * tc)
                dgates = torch.cat([dc * gg * ig * (1 - ig), dc * cs[r] * fg * (1 - fg),
                                    dc * ig * (1 - gg * gg), dh * tc * og * (1 - og)], dim=-1)
                dh_c = dgates @ w_hh[:, d]
                dc_c = dc * fg
                dg[:, :, a, d * g:(d + 1) * g] = dgates
    return dg[0] if one else dg


def bilstm_sweep(act, dh_seq, c_bnd, w_hh, k: int = SEG_K) -> torch.Tensor:
    """Row 11's serial sweep (``csrc/lstm_bwd.cu``): the packed gate
    gradients dgates ``(B, T, 8H)`` (or ``(S, B, T, 8H)``) fp32, ``[fwd |
    bwd]`` in actual time, from the gate activations ``act`` of
    :func:`bilstm_gemm` ``"gates"`` (same shape, fp32), the output gradient
    ``dh_seq``, the checkpoints ``c_bnd`` of :func:`bilstm_cbnd` at the same
    ``k`` and ``w_hh``. Per K-segment in reverse recurrence order it rebuilds
    c from the checkpoint and the activations, runs the cell backward and
    carries dh through ``dgates W_hh``, on a cluster with ``W_hh`` resident
    in shared memory (:func:`cluster_plan`). At K = 1 the checkpoints are
    the full ``c_seq`` and each step reads its c from its own slot instead
    of rebuilding it, as the JAX K = 1 sweeps (``_bwd_kernel``,
    ``_bwd_xproj_kernel``, ``_bwd_bwdc_kernel``) read ``c_cur``.

    On a CUDA tensor the kernel overwrites ``act`` in place with dgates and
    returns it. A CPU tensor takes :func:`bilstm_sweep_plain`, which leaves
    ``act`` as it was."""
    if act.device.type == "cpu":
        return bilstm_sweep_plain(act, dh_seq, c_bnd, w_hh, k)
    _check_device(act)
    (act, dh_seq, c_bnd, w_hh), one = with_models(act, dh_seq, c_bnd, w_hh)
    if act.dim() != 4 or 0 in act.shape:
        raise ValueError(f"act must be a non-empty (B, T, 8H) or (S, B, T, 8H) tensor, "
                         f"got {tuple(act.shape)}")
    s, b, t, _ = act.shape
    h = w_hh.shape[-1]
    check_cuda("act", act, act.device, (s, b, t, 8 * h))
    check_cuda("w_hh", w_hh, act.device, (s, 2, 4 * h, h), F32_BF16)
    _check_sweep(dh_seq, k, s, b, t, h, w_hh.dtype, act.device)
    _check_c_bnd(c_bnd, k, s, b, t, h, act.device)
    plan = cluster_plan("sweep", s, b, h, w_hh.dtype, _sm_count(act.device.index))
    SWEEP_KERNELS[w_hh.dtype].launch(act.device, ptr(act), ptr(dh_seq), ptr(c_bnd), ptr(w_hh), s,
                                     b, t, h, k, *plan,
                                     _cluster_smem("sweep", *plan, h, w_hh.element_size()))
    return act[0] if one else act


_V9Bwd = _kernel_function(bilstm_v9_bwd, (0, 0), ":func:`bilstm_v9_bwd` as a Function.")


# --------------------------------------------------------------------------
# the other schedules' kernels (fp32 and bf16): v9.1 checkpoints (row 9's pieces); v8 and v6 full c
# (row 9's pieces at K = 1), the v8 and v6 reverse sweeps (row 11's pieces at
# K = 1) and their layer backwards; the v5 sweep that emits dxp (the same
# sweep over the gates from xp), the v5 forward (row 1's recurrence storing c)
# --------------------------------------------------------------------------


def bilstm_cbndk_plain(x, h_seq, w_ih, w_hh, bias, k: int = SEG_K) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_cbndk`, block by block as the
    JAX ``_cbndk_kernel`` walks them (:data:`CBNDK_ROWS` time rows): each
    block's gates in one product, then the c carry, in fp32."""
    (x, h_seq, w_ih, w_hh, bias), one = with_models(*map(upcast, (x, h_seq, w_ih, w_hh, bias)))
    s, b, t, _ = x.shape
    h = w_hh.shape[-1]
    out = x.new_zeros(s, 2, _num_segments(t, k), b, h)
    for d in (0, 1):
        hp = _h_prev(h_seq, d, h)
        c = x.new_zeros(s, b, h)
        blocks = range(0, t, CBNDK_ROWS)
        for lo in (blocks if d == 0 else reversed(blocks)):
            hi = min(lo + CBNDK_ROWS, t)
            i, f, g, _ = _gates(x[:, :, lo:hi], hp[:, :, lo:hi], w_ih[:, d], w_hh[:, d],
                                bias[:, d])
            for a in (range(lo, hi) if d == 0 else reversed(range(lo, hi))):
                c = f[:, :, a - lo] * c + i[:, :, a - lo] * g[:, :, a - lo]
                if _is_boundary(d, a, k):
                    out[:, d, a // k] = c
    return out[0] if one else out


def bilstm_cbndk(x, h_seq, w_ih, w_hh, bias, k: int = SEG_K) -> torch.Tensor:
    """The checkpoints of :func:`bilstm_cbnd`, same contract, in v9.1's
    schedule (the JAX package's ``_cbndk_kernel``: the gate products of
    :data:`CBNDK_ROWS` time rows batched a block, then the c carry).

    A CPU tensor takes :func:`bilstm_cbndk_plain`. A CUDA tensor launches
    row 9's two kernels, or raises before the first: the gate activations of
    every (b, t) (:func:`bilstm_gemm` ``"gates"``, which batches the
    products over all T rows, the whole of what the blocks batch) into a
    transient fp32 ``(S, B, T, 8H)`` buffer, then :func:`bilstm_cscan`. One
    call counts one launch of ``CBNDK_KERNELS[dtype]``."""
    if x.device.type == "cpu":
        return bilstm_cbndk_plain(x, h_seq, w_ih, w_hh, bias, k)
    out = _gates_then_scan(x, h_seq, w_ih, w_hh, bias, k)
    CBNDK_KERNELS[x.dtype].launches += 1
    return out


def bilstm_cseq_plain(x, h_seq, w_ih, w_hh, bias) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_cseq`: the checkpoints at K=1."""
    return bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias, 1)


def bilstm_cseq(x, h_seq, w_ih, w_hh, bias) -> torch.Tensor:
    """The full fp32 cell state ``c_seq (2, T, B, H)`` (or ``(S, 2, T, B,
    H)``; slot t is actual time t in both directions), rebuilt in
    recurrence order from ``x`` and the stored ``h_seq`` (the JAX package's
    v8 ``_cseq_kernel``, row 6): :func:`bilstm_cbnd` at K = 1.

    A CPU tensor takes :func:`bilstm_cseq_plain`. A CUDA tensor launches two
    kernels, or raises before the first: the gate activations
    (:func:`bilstm_gemm` ``"gates"``) into a transient fp32 ``(S, B, T,
    8H)`` buffer, then :func:`bilstm_cscan` at K = 1. One call counts one
    launch of ``CSEQ_KERNELS[dtype]``."""
    if x.device.type == "cpu":
        return bilstm_cseq_plain(x, h_seq, w_ih, w_hh, bias)
    out = _gates_then_scan(x, h_seq, w_ih, w_hh, bias, 1)
    CSEQ_KERNELS[x.dtype].launches += 1
    return out


def bilstm_bwdc_plain(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias):
    """Plain PyTorch version of :func:`bilstm_bwdc`: the reverse sweep at K=1."""
    return bilstm_segbwd_plain(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias, 1)


def bilstm_bwdc(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias) -> tuple[torch.Tensor, torch.Tensor]:
    """The v8 reverse sweep, row 8 (``_bwd_bwdc_kernel``): :func:`bilstm_segbwd`'s
    contract at K = 1, its checkpoints the full ``c_seq (2, T, B, H)`` of
    :func:`bilstm_cseq` (slot t is c at actual time t in both directions,
    the slots of :func:`bilstm_cbnd` at K = 1).

    A CPU tensor takes :func:`bilstm_bwdc_plain`. A CUDA tensor launches
    four kernels, or raises before the first: the gate activations
    (:func:`bilstm_gemm` ``"gates"``) into an fp32 ``(S, B, T, 8H)`` buffer,
    :func:`bilstm_sweep` at K = 1 over ``c_seq``, which overwrites them with
    dgates, then dx and dW_cat (``"dx"``, ``"dw"``; dW_cat summed over fixed
    row ranges, :func:`gemm_splits`). One call counts one launch of
    ``BWDC_KERNELS[dtype]``."""
    if x.device.type == "cpu":
        return bilstm_bwdc_plain(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias)
    _check_device(x)
    (x, dh_seq, h_seq, c_seq, w_ih, w_hh, bias), one = with_models(
        x, dh_seq, h_seq, c_seq, w_ih, w_hh, bias)
    _check_full_c(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias)
    out = _dgates_products(_gate_activations(x, h_seq, w_ih, w_hh, bias), dh_seq, c_seq, x, h_seq,
                           w_ih, w_hh, bias, 1)
    BWDC_KERNELS[x.dtype].launches += 1
    return (out[0][0], out[1][0]) if one else out


def _check_full_c(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias) -> None:
    """Validate rows 7 and 8's model-axis-first CUDA operands before any
    launch: the gates GEMM's (fp32 or bf16, one dtype), ``dh_seq`` in that
    dtype, the full fp32 ``c_seq`` (None where the layer backward makes it)
    and a cluster plan of the sweep."""
    s, b, t, _, h = _check_gemm_layer(x, h_seq, w_ih, w_hh, bias)
    _check_sweep(dh_seq, 1, s, b, t, h, x.dtype, x.device)
    if c_seq is not None:
        _check_c_seq(c_seq, s, b, t, h, x.device)
    cluster_plan("sweep", s, b, h, x.dtype, _sm_count(x.device.index))


def bilstm_v8_bwd(dh_seq, x, h_seq, w_ih, w_hh, bias) -> tuple[torch.Tensor, torch.Tensor]:
    """The v8 layer backward, rows 6 and 8 together: what
    ``bilstm_bwdc(dh_seq, x, h_seq, bilstm_cseq(x, h_seq, w_ih, w_hh, bias),
    w_ih, w_hh, bias)`` returns, ``(dx_pk, dW_cat)``, fp32.

    A CPU tensor takes :func:`bilstm_cseq_plain` then
    :func:`bilstm_bwdc_plain`. A CUDA tensor launches five kernels, or
    raises before the first: the gate activations, computed once for both
    rows (:func:`bilstm_gemm` ``"gates"``), the c scan over them at K = 1
    (:func:`bilstm_cscan`), the sweep at K = 1 over that ``c_seq``, which
    overwrites them with dgates (:func:`bilstm_sweep`), then dx and dW_cat
    (``"dx"``, ``"dw"``). One call counts one launch of
    ``CSEQ_KERNELS[dtype]`` and one of ``BWDC_KERNELS[dtype]``."""
    if x.device.type == "cpu":
        c_seq = bilstm_cseq_plain(x, h_seq, w_ih, w_hh, bias)
        return bilstm_bwdc_plain(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias)
    (x, dh_seq, h_seq, w_ih, w_hh, bias), one, act = _shared_gates(x, dh_seq, h_seq, w_ih, w_hh,
                                                                   bias)
    out = _dgates_products(act, dh_seq, bilstm_cscan(act, 1), x, h_seq, w_ih, w_hh, bias, 1)
    CSEQ_KERNELS[x.dtype].launches += 1
    BWDC_KERNELS[x.dtype].launches += 1
    return (out[0][0], out[1][0]) if one else out


def bilstm_v6_bwd(dh_seq, x, h_seq, w_ih, w_hh, bias) -> torch.Tensor:
    """The v6 layer backward's kernels, rows 6 and 7 together: what
    ``bilstm_bwd_split(dh_seq, x, h_seq, bilstm_cseq(x, h_seq, w_ih, w_hh,
    bias), w_ih, w_hh, bias)`` returns, ``dxp``, fp32.

    A CPU tensor takes :func:`bilstm_cseq_plain` then
    :func:`bilstm_bwd_split_plain`. A CUDA tensor launches three kernels, or
    raises before the first: the gate activations, computed once for both
    rows, the c scan over them at K = 1, then the sweep at K = 1 over that
    ``c_seq``, which overwrites them with dgates: that buffer is ``dxp``.
    One call counts one launch of ``CSEQ_KERNELS[dtype]`` and one of
    ``BWD_SPLIT_KERNELS[dtype]``."""
    if x.device.type == "cpu":
        c_seq = bilstm_cseq_plain(x, h_seq, w_ih, w_hh, bias)
        return bilstm_bwd_split_plain(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias)
    (x, dh_seq, h_seq, w_ih, w_hh, bias), one, act = _shared_gates(x, dh_seq, h_seq, w_ih, w_hh,
                                                                   bias)
    dxp = bilstm_sweep(act, dh_seq, bilstm_cscan(act, 1), w_hh, 1)
    CSEQ_KERNELS[x.dtype].launches += 1
    BWD_SPLIT_KERNELS[x.dtype].launches += 1
    return dxp[0] if one else dxp


def _shared_gates(x, dh_seq, h_seq, w_ih, w_hh, bias):
    """The v8 and v6 layer backwards' CUDA operands, model axis first and
    validated before any launch, whether the axis was added, and the gate
    activations they share."""
    _check_device(x)
    ops, one = with_models(x, dh_seq, h_seq, w_ih, w_hh, bias)
    x, dh_seq, h_seq, w_ih, w_hh, bias = ops
    _check_full_c(dh_seq, x, h_seq, None, w_ih, w_hh, bias)
    return ops, one, _gate_activations(x, h_seq, w_ih, w_hh, bias)


def _bwd_step_plain(dh_seq, pre, h_seq, c_seq, w_hh) -> torch.Tensor:
    """The per-step reverse sweep of :func:`bilstm_bwd_xp_plain` and
    :func:`bilstm_bwd_split_plain`, model axis first, in fp32: ``pre (S, B,
    T, 8H)`` is the gate pre-activation without its ``h_prev W_hh^T``
    term."""
    dh_seq, pre, h_seq, c_seq, w_hh = map(upcast, (dh_seq, pre, h_seq, c_seq, w_hh))
    s, b, t, _ = h_seq.shape
    h = w_hh.shape[-1]
    g = 4 * h
    dxp = pre.new_zeros(s, b, t, 2 * g)
    for d in (0, 1):
        hp = _h_prev(h_seq, d, h)
        dh_c, dc_c = pre.new_zeros(s, b, h), pre.new_zeros(s, b, h)
        for tau in reversed(range(t)):  # recurrence step, last first
            a = tau if d == 0 else t - 1 - tau
            z = pre[:, :, a, d * g:(d + 1) * g] + _mm(hp[:, :, a], w_hh[:, d])
            i, f, gg, o = z.chunk(4, dim=-1)
            i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
            cp = c_seq[:, d, a - 1 if d == 0 else a + 1] if tau else torch.zeros_like(dh_c)
            dh = dh_seq[:, :, a, d * h:(d + 1) * h] + dh_c
            tc = torch.tanh(c_seq[:, d, a])
            dc = dc_c + dh * o * (1 - tc * tc)
            dgates = torch.cat([dc * gg * i * (1 - i), dc * cp * f * (1 - f),
                                dc * i * (1 - gg * gg), dh * tc * o * (1 - o)], dim=-1)
            dh_c = dgates @ w_hh[:, d]
            dc_c = dc * f
            dxp[:, :, a, d * g:(d + 1) * g] = dgates
    return dxp


def _check_c_seq(c_seq, s, b, t, h, device) -> None:
    check_cuda("c_seq", c_seq, device, (s, 2, t, b, h), F32)


def bilstm_bwd_split_plain(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_bwd_split`."""
    (dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias), one = with_models(
        dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias)
    out = _bwd_step_plain(dh_seq, _projection(*map(upcast, (x, w_ih, bias))), h_seq, c_seq, w_hh)
    return out[0] if one else out


def bilstm_bwd_split(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias) -> torch.Tensor:
    """The v6 reverse sweep, row 7 (``_bwd_xproj_kernel``): the packed gate
    gradients ``dxp (B, T, 8H)`` (or ``(S, B, T, 8H)``) in fp32, ``[fwd |
    bwd]`` in actual time, from ``dh_seq``, ``x``, ``h_seq`` and the full
    ``c_seq`` of :func:`bilstm_cseq`. dx, dW and db are reductions of
    ``dxp`` outside the kernels.

    A CPU tensor takes :func:`bilstm_bwd_split_plain`. A CUDA tensor
    launches two kernels, or raises before the first: the gate activations
    (:func:`bilstm_gemm` ``"gates"``) into an fp32 ``(S, B, T, 8H)`` buffer,
    then :func:`bilstm_sweep` at K = 1 over ``c_seq``, which overwrites them
    with dgates: that buffer is ``dxp``. One call counts one launch of
    ``BWD_SPLIT_KERNELS[dtype]``."""
    if x.device.type == "cpu":
        return bilstm_bwd_split_plain(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias)
    _check_device(x)
    (dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias), one = with_models(
        dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias)
    _check_full_c(dh_seq, x, h_seq, c_seq, w_ih, w_hh, bias)
    dxp = bilstm_sweep(_gate_activations(x, h_seq, w_ih, w_hh, bias), dh_seq, c_seq, w_hh, 1)
    BWD_SPLIT_KERNELS[x.dtype].launches += 1
    return dxp[0] if one else dxp


def _check_xp(xp: torch.Tensor, w_hh: torch.Tensor) -> tuple[int, int, int, int]:
    """Validate the v5 kernels' ``xp (S, B, T, 8H)`` fp32 or bf16 and ``w_hh
    (S, 2, 4H, H)`` of the same dtype; returns ``(S, B, T, H)``. The hidden
    size's limits are :func:`cluster_plan`'s."""
    if xp.dim() != 4 or 0 in xp.shape:
        raise ValueError(f"xp must be a non-empty (B, T, 8H) or (S, B, T, 8H) tensor, "
                         f"got {tuple(xp.shape)}")
    s, b, t, _ = xp.shape
    h = w_hh.shape[-1]
    if s > MAX_MODELS:
        raise ValueError(f"{s} models > {MAX_MODELS}: the model axis is the grid's z axis")
    check_cuda("xp", xp, xp.device, (s, b, t, 8 * h), F32_BF16)
    check_cuda("w_hh", w_hh, xp.device, (s, 2, 4 * h, h), (xp.dtype,))
    return s, b, t, h


def bilstm_fwd_xp_plain(xp, w_hh) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bilstm_fwd_xp`: in fp32, ``h_seq``
    in the dtype of ``w_hh``, ``c_seq`` fp32."""
    (xp, w32), one = with_models(xp, w_hh)
    h_seq, c_seq = _recurrence_plain(xp, w32)
    h_seq = h_seq.to(w_hh.dtype)
    return (h_seq[0], c_seq[0]) if one else (h_seq, c_seq)


def bilstm_fwd_xp(xp, w_hh) -> tuple[torch.Tensor, torch.Tensor]:
    """The v5 forward, row 4 (``_fwd_kernel``): the recurrence over the
    packed projection ``xp (B, T, 8H)`` (``[fwd | bwd]``, both halves in
    actual time; or ``(S, B, T, 8H)``) and ``w_hh (2, 4H, H)``. Returns
    ``h_seq (B, T, 2H)`` in the dtype of ``w_hh`` and the fp32 cell state
    ``c_seq (2, T, B, H)`` (each with a leading S where ``xp`` has one).
    ``xp`` is fp32 or bf16 and ``w_hh`` of the same dtype: the bf16 form
    reads bf16 ``xp`` as stored, as JAX's ``_fwd_kernel`` does. Through the
    op ``msa_torch::bilstm_fwd_xp`` (:mod:`.library`).

    A CPU tensor takes :func:`bilstm_fwd_xp_plain`, a CUDA tensor
    :func:`bilstm_fwd_xp_cuda`."""
    _check_device(xp)
    return torch.ops.msa_torch.bilstm_fwd_xp(xp, w_hh)


def bilstm_fwd_xp_cuda(xp, w_hh) -> tuple[torch.Tensor, torch.Tensor]:
    """``msa_torch::bilstm_fwd_xp`` on the card: row 1's cluster recurrence
    on row 1's plan for the dtype, in its form that also stores c at every
    step (its bf16 form also reads bf16 ``xp``), or raises: where no cluster
    plan fits the hidden size."""
    (xp, w_hh), one = with_models(xp, w_hh)
    s, b, t, h = _check_xp(xp, w_hh)
    h_seq = torch.empty(s, b, t, 2 * h, device=xp.device, dtype=w_hh.dtype)
    c_seq = torch.empty(s, 2, t, b, h, device=xp.device, dtype=torch.float32)
    _launch_rec(FWD_XP_KERNELS[w_hh.dtype], xp, w_hh, h_seq, c_seq)
    return (h_seq[0], c_seq[0]) if one else (h_seq, c_seq)


def bilstm_bwd_xp_plain(dh_seq, xp, h_seq, c_seq, w_hh) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilstm_bwd_xp`, in fp32."""
    (dh_seq, xp, h_seq, c_seq, w_hh), one = with_models(dh_seq, xp, h_seq, c_seq, w_hh)
    out = _bwd_step_plain(dh_seq, xp, h_seq, c_seq, w_hh)
    return out[0] if one else out


def bilstm_bwd_xp(dh_seq, xp, h_seq, c_seq, w_hh) -> torch.Tensor:
    """The v5 reverse sweep, row 5 (``_bwd_kernel``): :func:`bilstm_bwd_split`'s
    contract, with each step's gates from ``xp + h_prev W_hh^T`` and the
    forward's full ``c_seq`` (:func:`bilstm_fwd_xp`). ``dxp`` is the
    gradient of ``xp``, fp32; ``xp``, ``h_seq``, ``dh_seq`` and ``w_hh`` share
    one dtype, fp32 or bf16.

    A CPU tensor takes :func:`bilstm_bwd_xp_plain`. A CUDA tensor launches
    two kernels, or raises before the first: the gate activations
    (:func:`bilstm_gemm` ``"gates_xp"``) into an fp32 ``(S, B, T, 8H)``
    buffer, then :func:`bilstm_sweep` at K = 1 over ``c_seq``, reading each
    step's c from it (the forward carried h in fp32: in bf16 the gates from
    the stored ``h_seq`` would not rebuild the forward's c), which
    overwrites them with dgates: that buffer is ``dxp``. The hidden size's
    limits are the sweep's :func:`cluster_plan`. One call counts one launch
    of ``BWD_XP_KERNELS[dtype]``."""
    if xp.device.type == "cpu":
        return bilstm_bwd_xp_plain(dh_seq, xp, h_seq, c_seq, w_hh)
    _check_device(xp)
    (dh_seq, xp, h_seq, c_seq, w_hh), one = with_models(dh_seq, xp, h_seq, c_seq, w_hh)
    _check_bwd_xp(dh_seq, xp, h_seq, c_seq, w_hh)
    dxp = bilstm_sweep(_gate_activations_xp(xp, h_seq, w_hh), dh_seq, c_seq, w_hh, 1)
    BWD_XP_KERNELS[xp.dtype].launches += 1
    return dxp[0] if one else dxp


def _check_bwd_xp(dh_seq, xp, h_seq, c_seq, w_hh) -> None:
    """Validate row 5's model-axis-first CUDA operands before any launch:
    ``xp``, ``w_hh``, ``h_seq`` and ``dh_seq`` of one dtype, fp32 or bf16,
    the GEMM's 4-vector hidden size, the full fp32 ``c_seq`` and a cluster
    plan of the sweep."""
    s, b, t, h = _check_xp(xp, w_hh)
    _check_widths(0, h)
    check_cuda("h_seq", h_seq, xp.device, (s, b, t, 2 * h), (xp.dtype,))
    _check_sweep(dh_seq, 1, s, b, t, h, xp.dtype, xp.device)
    _check_c_seq(c_seq, s, b, t, h, xp.device)
    cluster_plan("sweep", s, b, h, xp.dtype, _sm_count(xp.device.index))


_V8Bwd = _kernel_function(bilstm_v8_bwd, (0, 0), ":func:`bilstm_v8_bwd` as a Function.")
_V6Bwd = _kernel_function(bilstm_v6_bwd, 0, ":func:`bilstm_v6_bwd` as a Function.")
_BwdXp = _kernel_function(bilstm_bwd_xp, 0, ":func:`bilstm_bwd_xp` as a Function.")

"""EEG stem tail: BatchNorm + GELU + dropout + MaxPool over the conv output,
forward and backward.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/conv_stem_train.py``:
:func:`fused_stage_train` is a ``torch.autograd.Function`` whose forward is
``_fwd_kernel`` and whose backward is ``_bwd_kernel``, both in
``csrc/stem_tail.cu``:

- forward: one pass over ``conv (B, T, C)`` with the statistics it is
  given (folded per block into ``scale = gamma rsqrt(var + eps)`` and
  ``shift = beta - mean scale``), exact erf-GELU, dropout with p > 0 from
  an in-kernel Philox generator (no mask tensor exists), and
  ``MaxPool1d(pool)`` routed to the first max. A thread owns 4 consecutive
  channels of its pooled cells (several where the pool is shorter than 8)
  and keeps 8 of their window rows in flight as 16-byte vectors (8-byte in
  bf16). In train mode it also writes one int32 code per pooled cell:
  winner index + ``pool`` * keep bit.
- backward: the code routes ``dpool`` to the winner, one ``gelu_grad``,
  kept cells scaled by ``1 / (1 - p)``. A thread owns 4 channels of its
  pooled cells, as in the forward, with 8 window rows in flight; the kernel
  writes ``dy`` at the conv's full length (zeros in the tail rows no window
  covers) and per-chunk partial dgamma/dbeta, summed here in a fixed order.
  The BN input-gradient combine ``inv * gamma * (dy - dbeta/N - xhat *
  dgamma/N)`` stays in torch, as ``_fst_bwd`` keeps it in XLA.

The dropout mask on the card: element ``e`` of model ``s`` (its flat index
``(b T + t) C + c`` within the model) is kept iff word ``e mod 4`` of
Philox4x32-10 at counter ``e div 4`` under the key ``seed[s]`` is at least
``round(p 2^32)`` (:func:`keep_mask_plain`, the same stream in numpy). One
Philox call serves four elements. The seeds, one int64 per model, are drawn
on the device from a ``torch.Generator`` (:func:`stem_tail_fwd`) or given
(:func:`stem_tail_fwd_seeded`). The JAX package's TPU bits differ by
construction.

A tensor-parallel rank holds a channel shard of the conv output
(``channels=(c_off, c_full)``: its ``C`` channels are the layer's
``c_off .. c_off + C - 1`` of ``c_full``). Its element index is the whole
layer's, ``(b T + t) c_full + c_off + c``, so a shard's keep bits are the
unsharded tensor's columns, and one process's mask is drawn whichever way
the channels are split; on the CPU the mask drawn is the layer's whole
``torch.rand`` block, of which the shard keeps its columns. BatchNorm is
per channel, so the rest of the tail is exact on a shard. The kernel takes a
shard whose ``C``, ``c_off`` and ``c_full`` are multiples of 4 (a thread's
4 channels stay one Philox counter) and refuses any other.

Both kernels and their plain versions also take a leading model axis S:
``conv (S, B, T, C)`` with ``(S, C)`` statistics and affine parameters, one
Philox seed per model, and per-model codes and partials, all S models in
one launch. Under ``torch.func.vmap`` (with ``randomness="different"`` when
p > 0) the Functions' ``vmap`` rules make that one launch.

The statistics enter without gradient (the caller computes them under
``no_grad``): the combine already carries their dependence, as in JAX.

The plain versions take the keep mask as a tensor, so a test can feed the
same random numbers to both packages; on the CPU :func:`stem_tail_fwd`
draws that mask from the generator with ``torch.rand``.

Both kernels have an fp32 and a bf16 form, chosen by the dtype of ``conv``.
As in the JAX kernels, the bf16 form reads bf16 ``conv`` (and ``dpool``)
and runs the whole body in fp32: the per-channel statistics and affine
parameters enter in fp32 (the wrappers upcast them), the pooled output is
stored in ``conv``'s dtype, ``dy`` and the partials are fp32, and the
Function returns ``dconv``, ``dgamma`` and ``dbeta`` in their primals'
dtypes (``_fst_bwd``). The plain versions compute in fp32 and store as the
kernels store.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from ._build import (F32_BF16, MAX_MODELS, check_cuda, kernel_forms, models_first, ptr,
                     upcast, with_models)
from .conv_stem import gelu_max_pool

# fp32 and bf16 forms of each kernel, by the dtype of conv
KERNELS = kernel_forms("stem_tail", "msa_stem_tail",
                       [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_float, ctypes.c_uint]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7)
BWD_KERNELS = kernel_forms("stem_tail", "msa_stem_tail_bwd",
                           [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 6)
KERNEL, BWD_KERNEL = KERNELS[torch.float32], BWD_KERNELS[torch.float32]

# the backward's blocks (csrc/stem_tail.cu): 128 threads, 4 channels a
# thread, up to 32 channel groups a block, 8 window rows in flight a thread
_BWD_THREADS, _MAX_GROUPS, _SLOTS = 128, 32, 8
# blocks a backward launch aims for: a few waves of the H100's 132 SMs at 8
# resident blocks each, so that the last wave's tail is short
_BWD_BLOCKS = 4 * 132 * 8


def _keep_scale(p: float) -> float:
    return 1.0 / (1.0 - p) if p > 0.0 else 1.0


def _threshold(p: float) -> int:
    """Keep an element iff its 32 random bits are >= this (P = 1 - p)."""
    return min(int(round(p * 2.0 ** 32)), 2 ** 32 - 1)


# Philox4x32-10's multipliers and key increments (Salmon et al., SC'11)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = np.uint64(0xFFFFFFFF)


def philox4x32_plain(counter: np.ndarray, key: tuple[int, int]) -> np.ndarray:
    """Philox4x32-10 in numpy, as ``csrc/stem_tail.cu`` computes it: the
    four 32-bit words at each ``(N, 4)`` uint32 counter under the key
    ``(k0, k1)``, as ``(N, 4)`` uint32."""
    x = [np.asarray(counter, np.uint32)[:, i].astype(np.uint64) for i in range(4)]
    k0, k1 = (np.uint64(int(k) & 0xFFFFFFFF) for k in key)
    m0, m1 = map(np.uint64, _PHILOX_M)
    for _ in range(10):
        p0, p1 = x[0] * m0, x[2] * m1  # exact: both factors < 2^32
        x = [(p1 >> np.uint64(32)) ^ x[1] ^ k0, p1 & _U32,
             (p0 >> np.uint64(32)) ^ x[3] ^ k1, p0 & _U32]
        k0, k1 = (k0 + np.uint64(_PHILOX_W[0])) & _U32, (k1 + np.uint64(_PHILOX_W[1])) & _U32
    return np.stack(x, 1).astype(np.uint32)


def keep_mask_plain(seeds: torch.Tensor, shape, p: float,
                    channels: tuple[int, int] | None = None) -> torch.Tensor:
    """The stem-tail kernel's keep mask for a conv of ``shape`` ``(B, T, C)``
    or ``(S, B, T, C)`` under the per-model int64 ``seeds`` (one element for
    a 3-D shape), on the CPU: element ``e`` of model ``s`` (its flat index
    within the model) is kept iff word ``e mod 4`` of Philox4x32-10 at
    counter ``e div 4`` under the key ``seeds[s]`` (low word, high word) is
    ``>= round(p 2^32)``. ``channels=(c_off, c_full)``: the conv is the
    channel shard ``c_off .. c_off + C - 1`` of a layer of ``c_full``, whose
    mask is the layer's columns."""
    c_off, c_full = _channels(shape[-1], channels)
    if (c_off, c_full) != (0, shape[-1]):
        whole = keep_mask_plain(seeds, (*shape[:-1], c_full), p)
        return whole[..., c_off:c_off + shape[-1]].contiguous()
    n = int(np.prod(shape[-3:]))
    counter = np.zeros((-(-n // 4), 4), np.uint32)
    idx = np.arange(counter.shape[0], dtype=np.uint64)
    counter[:, 0], counter[:, 1] = idx & _U32, idx >> np.uint64(32)
    masks = []
    for seed in torch.as_tensor(seeds).reshape(-1).tolist():
        words = philox4x32_plain(counter, (seed, seed >> 32)).reshape(-1)[:n]
        masks.append(words >= _threshold(p))
    keep = torch.from_numpy(np.stack(masks)).reshape(len(masks), *shape[-3:])
    return keep[0] if len(shape) == 3 else keep


def _channels(c: int, channels: tuple[int, int] | None) -> tuple[int, int]:
    """``(c_off, c_full)`` of a conv of ``c`` channels: ``(0, c)`` for one
    held whole."""
    if channels is None:
        return 0, c
    c_off, c_full = channels
    if not 0 <= c_off <= c_full - c:
        raise ValueError(f"a shard of {c} channels from {c_off} does not fit in {c_full}")
    return c_off, c_full


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    """``(S, C)`` per-model channel values, broadcastable over ``(S, B, T, C)``."""
    return v[:, None, None, :]


def _check_args(conv, gamma, beta, mean, var, p: float, pool: int) -> None:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1)")
    if conv.dim() not in (3, 4) or 0 in conv.shape or not 1 <= pool <= conv.shape[-2]:
        raise ValueError(f"conv must be a non-empty (B, T, C) or (S, B, T, C) tensor with "
                         f"T >= pool {pool}")
    if conv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stem-tail kernel for device {conv.device}")
    if conv.device.type == "cuda":
        check_cuda("conv", conv, conv.device, dtypes=F32_BF16)
        for name, v in (("gamma", gamma), ("beta", beta), ("mean", mean), ("var", var)):
            check_cuda(name, v, conv.device, conv.shape[:-3] + conv.shape[-1:], F32_BF16)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def stem_tail_fwd(conv, gamma, beta, mean, var, p: float, pool: int, eps: float = 1e-5,
                  generator: torch.Generator | None = None, with_code: bool = True,
                  channels: tuple[int, int] | None = None):
    """The forward kernel: ``(pooled, code)``, ``code`` None unless
    ``with_code``. A CPU tensor takes :func:`fused_stage_train_plain` with
    a keep mask drawn by ``torch.rand`` from ``generator``; a CUDA tensor
    launches the kernel (its Philox seeds, one per model, drawn on the
    device from ``generator``), or raises. ``pooled`` comes back in
    ``conv``'s dtype. ``channels=(c_off, c_full)`` for a channel shard
    (module docstring)."""
    _check_args(conv, gamma, beta, mean, var, p, pool)
    c_off, c_full = _channels(conv.shape[-1], channels)
    if conv.device.type == "cpu":
        keep = None
        if p > 0.0:  # the layer's whole block of the stream, this shard's columns
            u = torch.rand((*conv.shape[:-1], c_full), generator=generator)
            keep = u[..., c_off:c_off + conv.shape[-1]] >= p
        res = fused_stage_train_plain(conv, gamma, beta, mean, var, pool, eps, p, keep,
                                      with_code)
        return res if with_code else (res, None)
    seeds = None
    if p > 0.0:  # drawn on the device: no host sync
        seeds = torch.randint(0, 2 ** 62, conv.shape[:-3] or (1,), device=conv.device,
                              dtype=torch.int64, generator=generator)
    return _launch_fwd(conv, gamma, beta, mean, var, p, pool, eps, seeds, with_code,
                       (c_off, c_full))


def stem_tail_fwd_seeded(conv, gamma, beta, mean, var, p: float, pool: int,
                         seeds: torch.Tensor, eps: float = 1e-5, with_code: bool = True,
                         channels: tuple[int, int] | None = None):
    """:func:`stem_tail_fwd` with its dropout seeds given: ``seeds`` int64,
    one per model (``(S,)``, or one element for a ``(B, T, C)`` conv), on
    ``conv``'s device. The keep mask is ``keep_mask_plain(seeds, conv.shape,
    p, channels)`` on either device: a CPU tensor takes the plain version fed
    that mask, a CUDA tensor the kernel, which draws the same bits."""
    _check_args(conv, gamma, beta, mean, var, p, pool)
    if p > 0.0 and (seeds.dtype != torch.int64 or seeds.device != conv.device
                    or seeds.numel() != (conv.shape[0] if conv.dim() == 4 else 1)
                    or not seeds.is_contiguous()):
        raise ValueError("seeds must be one contiguous int64 per model, on conv's device")
    if conv.device.type == "cpu":
        keep = keep_mask_plain(seeds, conv.shape, p, channels) if p > 0.0 else None
        res = fused_stage_train_plain(conv, gamma, beta, mean, var, pool, eps, p, keep,
                                      with_code)
        return res if with_code else (res, None)
    return _launch_fwd(conv, gamma, beta, mean, var, p, pool, eps, seeds, with_code,
                       _channels(conv.shape[-1], channels))


def _launch_fwd(conv, gamma, beta, mean, var, p, pool, eps, seeds, with_code, channels):
    """The forward kernel's launch on checked CUDA tensors: the outputs take
    ``conv``'s leading shape, so no model axis is added or taken away."""
    s = conv.shape[0] if conv.dim() == 4 else 1
    b, t, c = conv.shape[-3:]
    c_off, c_full = channels
    if b * t * c_full >= 2 ** 31 or b > 65535 or s > MAX_MODELS:
        raise ValueError(f"conv {tuple(conv.shape)}: the kernel takes B T C < 2^31 "
                         f"elements a model, B <= 65535 and S <= {MAX_MODELS}")
    if (c_off, c_full) != (0, c) and (c % 4 or c_off % 4 or c_full % 4):
        raise ValueError(f"a shard of {c} channels from {c_off} of {c_full}: the kernel takes "
                         "shards whose width, offset and layer width are multiples of 4")
    # the statistics and affine parameters enter in fp32, as the JAX kernel upcasts them
    gamma, beta, mean, var = (v if v.dtype == torch.float32 else v.float()
                              for v in (gamma, beta, mean, var))
    shape = (*conv.shape[:-2], t // pool, c)
    out = torch.empty(shape, device=conv.device, dtype=conv.dtype)
    code = torch.empty(shape, device=conv.device, dtype=torch.int32) if with_code else None
    KERNELS[conv.dtype].launch(
        conv.device, ptr(conv), ptr(gamma), ptr(beta), ptr(mean), ptr(var), eps,
        _keep_scale(p), _threshold(p), ptr(seeds), ptr(out), ptr(code), s, b, t, c, pool,
        c_full, c_off)
    return out, code


def fused_stage_train_plain(conv, gamma, beta, mean, var, pool: int, eps: float = 1e-5,
                            p: float = 0.0, keep: torch.Tensor | None = None,
                            with_code: bool = False):
    """Plain PyTorch version of the forward kernel. ``keep`` is the
    ``(B, T, C)`` (or ``(S, B, T, C)``) keep mask (True = kept), needed when
    ``p > 0``. Returns the pooled ``(B, T // pool, C)`` in ``conv``'s dtype
    (computed in fp32), or ``(pooled, code)`` with ``with_code``."""
    dtype = conv.dtype
    (conv, gamma, beta, mean, var), one = with_models(*map(upcast, (conv, gamma, beta, mean, var)))
    y = ((conv - _per_channel(mean)) * torch.rsqrt(_per_channel(var) + eps)
         * _per_channel(gamma) + _per_channel(beta))
    s, b, t, c = conv.shape
    t_out = t // pool
    if p == 0.0 and not with_code:
        out = gelu_max_pool(y.reshape(s * b, t, c), pool).reshape(s, b, t_out, c).to(dtype)
        return out[0] if one else out
    a = torch.nn.functional.gelu(y[:, :, : t_out * pool]).reshape(s, b, t_out, pool, c)
    kept = torch.ones_like(a, dtype=torch.bool)
    if p > 0.0:
        if keep is None:
            raise ValueError("p > 0 needs a keep mask")
        keep = keep[None] if one else keep
        kept = keep[:, :, : t_out * pool].reshape(s, b, t_out, pool, c)
        a = torch.where(kept, a * _keep_scale(p), 0.0)
    out, win = a.max(dim=3)  # first max wins, as torch MaxPool1d
    out = out.to(dtype)
    if with_code:
        kw = kept.gather(3, win[:, :, :, None]).squeeze(3)
        code = (win + pool * kw).to(torch.int32)
        return (out[0], code[0]) if one else (out, code)
    return out[0] if one else out


class _StemTail(torch.autograd.Function):
    """The stem tail; returns ``(pooled, code)`` when ``with_code``, else
    ``pooled``."""

    @staticmethod
    def forward(conv, gamma, beta, mean, var, p, pool, eps, generator, batch_stats, n_rows,
                sum_ranks, channels, with_code):
        out, code = stem_tail_fwd(conv, gamma, beta, mean, var, p, pool, eps, generator,
                                  with_code, channels)
        return (out, code) if with_code else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        conv, gamma, beta, mean, var, p, pool, eps, _, batch_stats, n_rows, sum_ranks, _, \
            with_code = inputs
        ctx.p, ctx.pool, ctx.eps, ctx.batch_stats = p, pool, eps, batch_stats
        ctx.n_rows, ctx.sum_ranks = n_rows, sum_ranks
        if with_code:
            ctx.mark_non_differentiable(output[1])
            ctx.save_for_backward(conv, gamma, beta, mean, var, output[1])

    @staticmethod
    def backward(ctx, dpool, *_):
        conv, gamma, beta, mean, var, code = ctx.saved_tensors
        p, pool, eps = ctx.p, ctx.pool, ctx.eps
        inv = torch.rsqrt(var + eps)
        scale = gamma * inv
        shift = beta - mean * scale
        dy, dg_part, db_part = _StemTailBwd.apply(conv, dpool, code, scale, shift, mean, inv,
                                                  p, pool)
        dgamma, dbeta = dg_part.sum(0), db_part.sum(0)
        n = conv.shape[0] * conv.shape[1] if ctx.n_rows is None else ctx.n_rows
        g_dgamma, g_dbeta = dgamma, dbeta
        if ctx.sum_ranks is not None:
            # global statistics: the batch-statistic terms of dconv sum over
            # every rank's rows; the dgamma and dbeta returned stay this
            # rank's, since the trainer sums every gradient over the ranks
            g_dgamma, g_dbeta = ctx.sum_ranks(torch.cat([dgamma, dbeta])).chunk(2, -1)
        if ctx.batch_stats:
            xhat = (upcast(conv) - mean) * inv
            dconv = (inv * gamma) * (dy - g_dbeta / n - xhat * (g_dgamma / n))
        else:  # constant statistics (the running stats of eval mode)
            dconv = (inv * gamma) * dy
        return (dconv.to(conv.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                None, None, None, None, None, None, None, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, conv, gamma, beta, mean, var, p, pool, eps, generator, batch_stats,
             n_rows, sum_ranks, channels, with_code):
        if p > 0.0 and info.randomness != "different":
            raise ValueError("stem-tail dropout under vmap draws one mask per model: "
                             "use randomness='different'")
        args = models_first(info, in_dims[:5], conv, gamma, beta, mean, var)
        out, code = stem_tail_fwd(*args, p, pool, eps, generator, with_code, channels)
        return ((out, code), (0, 0)) if with_code else (out, 0)


def fused_stage_train(conv: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor, p: float, pool: int,
                      eps: float = 1e-5,
                      generator: torch.Generator | None = None, batch_stats: bool = True,
                      n_rows: torch.Tensor | None = None,
                      sum_ranks: Callable[[torch.Tensor], torch.Tensor] | None = None,
                      channels: tuple[int, int] | None = None) -> torch.Tensor:
    """``(conv - mean) * rsqrt(var + eps) * gamma + beta`` -> erf-GELU ->
    dropout(p) -> ``MaxPool1d(pool)``; ``conv (B, T, C)`` NLC, the rest
    ``(C,)``. Returns ``(B, T // pool, C)``, differentiable in ``conv``,
    ``gamma`` and ``beta`` (pass ``mean``/``var`` without gradient).

    Dropout draws from ``generator`` (on the tensor's device; the default
    generator when None). A CPU tensor takes the plain versions; a CUDA
    tensor launches the kernels, or raises. The code for the backward is
    written when a gradient can flow, under autograd or under
    ``torch.func.grad``. Where none can and no ``torch.func`` transform is
    active (the eval forward), the forward runs without the Function,
    whose call costs the host more than the kernel takes at one model.

    ``batch_stats``: ``mean``/``var`` are the batch's own statistics (train
    mode), whose dependence on ``conv`` the backward carries; False for
    constant statistics (eval mode's running stats), whose backward is
    ``gamma rsqrt(var + eps)`` times the routed gradient alone. For the
    statistics of a batch spread over several ranks (batch data
    parallelism), ``n_rows`` is the (B, T) row count they were taken over
    and ``sum_ranks`` sums a tensor over those ranks (an all-reduce), so the
    backward's batch-statistic terms cover every rank's rows (one call of
    ``sum_ranks`` around the kernel); both None for a batch held whole.

    ``channels=(c_off, c_full)``: ``conv`` is a tensor-parallel rank's
    channel shard (module docstring); None for a layer held whole.
    """
    with_code = torch.is_grad_enabled() and any(
        v.requires_grad for v in (conv, gamma, beta))  # the backward's routing table
    if not with_code and not torch._C._are_functorch_transforms_active():
        return stem_tail_fwd(conv, gamma, beta, mean, var, float(p), pool, eps, generator,
                             with_code=False, channels=channels)[0]
    res = _StemTail.apply(conv, gamma, beta, mean, var, float(p), pool, eps, generator,
                          batch_stats, n_rows, sum_ranks, channels, with_code)
    return res[0] if with_code else res


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------


def stem_tail_bwd_plain(conv, dpool, code, scale, shift, mean, inv, p: float, pool: int):
    """Plain PyTorch version of :func:`stem_tail_bwd` (one partial chunk
    per model), in fp32."""
    conv, dpool, scale, shift, mean, inv = map(upcast, (conv, dpool, scale, shift, mean, inv))
    (conv, dpool, code, scale, shift, mean, inv), one = with_models(
        conv, dpool, code, scale, shift, mean, inv)
    s, b, t, c = conv.shape
    t_out = dpool.shape[2]
    code = code.long()
    jwin = code % pool
    x = conv[:, :, : t_out * pool].reshape(s, b, t_out, pool, c).gather(
        3, jwin[:, :, :, None]).squeeze(3)
    y = x * _per_channel(scale) + _per_channel(shift)
    phi = torch.exp(-0.5 * y * y) * 0.3989422804014327
    g = dpool * (0.5 * (1.0 + torch.erf(y * 0.7071067811865476)) + y * phi)
    g = torch.where(code >= pool, g * _keep_scale(p), 0.0)
    dy = torch.zeros(s, b, t, c, dtype=conv.dtype, device=conv.device)
    dy[:, :, : t_out * pool].view(s, b, t_out, pool, c).scatter_(3, jwin[:, :, :, None],
                                                                 g[:, :, :, None])
    xhat = (x - _per_channel(mean)) * _per_channel(inv)
    res = (dy, (g * xhat).sum((1, 2))[:, None], g.sum((1, 2))[:, None])
    return tuple(r[0] for r in res) if one else res


def bwd_plan(shape, pool: int) -> tuple[int, int]:
    """The backward kernel's row tiles for a conv of ``shape`` ``(S, B, T,
    C)``: ``(tile_rows, row_tiles)``, pooled rows a block and blocks a batch
    row (a channel-group tile). The partials have ``B * row_tiles`` chunks
    a model, chunk ``b * row_tiles + r`` summing pooled rows ``[r tile_rows,
    (r + 1) tile_rows)`` of batch row ``b``. A tile is a whole number of a
    block's passes (its thread rows times the cells each has in flight),
    and there are as few tiles as give the launch ``_BWD_BLOCKS`` blocks.
    Raises where the grid cannot hold the shape."""
    s, b, t, c = shape
    if b * t * c >= 2 ** 31 or b > 65535 or s > MAX_MODELS:
        raise ValueError(f"conv {tuple(shape)}: the backward kernel takes B T C < 2^31 "
                         f"elements a model, B <= 65535 and S <= {MAX_MODELS}")
    t_out = t // pool
    groups = -(-c // 4)
    gx = min(1 << (groups - 1).bit_length(), _MAX_GROUPS)
    cells = _SLOTS // pool if pool in (2, 4) else 1
    per_pass = _BWD_THREADS // gx * cells
    passes = -(-t_out // per_pass)
    want = -(-_BWD_BLOCKS // (s * b * -(-groups // gx)))
    per_tile = -(-passes // min(max(want, 1), passes))
    tile_rows = per_tile * per_pass
    return tile_rows, -(-t_out // tile_rows)


def _check_bwd_args(conv, dpool, code, scale, shift, mean, inv, pool: int) -> None:
    """Shapes and types of the backward's operands, on either device."""
    if conv.dim() not in (3, 4) or 0 in conv.shape or not 1 <= pool <= conv.shape[-2]:
        raise ValueError(f"conv must be a non-empty (B, T, C) or (S, B, T, C) tensor with "
                         f"T >= pool {pool}")
    pooled = (*conv.shape[:-2], conv.shape[-2] // pool, conv.shape[-1])
    if tuple(dpool.shape) != pooled or dpool.dtype != conv.dtype:
        raise ValueError(f"dpool must be {pooled} in conv's dtype {conv.dtype}")
    if code.dtype != torch.int32 or tuple(code.shape) != pooled:
        raise ValueError("code must be the forward's int32 (B, T // pool, C) tensor")
    per_model = (*conv.shape[:-3], conv.shape[-1])
    for name, v in (("scale", scale), ("shift", shift), ("mean", mean), ("inv", inv)):
        if tuple(v.shape) != per_model:
            raise ValueError(f"{name} must have shape {per_model}")


def stem_tail_bwd(conv, dpool, code, scale, shift, mean, inv, p: float, pool: int):
    """Winner-routed backward of the stem tail: ``(dy (B, T, C), dgamma
    partials (chunks, C), dbeta partials (chunks, C))``, each with a
    leading S where the inputs have one, all fp32; ``dy`` is 0 away from
    the winners and in the ``T - (T // pool) pool`` tail rows; the caller
    sums the partials over their chunk axis (:func:`bwd_plan` gives their
    layout). ``scale = gamma * inv`` and ``shift = beta - mean * scale``
    with ``inv = rsqrt(var + eps)``; ``dpool`` has ``conv``'s dtype and the
    per-channel values enter in fp32."""
    _check_bwd_args(conv, dpool, code, scale, shift, mean, inv, pool)
    if conv.device.type == "cpu":
        return stem_tail_bwd_plain(conv, dpool, code, scale, shift, mean, inv, p, pool)
    if conv.device.type != "cuda":
        raise ValueError(f"no stem-tail kernel for device {conv.device}")
    (conv, dpool, code, scale, shift, mean, inv), one = with_models(
        conv, dpool, code, *(upcast(v).contiguous() for v in (scale, shift, mean, inv)))
    device = conv.device
    s, b, t, c = conv.shape
    tile_rows, row_tiles = bwd_plan(conv.shape, pool)
    check_cuda("conv", conv, device, dtypes=F32_BF16)
    check_cuda("dpool", dpool, device, dtypes=(conv.dtype,))
    if code.device != device or not code.is_contiguous():
        raise ValueError("code must be contiguous, on conv's device")
    for name, v in (("scale", scale), ("shift", shift), ("mean", mean), ("inv", inv)):
        check_cuda(name, v, device)
    dy = torch.empty(s, b, t, c, device=device, dtype=torch.float32)
    dg_part = torch.empty(s, b * row_tiles, c, device=device, dtype=torch.float32)
    db_part = torch.empty(s, b * row_tiles, c, device=device, dtype=torch.float32)
    BWD_KERNELS[conv.dtype].launch(device, ptr(conv), ptr(dpool), ptr(code), ptr(scale),
                                   ptr(shift), ptr(mean), ptr(inv), _keep_scale(p), ptr(dy),
                                   ptr(dg_part), ptr(db_part), s, b, t, c, pool, tile_rows)
    return (dy[0], dg_part[0], db_part[0]) if one else (dy, dg_part, db_part)


class _StemTailBwd(torch.autograd.Function):
    """:func:`stem_tail_bwd` as a Function, so the stem tail's backward
    makes one S-wide launch when it runs under ``vmap``. Not
    differentiable."""

    @staticmethod
    def forward(conv, dpool, code, scale, shift, mean, inv, p, pool):
        return stem_tail_bwd(conv, dpool.contiguous(), code, scale, shift, mean, inv, p, pool)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the stem-tail backward kernel has no backward")

    @staticmethod
    def vmap(info, in_dims, *args):
        return stem_tail_bwd(*models_first(info, in_dims, *args)), (0, 0, 0)

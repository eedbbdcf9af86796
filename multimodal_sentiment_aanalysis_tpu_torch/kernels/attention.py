"""Flash multi-head attention: the Hopper kernels and their plain versions.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/attention.py``.
:func:`flash_mha` has the JAX function's contract: ``q (B, H, Tq, Dh)``,
``k, v (B, H, Tk, Dh)``, softmax attention with scale ``1/sqrt(Dh)``. It
keeps the JAX dispatch rule: when both lengths are at most 8 (every
attention site of the flagship model, and ME-MHACL's modality axis of 3) it
returns :func:`mha_reference`, plain tensor math, unless ``force=True``.
Above that it flattens to ``(B H, T, Dh)`` (``Dh`` zero-padded to the next
built head dim), scales ``q`` (:func:`scale_q`) and runs a
``torch.autograd.Function`` over three kernels, each with an fp32 and a
bf16 form:

- forward :func:`flash_fwd` (``_fwd_kernel``): online softmax over key
  tiles, saving the per-row log-sum-exp;
- backward :func:`flash_bwd_dq` (``_bwd_dq_kernel``, by query tile) and
  :func:`flash_bwd_dkv` (``_bwd_dkv_kernel``, by key tile), both
  recomputing ``P = exp(S - LSE)``; ``delta = rowsum(dO * O)`` is formed
  here by :func:`flash_delta` as the JAX ``_flash_bwd`` forms it, in the
  operands' dtype (for bf16 a bf16 row sum of the bf16 products, then
  handed to the kernels as fp32). Two kernels, no atomics: each output is
  owned by one CTA, so the gradients are deterministic.

The fp32 forms (``csrc/flash_attn.cu``) run their products on the tensor
cores in three TF32 passes (3xTF32 ``mma.sync``, fp32-accurate), as the
JAX kernels run fp32 at HIGHEST precision. The bf16 forms (the forward
``csrc/flash_attn_bf16.cu``, the backward ``csrc/flash_bwd_bf16.cu``) take
bf16 q, k, v and dO as the JAX kernels take them under
``Precision.DEFAULT``: one bf16 pass a product with fp32 accumulation, the
softmax state in fp32, P rounded to bf16 for P V, dS formed in fp32 and
rounded to bf16 for its products, O, dQ, dK and dV stored as bf16, LSE and
delta fp32. ``flash_mha`` scales a
bf16 ``q`` in bf16, as JAX's ``q * scale`` does. An fp16 input still runs
in fp32 and comes back as fp16 (no path of either package runs fp16).

What bounds the kernels on the H100 is their products (2, 3 and 4 of
them): at the attention phase's (512, 585, 32) the fp32 forms' bytes take
0.05-0.07 ms and their three TF32 passes 0.14-0.27 ms; the bf16 forms'
bytes 0.02-0.03 ms and their one pass 0.02-0.05 ms, as long as the exp of
each score (~0.04 ms a kernel at 16 a clock an SM). The fp32 design keeps
the operands a CTA owns as split TF32 fragments in registers (shared
memory at the wider heads), streams the other side through a ``cp.async``
ring, feeds each product's accumulator fragment straight into the next
``mma.sync`` and sums only 32 rows (dQ, dK/dV) or one tile (forward) on the
tensor cores before adding in fp32. The bf16 forms are Hopper's own, the
forward and the backward alike (``csrc/flash_sm90.cuh`` on
``csrc/sm90.cuh``): one persistent CTA an SM walks blocks of 128 own rows
(a head's blocks adjacent), a producer warpgroup streams the other side's
tiles by TMA through an mbarrier ring that runs on from block to block,
two consumer warpgroups of 64 rows run ``wgmma`` with the own rows as
register A fragments, feed P (and dS) from the accumulators to the next
product as its register operand, take their exps by ``ex2.approx.ftz`` and
issue the next sub-tile's products before this one's exps. The tensor maps
are encoded once for each pointer and shape and then taken from a cache.
Each source's head note has the detail.

``block_q`` and ``block_k`` are the kernels' tiles, one pair for the three
(the Function passes the same to each), multiples of 32 up to 128. A
kernel owns a tile of rows a CTA (one warp per 16) and streams a tile of
the other side (32, 64 or 128 rows, :data:`TILES`): the forward and dQ own
``block_q`` query rows and stream ``block_k`` keys, dK/dV owns ``block_k``
key rows and streams ``block_q`` queries. The bf16 kernels take their own
side in blocks of 128 rows whatever its own block (each output row is
independent and summed in one order, so no bit changes). Each kernel's
shared memory is counted here (:func:`fwd_smem`, :func:`dq_smem`,
:func:`dkv_smem`, each per form) and passed to its launcher, which refuses
a count other than its own; a pair that does not fit (the fp32 forward's 128-key tile at D = 128)
raises ``ValueError`` before any launch. The JAX defaults (512/1024) were
TPU v5e tunings; the port's are 64/64. Each wrapper takes the plain
version for a CPU tensor and launches the kernel of the tensor's dtype, or
raises, for a CUDA tensor. No path needs a ``vmap`` rule (every vmapped
attention is at length 1), so the Function raises under
``torch.func.vmap``.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import F32, CudaKernel, check_cuda, ptr, upcast

BF16 = torch.bfloat16


def _forms(symbol: str, pointers: int, bf16_source: str) -> dict[torch.dtype, CudaKernel]:
    """A kernel's fp32 form (``csrc/flash_attn.cu``) and bf16 form
    (``csrc/<bf16_source>.cu``, ``symbol + "_bf16"``), by the operands'
    dtype, each with its own launch count."""
    argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 7
    return {torch.float32: CudaKernel("flash_attn", symbol, argtypes),
            BF16: CudaKernel(bf16_source, symbol + "_bf16", argtypes)}


FWD_KERNELS = _forms("msa_flash_fwd", 5, "flash_attn_bf16")
DQ_KERNELS = _forms("msa_flash_bwd_dq", 7, "flash_bwd_bf16")
DKV_KERNELS = _forms("msa_flash_bwd_dkv", 8, "flash_bwd_bf16")

BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (8, 16, 32, 64, 128)  # the fp32 kernels' instantiations
BF16_HEAD_DIMS = (16, 32, 64, 128)  # the bf16 kernels' (a k16 step: 8 pads to 16)
MAX_ROWS = 128        # own rows a CTA: kFwdMaxThreads / 2, kBwdMaxThreads / 2
BF16_ROWS = 128       # own rows a work item of the bf16 kernels: kOwnRows
TILES = (32, 64, 128)  # streamed rows a tile (kBk, kBt)
_MAX_SMEM = 227 * 1024


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over ``(B, H, T, Dh)`` with scale ``1/sqrt(Dh)``."""
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    return p @ v


# --------------------------------------------------------------------------
# plain versions, over (BH, T, D) with q pre-scaled
# --------------------------------------------------------------------------
# A bf16 input takes the bf16 forms' rounding points: products of the bf16
# operands summed in fp32; P (forward, dK/dV) and dS (dQ, dK/dV) rounded to
# bf16 as the A operand of their products; O, dQ, dK and dV returned as
# bf16, LSE fp32. The forward's P is exp(S - m) of each row's max m, the
# kernel's at a single key tile.


def _bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two operands rounded to bf16, summed in fp32."""
    return a.to(BF16).float() @ b.to(BF16).float()


def flash_fwd_plain(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """``(O (BH, Tq, D), LSE (BH, Tq))`` of softmax(q kᵀ) v."""
    if q.dtype == BF16:
        s = _bf16_dot(q, k.transpose(-1, -2))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        return (_bf16_dot(p, v) / l).to(BF16), (m + torch.log(l)).squeeze(-1)
    s = q @ k.transpose(-1, -2)
    lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]) @ v, lse


def _probs_and_ds(q, k, v, do, lse, delta):
    if q.dtype == BF16:
        p = torch.exp(_bf16_dot(q, k.transpose(-1, -2)) - lse[..., None])
        return p, p * (_bf16_dot(do, v.transpose(-1, -2)) - delta[..., None])
    p = torch.exp(q @ k.transpose(-1, -2) - lse[..., None])
    return p, p * (do @ v.transpose(-1, -2) - delta[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta) -> torch.Tensor:
    """dQ of the pre-scaled ``q`` from the saved LSE and ``delta``."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta)
    if q.dtype == BF16:
        return _bf16_dot(ds, k).to(BF16)
    return ds @ k


def flash_bwd_dkv_plain(q, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` from the saved LSE and ``delta``."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta)
    if q.dtype == BF16:
        return (_bf16_dot(ds.transpose(-1, -2), q).to(BF16),
                _bf16_dot(p.transpose(-1, -2), do).to(BF16))
    return ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def flash_bwd_magnitudes(q, k, v, do, lse, delta) -> tuple[torch.Tensor, ...]:
    """The largest entries of dQ's, dK's and dV's sums of absolute terms,
    ``(P (|dP| + |delta|)) |K|``, ``(P (|dP| + |delta|))ᵀ |Q|`` and ``Pᵀ
    |dO|``: the scale the rounding error of each output grows with. Unlike
    the outputs' own largest entries they stay finite where dS cancels (at
    Tk = 1 dS is 0, and so are dQ and dK). The kernels' fp64 checks hold
    their errors to a share of these."""
    p = torch.exp(q @ k.transpose(-1, -2) - lse[..., None])
    m = p * ((do @ v.transpose(-1, -2)).abs() + delta.abs()[..., None])
    return ((m @ k.abs()).max(), (m.transpose(-1, -2) @ q.abs()).max(),
            (p.transpose(-1, -2) @ do.abs()).max())


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def _stages(stage: int) -> int:
    """A ring's depth: 3 stages of ``stage`` bytes, 2 where 3 would pass
    120 KiB (``kStages`` in ``csrc/flash_attn.cu``)."""
    return 3 if 3 * stage <= 120 * 1024 else 2


def _bf16_stages(stage: int) -> int:
    """The bf16 kernels' ring depth: as many stages of ``stage`` bytes as
    fit 64 KiB, 2 to 4 (``FwdPlan::kStages``, ``BwdPlan::kStages``)."""
    return min(4, max(2, 65536 // stage))


def fwd_smem(d: int, block_q: int, block_k: int, dtype: torch.dtype = torch.float32) -> int:
    """Bytes of shared memory of one forward CTA. fp32 (``FwdTile``,
    ``csrc/flash_attn.cu``): the ring of K and V tiles (``block_k`` rows of
    D + 4 floats each) and, at D = 128, the Q tile. bf16 (``FwdPlan``,
    ``csrc/flash_attn_bf16.cu``): 1024 bytes to align the tiles to the
    128-byte swizzle's period, the Q tile of 128 rows (whatever
    ``block_q``), a ring of 2-4 stages of a K and a V tile of ``block_k``
    unpadded bf16 rows (as many as fit 64 KiB), and 8 bytes an mbarrier (two
    for the Q tile, two a stage)."""
    if dtype == BF16:
        stage = 2 * block_k * 2 * d
        stages = _bf16_stages(stage)
        return 1024 + BF16_ROWS * 2 * d + stages * stage + 8 * (2 + 2 * stages)
    stage = 4 * 2 * block_k * (d + 4)
    return _stages(stage) * stage + (4 * block_q * (d + 4) if d > 64 else 0)


def _bwd_smem(d: int, rows: int, tile: int, dkv: bool, dtype: torch.dtype) -> int:
    """``BwdTile::smem`` (fp32, ``csrc/flash_attn.cu``) or ``BwdPlan::kSmem``
    (bf16, ``csrc/flash_bwd_bf16.cu``). fp32: the ring of streamed tiles
    (``tile`` rows of two operands, and for dK/dV the tile's fp32 LSE and
    delta) and, where they wait in shared memory, the CTA's own two operands;
    a row is D + 4 floats, the own operands wait there above D = 64 (dQ's Q
    and dO) or D = 32 (dK/dV's K and V), and at D = 128 the ring holds two
    stages of 32 rows whatever the tile, so that 128 own rows fit beside it.
    bf16: 1024 bytes to align the tiles to the 128-byte swizzle's period,
    the two own tiles of 128 rows (whatever ``rows``), a ring of 2-4 stages
    of two streamed tiles (as many as fit 64 KiB), unpadded bf16 rows, for
    dK/dV each stage's fp32 LSE and delta, for dQ the own rows', and 8 bytes
    an mbarrier (two for the own tiles, two a stage)."""
    if dtype == BF16:
        stage = 2 * tile * 2 * d
        stages = _bf16_stages(stage)
        cols, own_cols = (2 * 4 * tile, 0) if dkv else (0, 2 * 4 * BF16_ROWS)
        return (1024 + 2 * BF16_ROWS * 2 * d + stages * (stage + cols) + own_cols
                + 8 * (2 + 2 * stages))
    lse = 2 * 4 * tile if dkv else 0
    if d > 64:
        tile, lse = 32, 2 * 4 * 32 if dkv else 0
    stage = 4 * 2 * tile * (d + 4) + lse
    own_shared = d > (32 if dkv else 64)
    stages = 2 if d > 64 else _stages(stage)
    return stages * stage + (4 * 2 * rows * (d + 4) if own_shared else 0)


def dq_smem(d: int, block_q: int, block_k: int, dtype: torch.dtype = torch.float32) -> int:
    """Bytes of shared memory of one dQ CTA: ``block_q`` own query rows,
    key tiles of ``block_k``."""
    return _bwd_smem(d, block_q, block_k, False, dtype)


def dkv_smem(d: int, block_q: int, block_k: int, dtype: torch.dtype = torch.float32) -> int:
    """Bytes of shared memory of one dK/dV CTA: ``block_k`` own key rows,
    query tiles of ``block_q``."""
    return _bwd_smem(d, block_k, block_q, True, dtype)


_SMEM = {"fwd": fwd_smem, "dq": dq_smem, "dkv": dkv_smem}


def plan_smem(kernel: str, d: int, block_q: int, block_k: int,
              dtype: torch.dtype = torch.float32) -> int:
    """The shared memory of one CTA of ``kernel`` (``"fwd"``, ``"dq"`` or
    ``"dkv"``) in its ``dtype`` form at head dim ``d`` and these tiles,
    which its launcher checks byte for byte. Raises ``ValueError`` for a
    head dim or tile the kernels are not built for, or a plan over the 227
    KB a block may use."""
    dims = BF16_HEAD_DIMS if dtype == BF16 else HEAD_DIMS
    if d not in dims:
        raise ValueError(f"head dim {d}: the {dtype} kernels are built for {dims}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk % 32 or not 0 < blk <= MAX_ROWS:
            raise ValueError(f"{name} {blk}: a multiple of 32 up to {MAX_ROWS}")
    name, tile = ("block_q", block_q) if kernel == "dkv" else ("block_k", block_k)
    if tile not in TILES:
        raise ValueError(f"{name} {tile}: the {kernel} kernel streams tiles of {TILES} rows")
    smem = _SMEM[kernel](d, block_q, block_k, dtype)
    if smem > _MAX_SMEM:
        raise ValueError(f"{kernel} at D = {d}, block_q {block_q}, block_k {block_k}: {smem} "
                         f"bytes of shared memory > {_MAX_SMEM}")
    return smem


def _check(kernel: str, q, k, v, block_q: int, block_k: int,
           *rest) -> tuple[int, int, int, int, int]:
    """Validate the CUDA operands of ``kernel`` (:func:`plan_smem`'s names):
    q, k, v and dO all fp32 or all bf16, LSE and delta fp32; returns ``(BH,
    Tq, Tk, D, shared memory bytes)``."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dim() != 3 or 0 in q.shape:
        raise ValueError(f"q must be a non-empty (BH, T, D) tensor, got {tuple(q.shape)}")
    check_cuda("q", q, q.device, dtypes=tuple(FWD_KERNELS))
    bh, tq, d = q.shape
    tk = k.shape[1]
    smem = plan_smem(kernel, d, block_q, block_k, q.dtype)
    if bh > 2**31 - 1 or max(-(-tq // block_q), -(-tk // block_k)) > 65535:
        raise ValueError("too many tiles for the grid")
    check_cuda("k", k, q.device, (bh, tk, d), (q.dtype,))
    check_cuda("v", v, q.device, (bh, tk, d), (q.dtype,))
    for name, t, shape in rest:
        check_cuda(name, t, q.device, shape, (q.dtype,) if t.dim() == 3 else F32)
    rows = [("q", q), ("k", k), ("v", v)] + [(n, t) for n, t, _ in rest if t.dim() == 3]
    for name, t in rows:  # their tiles are copied as 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return bh, tq, tk, d, smem


def flash_fwd(q, k, v, block_q: int = BLOCK_Q,
              block_k: int = BLOCK_K) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(O, LSE)`` of pre-scaled ``q (BH, Tq, D)``,
    ``k, v (BH, Tk, D)``, all fp32 or all bf16 (O in their dtype, LSE fp32).
    A CPU tensor takes :func:`flash_fwd_plain`; a CUDA tensor launches the
    kernel's form of its dtype, or raises."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v)
    bh, tq, tk, d, smem = _check("fwd", q, k, v, block_q, block_k)
    o = torch.empty(bh, tq, d, device=q.device, dtype=q.dtype)
    lse = torch.empty(bh, tq, device=q.device, dtype=torch.float32)
    FWD_KERNELS[q.dtype].launch(q.device, ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
                                bh, tq, tk, d, block_q, block_k, smem)
    return o, lse


def _bwd_operands(q, do, lse, delta) -> tuple:
    rows = (q.shape[0], q.shape[1])
    return ("do", do, q.shape), ("lse", lse, rows), ("delta", delta, rows)


def flash_bwd_dq(q, k, v, do, lse, delta, block_q: int = BLOCK_Q,
                 block_k: int = BLOCK_K) -> torch.Tensor:
    """The dQ kernel (one CTA per ``block_q`` query rows): q, k, v, dO and
    dQ fp32 or bf16, LSE and delta fp32. A CPU tensor takes
    :func:`flash_bwd_dq_plain`; a CUDA tensor launches the kernel's form of
    its dtype, or raises."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    bh, tq, tk, d, smem = _check("dq", q, k, v, block_q, block_k,
                                 *_bwd_operands(q, do, lse, delta))
    dq = torch.empty_like(q)
    DQ_KERNELS[q.dtype].launch(q.device, ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
                               ptr(delta), ptr(dq), bh, tq, tk, d, block_q, block_k, smem)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, block_q: int = BLOCK_Q,
                  block_k: int = BLOCK_K) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel (one CTA per ``block_k`` key rows), dtypes as
    :func:`flash_bwd_dq`'s. A CPU tensor takes :func:`flash_bwd_dkv_plain`;
    a CUDA tensor launches the kernel's form of its dtype, or raises."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    bh, tq, tk, d, smem = _check("dkv", q, k, v, block_q, block_k,
                                 *_bwd_operands(q, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    DKV_KERNELS[q.dtype].launch(q.device, ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
                                ptr(delta), ptr(dk), ptr(dv), bh, tq, tk, d, block_q, block_k,
                                smem)
    return dk, dv


def flash_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` as the JAX ``_flash_bwd`` forms it, in the
    operands' dtype: for bf16 ``dO`` and ``O`` the bf16 products summed into
    a bf16 row sum, returned as fp32 for the kernels; otherwise in fp32."""
    if do.dtype == BF16:
        return (do * o).sum(-1).float()
    return (upcast(do) * upcast(o)).sum(-1)


class _FlashAttention(torch.autograd.Function):
    """``(O, LSE)`` of pre-scaled ``q``, ``k``, ``v`` ``(BH, T, D)``; the
    gradient flows through ``O`` only. The backward kernels are not
    differentiable, so a second-order gradient through them raises."""

    @staticmethod
    def forward(q, k, v, block_q, block_k):
        return flash_fwd(q, k, v, block_q, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, block_q, block_k = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.blocks = (block_q, block_k)

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(do, o)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *ctx.blocks)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ctx.blocks)
        return dq, dk, dv, None, None


def scale_q(q: torch.Tensor) -> torch.Tensor:
    """``q (..., Dh)`` times ``1/sqrt(Dh)``, as the JAX entry's ``q * scale``
    computes it: a bf16 ``q`` by the scale rounded to bf16 (JAX gives a
    Python scalar the array's dtype), one rounding of the exact product;
    any other dtype by the Python float."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == BF16:
        scale = float(torch.tensor(scale).to(BF16))
    return q * scale


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_q: int = BLOCK_Q,
              block_k: int = BLOCK_K, force: bool = False) -> torch.Tensor:
    """Attention over ``(B, H, T, Dh)`` with :func:`mha_reference`'s
    numerics: plain tensor math when both lengths are at most 8 (unless
    ``force``), else the flash kernels on a CUDA tensor and their plain
    versions on a CPU tensor.

    Like the JAX function it takes any head dim and floating dtype. bf16
    runs the bf16 forms, with ``q`` scaled in bf16 (:func:`scale_q`), and
    comes back as bf16; fp16 runs in fp32 and comes back as fp16. A head dim
    between the kernels' sizes is zero-padded to the next one
    (:data:`HEAD_DIMS`, :data:`BF16_HEAD_DIMS`; the zero columns add
    nothing to ``q kᵀ`` and give zero output columns, which are sliced off).
    Above 128 the kernels raise."""
    if not force and q.shape[2] <= 8 and k.shape[2] <= 8:
        return mha_reference(q, k, v)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    dtype = q.dtype
    if dtype != BF16:
        compute = torch.float32 if dtype == torch.float16 else dtype
        q, k, v = (t.to(compute) for t in (q, k, v))
    qs = scale_q(q)
    dims = BF16_HEAD_DIMS if dtype == BF16 else HEAD_DIMS
    width = next((d for d in dims if d >= dh), dh)
    if width != dh:
        qs, k, v = (F.pad(t, (0, width - dh)) for t in (qs, k, v))
    qf = qs.reshape(b * h, tq, width).contiguous()
    kf = k.reshape(b * h, tk, width).contiguous()
    vf = v.reshape(b * h, tk, width).contiguous()
    o, _ = _FlashAttention.apply(qf, kf, vf, block_q, block_k)
    o = o.reshape(b, h, tq, width)
    if width != dh:
        o = o[..., :dh]
    return o.to(dtype)

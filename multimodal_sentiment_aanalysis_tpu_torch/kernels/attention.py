"""Flash multi-head attention: the Hopper kernels and their plain versions.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/attention.py``.
:func:`flash_mha` has the JAX function's contract: ``q (B, H, Tq, Dh)``,
``k, v (B, H, Tk, Dh)``, softmax attention with scale ``1/sqrt(Dh)``. It
keeps the JAX dispatch rule: when both lengths are at most 8 (every
attention site of the flagship model, and ME-MHACL's modality axis of 3) it
returns :func:`mha_reference`, plain tensor math, unless ``force=True``.
Above that it flattens to ``(B H, T, Dh)`` (``Dh`` zero-padded to the next
built head dim), scales ``q`` and runs a ``torch.autograd.Function`` over
three kernels of ``csrc/flash_attn.cu``, all with their products on the
tensor cores in three TF32 passes (3xTF32 ``mma.sync``, fp32-accurate):

- forward :func:`flash_fwd` (``_fwd_kernel``): online softmax over key
  tiles, saving the per-row log-sum-exp;
- backward :func:`flash_bwd_dq` (``_bwd_dq_kernel``, by query tile) and
  :func:`flash_bwd_dkv` (``_bwd_dkv_kernel``, by key tile), both
  recomputing ``P = exp(S - LSE)``; ``delta = rowsum(dO * O)`` is taken
  here, as the JAX ``_flash_bwd`` takes it. Two kernels, no atomics: each
  output is owned by one CTA, so the gradients are deterministic.

What bounds the three on the H100 is their products (2, 3 and 4 of them):
at the attention phase's (512, 585, 32) the bytes take 0.05-0.07 ms and
the three TF32 passes 0.14-0.27 ms. The design keeps the operands a CTA
owns as split TF32 fragments in registers (shared memory at the wider
heads), streams the other side through a ``cp.async`` ring, feeds each
product's accumulator fragment straight into the next ``mma.sync`` and
sums only 32 rows (dQ, dK/dV) or one tile (forward) on the tensor cores
before adding in fp32; ``csrc/flash_attn.cu``'s head note has the detail.

``block_q`` and ``block_k`` are the kernels' tiles, one pair for the three
(the Function passes the same to each), multiples of 32 up to 128. A
kernel owns a tile of rows a CTA (one warp per 16) and streams a tile of
the other side (32, 64 or 128 rows, :data:`TILES`): the forward and dQ own
``block_q`` query rows and stream ``block_k`` keys, dK/dV owns ``block_k``
key rows and streams ``block_q`` queries. Each kernel's shared memory is
counted here (:func:`fwd_smem`, :func:`dq_smem`, :func:`dkv_smem`) and
passed to its launcher, which refuses a count other than its own; a pair
that does not fit (the forward's 128-key tile at D = 128) raises
``ValueError`` before any launch. The JAX defaults (512/1024) were TPU v5e tunings; the port's
are 64/64. Each wrapper takes the plain version for a CPU tensor and
launches the kernel, or raises, for a CUDA tensor. No path needs a
``vmap`` rule (every vmapped attention is at length 1), so the Function
raises under ``torch.func.vmap``.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import CudaKernel, check_cuda, ptr

FWD_KERNEL = CudaKernel(
    "flash_attn", "msa_flash_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7,
)
DQ_KERNEL = CudaKernel(
    "flash_attn", "msa_flash_bwd_dq", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7,
)
DKV_KERNEL = CudaKernel(
    "flash_attn", "msa_flash_bwd_dkv", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7,
)

BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernels' instantiations
MAX_ROWS = 128        # own rows a CTA: kFwdMaxThreads / 2, kBwdMaxThreads / 2
TILES = (32, 64, 128)  # streamed rows a tile (kBk, kBt)
_MAX_SMEM = 227 * 1024


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over ``(B, H, T, Dh)`` with scale ``1/sqrt(Dh)``."""
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    return p @ v


# --------------------------------------------------------------------------
# plain versions, over (BH, T, D) with q pre-scaled
# --------------------------------------------------------------------------


def flash_fwd_plain(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """``(O (BH, Tq, D), LSE (BH, Tq))`` of softmax(q kᵀ) v."""
    s = q @ k.transpose(-1, -2)
    lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]) @ v, lse


def _probs_and_ds(q, k, v, do, lse, delta):
    p = torch.exp(q @ k.transpose(-1, -2) - lse[..., None])
    return p, p * (do @ v.transpose(-1, -2) - delta[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta) -> torch.Tensor:
    """dQ of the pre-scaled ``q`` from the saved LSE and ``delta``."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta)
    return ds @ k


def flash_bwd_dkv_plain(q, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` from the saved LSE and ``delta``."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta)
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
    """A ring's depth: 3 stages of ``stage`` floats, 2 where 3 would pass
    120 KiB (``kStages`` in ``csrc/flash_attn.cu``)."""
    return 3 if 3 * 4 * stage <= 120 * 1024 else 2


def fwd_smem(d: int, block_q: int, block_k: int) -> int:
    """Bytes of shared memory of one forward CTA (``FwdTile::smem`` in
    ``csrc/flash_attn.cu``): the ring of K and V tiles (``block_k`` rows of
    D + 4 floats each) and, at D = 128, the Q tile."""
    stage = 2 * block_k * (d + 4)
    return 4 * (_stages(stage) * stage + (block_q * (d + 4) if d > 64 else 0))


def _bwd_smem(d: int, rows: int, tile: int, dkv: bool) -> int:
    """``BwdTile::smem``: the ring of streamed tiles (``tile`` rows of D + 4
    floats of two operands, and for dK/dV the tile's LSE and delta) and,
    where they wait in shared memory, the CTA's own two operands (dQ's Q and
    dO above D = 64, dK/dV's K and V above D = 32). At D = 128 the ring
    holds two stages of 32 rows whatever the tile, so that 128 own rows fit
    beside it."""
    if d > 64:
        tile = 32
    stage = 2 * tile * (d + 4) + (2 * tile if dkv else 0)
    own_shared = d > (32 if dkv else 64)
    stages = 2 if d > 64 else _stages(stage)
    return 4 * (stages * stage + (2 * rows * (d + 4) if own_shared else 0))


def dq_smem(d: int, block_q: int, block_k: int) -> int:
    """Bytes of shared memory of one dQ CTA: ``block_q`` own query rows,
    key tiles of ``block_k``."""
    return _bwd_smem(d, block_q, block_k, dkv=False)


def dkv_smem(d: int, block_q: int, block_k: int) -> int:
    """Bytes of shared memory of one dK/dV CTA: ``block_k`` own key rows,
    query tiles of ``block_q``."""
    return _bwd_smem(d, block_k, block_q, dkv=True)


_SMEM = {"fwd": fwd_smem, "dq": dq_smem, "dkv": dkv_smem}


def plan_smem(kernel: str, d: int, block_q: int, block_k: int) -> int:
    """The shared memory of one CTA of ``kernel`` (``"fwd"``, ``"dq"`` or
    ``"dkv"``) at head dim ``d`` and these tiles, which its launcher checks
    byte for byte. Raises ``ValueError`` for a head dim or tile the kernels
    are not built for, or a plan over the 227 KB a block may use."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels are built for {HEAD_DIMS}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk % 32 or not 0 < blk <= MAX_ROWS:
            raise ValueError(f"{name} {blk}: a multiple of 32 up to {MAX_ROWS}")
    name, tile = ("block_q", block_q) if kernel == "dkv" else ("block_k", block_k)
    if tile not in TILES:
        raise ValueError(f"{name} {tile}: the {kernel} kernel streams tiles of {TILES} rows")
    smem = _SMEM[kernel](d, block_q, block_k)
    if smem > _MAX_SMEM:
        raise ValueError(f"{kernel} at D = {d}, block_q {block_q}, block_k {block_k}: {smem} "
                         f"bytes of shared memory > {_MAX_SMEM}")
    return smem


def _check(kernel: str, q, k, v, block_q: int, block_k: int,
           *rest) -> tuple[int, int, int, int, int]:
    """Validate the CUDA operands of ``kernel`` (:func:`plan_smem`'s names);
    returns ``(BH, Tq, Tk, D, shared memory bytes)``."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dim() != 3 or 0 in q.shape:
        raise ValueError(f"q must be a non-empty (BH, T, D) tensor, got {tuple(q.shape)}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    smem = plan_smem(kernel, d, block_q, block_k)
    if bh > 2**31 - 1 or max(-(-tq // block_q), -(-tk // block_k)) > 65535:
        raise ValueError("too many tiles for the grid")
    check_cuda("q", q, q.device)
    check_cuda("k", k, q.device, (bh, tk, d))
    check_cuda("v", v, q.device, (bh, tk, d))
    for name, t, shape in rest:
        check_cuda(name, t, q.device, shape)
    rows = [("q", q), ("k", k), ("v", v)] + [(n, t) for n, t, _ in rest if t.dim() == 3]
    for name, t in rows:  # their tiles are copied as 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return bh, tq, tk, d, smem


def flash_fwd(q, k, v, block_q: int = BLOCK_Q,
              block_k: int = BLOCK_K) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(O, LSE)`` of pre-scaled ``q (BH, Tq, D)``,
    ``k, v (BH, Tk, D)``. A CPU tensor takes :func:`flash_fwd_plain`; a CUDA
    tensor launches the kernel, or raises."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v)
    bh, tq, tk, d, smem = _check("fwd", q, k, v, block_q, block_k)
    o = torch.empty(bh, tq, d, device=q.device, dtype=torch.float32)
    lse = torch.empty(bh, tq, device=q.device, dtype=torch.float32)
    FWD_KERNEL.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
                      bh, tq, tk, d, block_q, block_k, smem)
    return o, lse


def _bwd_operands(q, do, lse, delta) -> tuple:
    rows = (q.shape[0], q.shape[1])
    return ("do", do, q.shape), ("lse", lse, rows), ("delta", delta, rows)


def flash_bwd_dq(q, k, v, do, lse, delta, block_q: int = BLOCK_Q,
                 block_k: int = BLOCK_K) -> torch.Tensor:
    """The dQ kernel (one CTA per ``block_q`` query rows). A CPU tensor
    takes :func:`flash_bwd_dq_plain`; a CUDA tensor launches the kernel, or
    raises."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    bh, tq, tk, d, smem = _check("dq", q, k, v, block_q, block_k,
                                 *_bwd_operands(q, do, lse, delta))
    dq = torch.empty_like(q)
    DQ_KERNEL.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
                     bh, tq, tk, d, block_q, block_k, smem)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, block_q: int = BLOCK_Q,
                  block_k: int = BLOCK_K) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel (one CTA per ``block_k`` key rows). A CPU tensor
    takes :func:`flash_bwd_dkv_plain`; a CUDA tensor launches the kernel, or
    raises."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    bh, tq, tk, d, smem = _check("dkv", q, k, v, block_q, block_k,
                                 *_bwd_operands(q, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    DKV_KERNEL.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                      ptr(dk), ptr(dv), bh, tq, tk, d, block_q, block_k, smem)
    return dk, dv


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
        delta = (do * o).sum(-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *ctx.blocks)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ctx.blocks)
        return dq, dk, dv, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_q: int = BLOCK_Q,
              block_k: int = BLOCK_K, force: bool = False) -> torch.Tensor:
    """Attention over ``(B, H, T, Dh)`` with :func:`mha_reference`'s
    numerics: plain tensor math when both lengths are at most 8 (unless
    ``force``), else the flash kernels on a CUDA tensor and their plain
    versions on a CPU tensor.

    Like the JAX function it takes any head dim and floating dtype. A head
    dim between the kernels' sizes is zero-padded to the next one
    (:data:`HEAD_DIMS`; the zero columns add nothing to ``q kᵀ`` and give
    zero output columns, which are sliced off), and fp16 / bf16 operands run
    in fp32 and come back in their dtype. Above 128 the kernels raise."""
    if not force and q.shape[2] <= 8 and k.shape[2] <= 8:
        return mha_reference(q, k, v)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    dtype = q.dtype
    compute = torch.float32 if dtype in (torch.float16, torch.bfloat16) else dtype
    q, k, v = (t.to(compute) for t in (q, k, v))
    width = next((d for d in HEAD_DIMS if d >= dh), dh)
    if width != dh:
        q, k, v = (F.pad(t, (0, width - dh)) for t in (q, k, v))
    qf = (q * (1.0 / math.sqrt(dh))).reshape(b * h, tq, width).contiguous()
    kf = k.reshape(b * h, tk, width).contiguous()
    vf = v.reshape(b * h, tk, width).contiguous()
    o, _ = _FlashAttention.apply(qf, kf, vf, block_q, block_k)
    o = o.reshape(b, h, tq, width)
    if width != dh:
        o = o[..., :dh]
    return o.to(dtype)

"""Flash multi-head attention: the Hopper kernels and their plain versions.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/attention.py``.
:func:`flash_mha` has the JAX function's contract: ``q (B, H, Tq, Dh)``,
``k, v (B, H, Tk, Dh)``, softmax attention with scale ``1/sqrt(Dh)``. It
keeps the JAX dispatch rule: when both lengths are at most 8 (every
attention site of the flagship model, and ME-MHACL's modality axis of 3) it
returns :func:`mha_reference`, plain tensor math, unless ``force=True``.
Above that it flattens to ``(B H, T, Dh)`` (``Dh`` zero-padded to the next
built head dim), scales ``q`` and runs a ``torch.autograd.Function`` over
three kernels of ``csrc/flash_attn.cu``:

- forward :func:`flash_fwd` (``_fwd_kernel``): online softmax over key
  tiles on the tensor cores (3xTF32 ``mma.sync``, fp32-accurate), saving
  the per-row log-sum-exp;
- backward :func:`flash_bwd_dq` (``_bwd_dq_kernel``, by query tile) and
  :func:`flash_bwd_dkv` (``_bwd_dkv_kernel``, by key tile), both
  recomputing ``P = exp(S - LSE)`` on the CUDA cores; ``delta = rowsum(dO
  * O)`` is taken here, as the JAX ``_flash_bwd`` takes it.

``block_q`` and ``block_k`` are the kernels' tiles, one pair for the three
(the Function passes the same to each), multiples of 32: the forward's
query rows a CTA (at most 128, one warp per 16) and keys a tile (32, 64 or
128); the dQ kernel's query rows (threads) a block and staged key rows; the
dK/dV kernel's key rows (threads) a block and staged query rows. The JAX
defaults (512/1024) were TPU v5e tunings; the port's are 64/64. Each
wrapper takes the plain version for a CPU tensor and launches the kernel,
or raises, for a CUDA tensor. No path needs a ``vmap`` rule (every vmapped
attention is at length 1), so the Function raises under
``torch.func.vmap``.
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
    "flash_attn", "msa_flash_bwd_dq", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6,
)
DKV_KERNEL = CudaKernel(
    "flash_attn", "msa_flash_bwd_dkv", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6,
)

BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernels' instantiations
_MAX_THREADS = 256
_MAX_SMEM = 227 * 1024
FWD_KEY_TILES = (32, 64, 128)  # the forward's key tiles (kBk)
_FWD_MAX_ROWS = 128  # kFwdMaxThreads / 2 in csrc/flash_attn.cu


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


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def fwd_smem(d: int, block_q: int, block_k: int) -> int:
    """Bytes of shared memory of one forward CTA (``FwdTile::smem`` in
    ``csrc/flash_attn.cu``): a ring of 3 stages of K and V tiles (``block_k``
    rows of D + 4 floats each), 2 where 3 would pass 120 KiB, and at D = 128
    the Q tile. The wrapper passes it to the launcher, which refuses a launch
    whose count differs from its own."""
    stage = 2 * block_k * (d + 4)
    stages = 3 if 3 * 4 * stage <= 120 * 1024 else 2
    return 4 * (stages * stage + (block_q * (d + 4) if d > 64 else 0))


def _check(q, k, v, block_q: int, block_k: int, *rest,
           fwd: bool = False) -> tuple[int, int, int, int]:
    """Validate CUDA operands of the forward (``fwd``) or a backward kernel;
    returns ``(BH, Tq, Tk, D)``."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dim() != 3 or 0 in q.shape:
        raise ValueError(f"q must be a non-empty (BH, T, D) tensor, got {tuple(q.shape)}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels are built for {HEAD_DIMS}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk % 32 or not 0 < blk <= _MAX_THREADS:
            raise ValueError(f"{name} {blk}: a multiple of 32 up to {_MAX_THREADS} (threads)")
    if fwd and block_q > _FWD_MAX_ROWS:
        raise ValueError(f"block_q {block_q}: the forward takes at most {_FWD_MAX_ROWS} rows")
    if fwd and block_k not in FWD_KEY_TILES:
        raise ValueError(f"block_k {block_k}: the forward's key tiles are {FWD_KEY_TILES}")
    if bh > 2**31 - 1 or max(-(-tq // block_q), -(-tk // block_k)) > 65535:
        raise ValueError("too many tiles for the grid")
    smem = (fwd_smem(d, block_q, block_k) if fwd else
            4 * max(2 * block_k * d, 2 * block_q * d + 2 * block_q))
    if smem > _MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory > {_MAX_SMEM}")
    check_cuda("q", q, q.device)
    check_cuda("k", k, q.device, (bh, tk, d))
    check_cuda("v", v, q.device, (bh, tk, d))
    for name, t, shape in rest:
        check_cuda(name, t, q.device, shape)
    return bh, tq, tk, d


def flash_fwd(q, k, v, block_q: int = BLOCK_Q,
              block_k: int = BLOCK_K) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(O, LSE)`` of pre-scaled ``q (BH, Tq, D)``,
    ``k, v (BH, Tk, D)``, its products on the tensor cores in three TF32
    passes each (as accurate as fp32). A CPU tensor takes
    :func:`flash_fwd_plain`; a CUDA tensor launches the kernel, or
    raises."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v)
    bh, tq, tk, d = _check(q, k, v, block_q, block_k, fwd=True)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:  # the tiles are copied as 16-byte vectors
            raise ValueError(f"{name} must start on a 16-byte boundary")
    o = torch.empty(bh, tq, d, device=q.device, dtype=torch.float32)
    lse = torch.empty(bh, tq, device=q.device, dtype=torch.float32)
    FWD_KERNEL.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
                      bh, tq, tk, d, block_q, block_k, fwd_smem(d, block_q, block_k))
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, block_q: int = BLOCK_Q,
                 block_k: int = BLOCK_K) -> torch.Tensor:
    """The dQ kernel (one block per query tile). A CPU tensor takes
    :func:`flash_bwd_dq_plain`; a CUDA tensor launches the kernel, or
    raises."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    bh, tq, tk, d = _check(q, k, v, block_q, block_k, ("do", do, q.shape),
                           ("lse", lse, (q.shape[0], q.shape[1])),
                           ("delta", delta, (q.shape[0], q.shape[1])))
    dq = torch.empty_like(q)
    DQ_KERNEL.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
                     bh, tq, tk, d, block_q, block_k)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, block_q: int = BLOCK_Q,
                  block_k: int = BLOCK_K) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel (one block per key tile). A CPU tensor takes
    :func:`flash_bwd_dkv_plain`; a CUDA tensor launches the kernel, or
    raises."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    bh, tq, tk, d = _check(q, k, v, block_q, block_k, ("do", do, q.shape),
                           ("lse", lse, (q.shape[0], q.shape[1])),
                           ("delta", delta, (q.shape[0], q.shape[1])))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    DKV_KERNEL.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                      ptr(dk), ptr(dv), bh, tq, tk, d, block_q, block_k)
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

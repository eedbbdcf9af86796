"""Serving conv stem stage: Conv1d + folded BatchNorm + GELU + MaxPool.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/conv_stem.py``:
:func:`fused_conv_bn_gelu_pool` runs ``_stage_kernel``'s computation as the
CUDA kernel in ``csrc/conv_stem.cu``, so the conv output never reaches
device memory. ``eval/serving.py`` reaches it with ``use_pallas=True``.

The kernel is an implicit GEMM a batch row on the tensor cores: M = the
conv positions, N = the output channels, K = C x taps (tap-major). A block
stages its input window (its ``TILE_M`` positions plus the ``K - 1`` halo,
zero-filled at the sequence's ends) once in shared memory and splits it into
TF32 high and low words; the transposed ``(K, C, O)`` weight streams through
a cp.async ring in k-tiles of ``TILE_K`` input channels of one tap; each
product is three TF32 ``mma.sync`` passes (3xTF32, fp32-accurate), each
16-deep k-tile summed on the tensor cores and the k-tiles in fp32. The
epilogue applies the folded BatchNorm and GELU and takes the pool's max
across the accumulator rows (warp shuffles where the pool divides 8, shared
memory otherwise), writing only the pooled rows. A position tile holds
``TILE_M // pool`` whole pool windows.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    "conv_stem", "msa_conv_stem",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7,
)

# csrc/conv_stem.cu's tiling: conv positions, output channels and input
# channels of one tap a tile, and the weight ring's depth
TILE_M, TILE_N, TILE_K, STAGES = 64, 64, 16, 4
_MAX_SMEM = 227 * 1024


def smem_bytes(c: int, k: int) -> int:
    """The kernel's shared memory at C input channels and K taps: the weight
    ring, and the window's high and low TF32 words (``TILE_M + K - 1`` rows
    of C rounded up to ``TILE_K``, plus 4)."""
    cp = -(-c // TILE_K) * TILE_K
    return 4 * (STAGES * TILE_K * (TILE_N + 8) + 2 * (TILE_M + k - 1) * (cp + 4))


def fold_bn(gamma, beta, mean, var, conv_bias, eps: float = 1e-5):
    """Fold inference BatchNorm + conv bias into per-channel (scale, shift):
    ``(conv + bias) * scale + shift == BN(conv + bias)``."""
    scale = gamma / torch.sqrt(var + eps)
    shift = beta - mean * scale + conv_bias * scale
    return scale, shift


def gelu_max_pool(y: torch.Tensor, pool: int) -> torch.Tensor:
    """Exact erf-GELU, then torch ``MaxPool1d(pool)`` over the time axis of
    an NLC ``(B, T, C)`` tensor (floor length)."""
    b, t, c = y.shape
    t_out = t // pool
    return F.gelu(y[:, : t_out * pool]).reshape(b, t_out, pool, c).amax(dim=2)


def fused_conv_bn_gelu_pool(x: torch.Tensor, weight: torch.Tensor,
                            scale: torch.Tensor, shift: torch.Tensor,
                            padding: int, pool: int) -> torch.Tensor:
    """``x (B, T, C)`` NLC, ``weight (O, C, K)`` torch layout, folded
    ``scale``/``shift (O,)`` -> ``(B, L // pool, O)`` with the conv length
    ``L = T + 2 * padding - K + 1``, through the op ``msa_torch::conv_stem``
    (:mod:`.library`).

    A CPU tensor takes :func:`fused_conv_bn_gelu_pool_plain`; a CUDA tensor
    :func:`conv_stem_cuda`, which launches the kernel or raises. The checks
    here read only the static dimensions (C, K, T, the pool), so a traced
    call keeps its batch symbolic.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv-stem kernel for device {x.device}")
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError("x must be a (B, T, C) tensor and weight (O, C, K)")
    _, t, c = x.shape
    _, c_w, k = weight.shape
    if c_w != c:
        raise ValueError(f"weight takes {c_w} input channels, x has {c}")
    if not 1 <= pool <= TILE_M:
        raise ValueError(f"pool {pool}: the kernel takes 1 <= pool <= {TILE_M}")
    if padding < 0 or (t + 2 * padding - k + 1) // pool < 1:
        raise ValueError(f"padding {padding} and pool {pool} leave no output for T={t}, K={k}")
    return torch.ops.msa_torch.conv_stem(x, weight, scale, shift, padding, pool)


def conv_stem_cuda(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, padding: int, pool: int) -> torch.Tensor:
    """``msa_torch::conv_stem`` on the card: one launch of the kernel, or
    raises before it on what the kernel does not take (an empty batch, more
    than 65535 rows, more shared memory than a block has)."""
    device = x.device
    if 0 in x.shape:
        raise ValueError("x must be a non-empty (B, T, C) tensor")
    b, t, c = x.shape
    o, _, k = weight.shape
    if smem_bytes(c, k) > _MAX_SMEM:
        raise ValueError(f"{smem_bytes(c, k)} bytes of shared memory > {_MAX_SMEM}")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535: the batch row is the grid's z axis")
    check_cuda("x", x, device)
    check_cuda("weight", weight, device)
    check_cuda("scale", scale, device, (o,))
    check_cuda("shift", shift, device, (o,))

    w_t = weight.permute(2, 1, 0)  # (K, C, O), each row padded to a multiple of 4
    w_t = F.pad(w_t, (0, -o % 4)) if o % 4 else w_t.contiguous()
    t_out = (t + 2 * padding - k + 1) // pool
    out = torch.empty(b, t_out, o, device=device, dtype=torch.float32)
    KERNEL.launch(device, ptr(x), ptr(w_t), ptr(scale), ptr(shift), ptr(out),
                  b, t, c, o, k, padding, pool)
    return out


def fused_conv_bn_gelu_pool_plain(x, weight, scale, shift, padding: int,
                                  pool: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_conv_bn_gelu_pool`."""
    y = F.conv1d(x.transpose(1, 2), weight, padding=padding).transpose(1, 2)
    return gelu_max_pool(y * scale + shift, pool)

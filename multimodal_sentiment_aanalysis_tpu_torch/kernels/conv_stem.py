"""Serving conv stem stage: Conv1d + folded BatchNorm + GELU + MaxPool.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/conv_stem.py``:
:func:`fused_conv_bn_gelu_pool` runs ``_stage_kernel``'s computation as the
CUDA kernel in ``csrc/conv_stem.cu``, so the conv output never reaches
device memory. ``eval/serving.py`` reaches it with ``use_pallas=True``.
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

_MAX_POOL = 8    # kMaxR in csrc/conv_stem.cu
_THREAD_ROWS = 8  # kTY in csrc/conv_stem.cu
_MAX_SMEM = 227 * 1024


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
    ``L = T + 2 * padding - K + 1``.

    A CPU tensor takes :func:`fused_conv_bn_gelu_pool_plain`; a CUDA tensor
    launches the kernel, or raises.
    """
    if x.device.type == "cpu":
        return fused_conv_bn_gelu_pool_plain(x, weight, scale, shift, padding, pool)
    if x.device.type != "cuda":
        raise ValueError(f"no conv-stem kernel for device {x.device}")
    device = x.device
    if x.dim() != 3 or weight.dim() != 3 or 0 in x.shape:
        raise ValueError("x must be a non-empty (B, T, C) tensor and weight (O, C, K)")
    b, t, c = x.shape
    o, c_w, k = weight.shape
    if c_w != c:
        raise ValueError(f"weight takes {c_w} input channels, x has {c}")
    if not 1 <= pool <= _MAX_POOL:
        raise ValueError(f"pool {pool}: the kernel takes 1 <= pool <= {_MAX_POOL}")
    if padding < 0 or (t + 2 * padding - k + 1) // pool < 1:
        raise ValueError(f"padding {padding} and pool {pool} leave no output for T={t}, K={k}")
    smem = 4 * (_THREAD_ROWS * (_MAX_POOL // pool) * pool + k - 1) * c
    if smem > _MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory > {_MAX_SMEM}")
    check_cuda("x", x, device)
    check_cuda("weight", weight, device)
    check_cuda("scale", scale, device, (o,))
    check_cuda("shift", shift, device, (o,))

    w_t = weight.permute(2, 1, 0).contiguous()  # (K, C, O)
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

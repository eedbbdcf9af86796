"""EEG stem tail: BatchNorm + GELU + MaxPool over the conv output.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/conv_stem_train.py``.
This slice ports the eval forward of ``fused_stage_train`` (``_fwd_kernel``
at p=0 with the running stats, as ``models/eeg.py`` calls it in eval mode)
as the CUDA kernel in ``csrc/stem_tail.cu``: one pass, pooled output only.
In-kernel dropout (p > 0) and the winner/keep routing code exist only for
the backward and arrive with the training slice (ROADMAP queue B).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda_f32, ptr
from .conv_stem import gelu_max_pool

KERNEL = CudaKernel(
    "stem_tail", "msa_stem_tail",
    [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 4,
)


def fused_stage_train(conv: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor, p: float, pool: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """``(conv - mean) * rsqrt(var + eps) * gamma + beta`` -> erf-GELU ->
    ``MaxPool1d(pool)``; ``conv (B, T, C)`` NLC, the rest ``(C,)``.
    Returns ``(B, T // pool, C)``.

    A CPU tensor takes :func:`fused_stage_train_plain`; a CUDA tensor
    launches the kernel, or raises.
    """
    if p > 0.0:
        raise NotImplementedError(
            "in-kernel dropout (p > 0) and the winner code belong to the "
            "training slice (ROADMAP queue B, kernel row 2)"
        )
    if conv.device.type == "cpu":
        return fused_stage_train_plain(conv, gamma, beta, mean, var, pool, eps)
    if conv.device.type != "cuda":
        raise ValueError(f"no stem-tail kernel for device {conv.device}")
    device = conv.device
    if conv.dim() != 3 or 0 in conv.shape or not 1 <= pool <= conv.shape[1]:
        raise ValueError(f"conv must be a non-empty (B, T, C) tensor with T >= pool {pool}")
    b, t, c = conv.shape
    check_cuda_f32("conv", conv, device)
    for name, v in (("gamma", gamma), ("beta", beta), ("mean", mean), ("var", var)):
        check_cuda_f32(name, v, device, (c,))

    out = torch.empty(b, t // pool, c, device=device, dtype=torch.float32)
    KERNEL.launch(device, ptr(conv), ptr(gamma), ptr(beta), ptr(mean), ptr(var),
                  eps, ptr(out), b, t, c, pool)
    return out


def fused_stage_train_plain(conv, gamma, beta, mean, var, pool: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_stage_train` (p = 0)."""
    y = (conv - mean) * torch.rsqrt(var + eps) * gamma + beta
    return gelu_max_pool(y, pool)

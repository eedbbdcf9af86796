"""Bidirectional LSTM layer forward: the Hopper kernel and its plain version.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/lstm.py``:
:func:`fused_bilstm_layer` has the JAX function's contract (torch-layout
weights in, ``(B, T, 2H)`` out in ``[fwd | bwd]`` order) and runs the
in-kernel-projection forward (``_fwd_xproj_kernel``), written in CUDA in
``csrc/lstm_fwd.cu``. The backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda_f32, ptr

KERNEL = CudaKernel(
    "lstm_fwd", "msa_bilstm_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4,
)

_ROWS_PER_BLOCK = 8  # kBt in csrc/lstm_fwd.cu
_MAX_SMEM = 227 * 1024

Params = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_bilstm_layer(x: torch.Tensor, fwd: Params, bwd: Params) -> torch.Tensor:
    """One bidirectional LSTM layer, ``(B, T, I) -> (B, T, 2H)``.

    ``fwd``/``bwd`` are ``(w_ih (4H, I), w_hh (4H, H), b_ih (4H,),
    b_hh (4H,))`` in torch layout and (i, f, g, o) gate order. A CPU tensor
    takes :func:`fused_bilstm_layer_plain`; a CUDA tensor launches the
    kernel, or raises.
    """
    if x.device.type == "cpu":
        return fused_bilstm_layer_plain(x, fwd, bwd)
    if x.device.type != "cuda":
        raise ValueError(f"no BiLSTM kernel for device {x.device}")
    device = x.device
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (B, T, I) tensor, got {tuple(x.shape)}")
    check_cuda_f32("x", x, device)
    b, t, i = x.shape
    h = fwd[1].shape[1]
    if not 0 < 4 * h <= 1024:
        raise ValueError(f"hidden size {h}: the kernel runs 4H <= 1024 threads")
    smem = 4 * _ROWS_PER_BLOCK * (i + 5 * h)
    if smem > _MAX_SMEM:
        raise ValueError(f"input width {i}: {smem} bytes of shared memory > {_MAX_SMEM}")
    shapes = ((4 * h, i), (4 * h, h), (4 * h,), (4 * h,))
    for direction, params in (("fwd", fwd), ("bwd", bwd)):
        for part, p, shape in zip(("w_ih", "w_hh", "b_ih", "b_hh"), params, shapes):
            check_cuda_f32(f"{direction}.{part}", p, device, shape)

    w_ih_t = torch.stack([fwd[0].t(), bwd[0].t()]).contiguous()  # (2, I, 4H)
    w_hh_t = torch.stack([fwd[1].t(), bwd[1].t()]).contiguous()  # (2, H, 4H)
    bias = torch.stack([fwd[2] + fwd[3], bwd[2] + bwd[3]])       # (2, 4H)
    out = torch.empty(b, t, 2 * h, device=device, dtype=torch.float32)
    KERNEL.launch(device, ptr(x), ptr(w_ih_t), ptr(w_hh_t), ptr(bias), ptr(out),
                  b, t, i, h)
    return out


def fused_bilstm_layer_plain(x: torch.Tensor, fwd: Params, bwd: Params) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_bilstm_layer`: two
    single-direction :func:`..ops.rnn.lstm` sweeps, concatenated."""
    from ..ops.rnn import lstm

    return torch.cat([lstm(x, *fwd), lstm(x, *bwd, reverse=True)], dim=-1)

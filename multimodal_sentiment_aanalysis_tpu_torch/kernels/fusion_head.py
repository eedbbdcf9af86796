"""The ME-MHACL fusion and classification head: the Hopper kernel and its
plain version.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/fusion_head.py``:
:func:`fused_mha_fusion_head` takes the three modality embeddings ``(B, F)``
in the JAX argument order, the attention module and the classifier, and
returns ``(arousal, valence)`` logits: 8-head self-attention over the
length-3 modality axis, the mean over modalities, the shared Linear + ReLU
and the two heads, in one launch of ``csrc/fusion_head.cu`` (``_kernel``),
one block per batch row. The JAX ``block_b`` tile has no counterpart.

Forward only, as in the JAX package (no VJP): :func:`fusion_head` raises if
gradients are on and an input requires one. A CPU tensor takes
:func:`fusion_head_plain`; a CUDA tensor launches the kernel, or raises.
The JAX package never wires its kernel into a path (on the TPU it lost to
XLA); the port's ME-MHACL evaluation forward on the card runs this one
(``train/memhacl.py::memhacl_logits``), which computes what the module path
computes.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ._build import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    "fusion_head", "msa_fusion_head", [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5,
)

_MAX_SMEM = 227 * 1024

Weights = tuple[torch.Tensor, ...]


def head_weights(mha, classifier) -> Weights:
    """``(in_proj_weight, in_proj_bias, out_w, out_b, shared_w, shared_b,
    arousal_w, arousal_b, valence_w, valence_b)`` of a port
    ``MultiheadAttention`` and ``MEMHACLClassifier``, torch ``(out, in)``
    layouts."""
    return (mha.in_proj_weight, mha.in_proj_bias, mha.out_proj.weight, mha.out_proj.bias,
            classifier.shared[0].weight, classifier.shared[0].bias,
            classifier.fc_arousal.weight, classifier.fc_arousal.bias,
            classifier.fc_valence.weight, classifier.fc_valence.bias)


def fusion_head_plain(x_eeg, x_eye, x_phy, *weights: torch.Tensor,
                      num_heads: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on :func:`head_weights`."""
    in_w, in_b, out_w, out_b, sh_w, sh_b, a_w, a_b, v_w, v_b = weights
    x = torch.stack([x_eeg, x_eye, x_phy])  # (3, B, F)
    m, b, f = x.shape
    dh = f // num_heads
    q, k, v = (F.linear(x, w, bias).reshape(m, b, num_heads, dh)
               for w, bias in zip(in_w.chunk(3), in_b.chunk(3)))
    s = torch.einsum("ibhd,jbhd->bhij", q, k) * (1.0 / math.sqrt(dh))
    p = torch.softmax(s, dim=-1)
    att = torch.einsum("bhij,jbhd->ibhd", p, v).reshape(m, b, f)
    fused = F.linear(att, out_w, out_b)
    h = (fused[0] + fused[1] + fused[2]) / 3.0
    shared = torch.relu(F.linear(h, sh_w, sh_b))
    return F.linear(shared, a_w, a_b), F.linear(shared, v_w, v_b)


def _check(x_eeg, x_eye, x_phy, weights: Weights, num_heads: int):
    """Validate CUDA operands; returns ``(B, F, hidden, classes)``."""
    device = x_eeg.device
    if x_eeg.dim() != 2 or 0 in x_eeg.shape:
        raise ValueError(f"embeddings must be non-empty (B, F), got {tuple(x_eeg.shape)}")
    b, f = x_eeg.shape
    hidden, ncls = weights[4].shape[0], weights[6].shape[0]
    if f % num_heads or f % 4 or hidden % 4 or hidden > 9 * f or 2 * ncls > 3 * f:
        raise ValueError(f"F={f}, {num_heads} heads, hidden {hidden}, {ncls} classes: the "
                         "kernel needs F % heads == 0, F and hidden multiples of 4, hidden "
                         "<= 9 F and 2 classes <= 3 F")
    if 48 * f > _MAX_SMEM:
        raise ValueError(f"F={f} needs more than {_MAX_SMEM} bytes of shared memory")
    shapes = ((3 * f, f), (3 * f,), (f, f), (f,), (hidden, f), (hidden,), (ncls, hidden),
              (ncls,), (ncls, hidden), (ncls,))
    for name, t in (("x_eeg", x_eeg), ("x_eye", x_eye), ("x_phy", x_phy)):
        check_cuda(name, t, device, (b, f))
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        check_cuda(f"weight {i}", t, device, shape)
    if any(t.data_ptr() % 16 for t in (x_eeg, x_eye, x_phy, *weights)):
        raise ValueError("the kernel reads 16-byte vectors: every operand must be 16-byte aligned")
    return b, f, hidden, ncls


def fusion_head(x_eeg, x_eye, x_phy, *weights: torch.Tensor,
                num_heads: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: ``(arousal, valence)`` logits ``(B, classes)`` from the
    three ``(B, F)`` embeddings and :func:`head_weights`. A CPU tensor takes
    :func:`fusion_head_plain`; a CUDA tensor launches the kernel, or raises."""
    if len(weights) != 10:
        raise ValueError(f"expected the 10 head weights, got {len(weights)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_eeg, x_eye, x_phy, *weights)):
        raise RuntimeError("the fused head is forward only: call it under torch.no_grad()")
    if x_eeg.device.type == "cpu":
        return fusion_head_plain(x_eeg, x_eye, x_phy, *weights, num_heads=num_heads)
    if x_eeg.device.type != "cuda":
        raise ValueError(f"no fusion-head kernel for device {x_eeg.device}")
    b, f, hidden, ncls = _check(x_eeg, x_eye, x_phy, weights, num_heads)
    oa = torch.empty(b, ncls, device=x_eeg.device, dtype=torch.float32)
    ov = torch.empty(b, ncls, device=x_eeg.device, dtype=torch.float32)
    KERNEL.launch(x_eeg.device, ptr(x_eeg), ptr(x_eye), ptr(x_phy), *map(ptr, weights),
                  ptr(oa), ptr(ov), b, f, num_heads, hidden, ncls)
    return oa, ov


def fused_mha_fusion_head(x_eeg, x_eye, x_phy, mha, classifier,
                          num_heads: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, F)`` x3 -> ``(arousal, valence)``: :func:`fusion_head` on the
    weights of a port ``MultiheadAttention`` and ``MEMHACLClassifier``."""
    return fusion_head(x_eeg, x_eye, x_phy, *head_weights(mha, classifier),
                       num_heads=num_heads)

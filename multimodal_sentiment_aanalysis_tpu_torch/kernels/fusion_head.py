"""The ME-MHACL fusion and classification head: the Hopper kernel and its
plain version.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/fusion_head.py``:
:func:`fused_mha_fusion_head` takes the three modality embeddings ``(B, F)``
in the JAX argument order, the attention module and the classifier, and
returns ``(arousal, valence)`` logits: multi-head self-attention over the
length-3 modality axis, the mean over modalities, the shared Linear + ReLU
and the two heads, in one launch of ``csrc/fusion_head.cu`` (``_kernel``):
one thread-block cluster of K CTAs per tile of R batch rows (:func:`plan`:
R 4, 8 or 16, the smallest whose clusters fit the H100's SMs), K the
largest divisor of the head count up to 8 (:func:`cluster_size`), each CTA
owning its share of the heads, of the out projection's columns and of the
shared layer's units, the products on the tensor cores (3xTF32 in fp32).
The JAX ``block_b`` tile has no counterpart.

fp32 and bf16, as the JAX kernel: a bf16 call reads bf16 embeddings and
weights, computes in fp32 (the first product bf16 x bf16 with fp32 sums,
the rest fp32-accurate) and returns bf16 logits; its plain version reads
the same values and computes in fp32 too.

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

from ._build import F32_BF16, check_cuda, kernel_forms, ptr, upcast

# fp32 and bf16 forms, by the dtype of the embeddings
KERNELS = kernel_forms("fusion_head", "msa_fusion_head",
                       [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7)
KERNEL = KERNELS[torch.float32]

# csrc/fusion_head.cu's blocking: R batch rows a cluster, 12 warps (12 / mt
# on each of the mt m16 tiles of the projections, 12 on the shared layer's
# one), at most 8 n8 tiles a warp, a ring of 2 stages of 2 chunks in
# 144-byte rows (_STAGES chunks), at most 8 16-byte pieces a thread a chunk
_TILES, _WARPS, _MAX_TILES, _STAGES, _RING_LD, _MAX_PIECES = (4, 8, 16), 12, 8, 4, 144, 8
_MAX_SMEM = 232448  # a block's shared memory on the H100
_SMS = 132          # the H100's SMs: one CTA each (a CTA takes most of an SM)

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
    """Plain PyTorch version of the kernel, on :func:`head_weights`: fp32
    arithmetic on the operands' values, logits in the embeddings' dtype."""
    dtype = x_eeg.dtype
    in_w, in_b, out_w, out_b, sh_w, sh_b, a_w, a_b, v_w, v_b = map(upcast, weights)
    x = torch.stack([x_eeg, x_eye, x_phy]).to(in_w.dtype)  # (3, B, F)
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
    return F.linear(shared, a_w, a_b).to(dtype), F.linear(shared, v_w, v_b).to(dtype)


def cluster_size(num_heads: int) -> int:
    """CTAs a cluster: the largest divisor of the head count up to 8, so
    that every CTA owns as many heads."""
    return max(k for k in range(1, 9) if num_heads % k == 0)


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def plan_smem(tile_rows: int, f: int, num_heads: int, hidden: int, ncls: int,
              dtype: torch.dtype) -> int:
    """Bytes of shared memory one CTA takes for a tile of ``tile_rows``
    batch rows (``csrc/fusion_head.cu``'s ``layout``): the weight ring at
    its widest product; the embeddings, then the shared layer; the
    attention output; q | k | v, then the out projection; the mean rows;
    the logit shares; the products' column tables and biases; a resident
    product's partial sums. Raises where a CTA's products need more than 8 n8
    tiles a warp or a weight slice more than 384 rows."""
    k = cluster_size(num_heads)
    nh, dh, fk = num_heads // k, f // num_heads, f // k
    units = -(-hidden // k)
    rows = _round(3 * tile_rows, 16)
    np_in, np_out, np_sh = _round(3 * nh * dh, 8), _round(fk, 8), _round(units, 8)
    per = _WARPS // (rows // 16)
    tiles = max(-(-np_in // 8 // per), -(-np_out // 8 // per), -(-np_sh // 8 // _WARPS))
    if tiles > _MAX_TILES or 8 * max(np_in, np_out, np_sh) > _MAX_PIECES * 32 * _WARPS:
        raise ValueError(f"F={f}, {num_heads} heads, hidden {hidden}: a CTA's products need "
                         f"{tiles} n8 tiles a warp and {max(np_in, np_out, np_sh)} weight rows; "
                         f"the kernel holds {_MAX_TILES} n8 tiles and 384 rows")
    size = 2 if dtype == torch.bfloat16 else 4
    ldx = _round(f, 64 if size == 2 else 32) + 16 // size
    lda = _round(f, 32) + 4
    return (_STAGES * max(np_in, np_out, np_sh) * _RING_LD
            + _round(max(rows * ldx * size, 4 * 16 * np_sh), 16) + 4 * rows * lda
            + 4 * rows * max(np_in + 4, np_out) + 4 * 16 * lda + 4 * k * 16 * 2 * ncls
            + _round(4 * (2 * np_in + np_out + np_sh), 16) + 4 * _WARPS * 16 * 8)


def plan(b: int, f: int, num_heads: int, hidden: int, ncls: int,
         dtype: torch.dtype) -> tuple[int, int]:
    """``(tile_rows, smem)``: the smallest batch tile of 4, 8 or 16 rows
    whose clusters fit the card's 132 SMs at one CTA an SM (at B=32 and 8
    heads: tiles of 4, 8 clusters on 64 SMs), or, where none does, the
    largest that the kernel can take. Raises, with the last reason, where
    it can take none."""
    fits, reason = [], ""
    for r in _TILES:
        try:
            smem = plan_smem(r, f, num_heads, hidden, ncls, dtype)
        except ValueError as err:  # too many n8 tiles a warp at this tile's m16 tiles
            reason = str(err)
            continue
        if smem <= _MAX_SMEM:
            fits.append((r, smem))
        else:
            reason = (f"F={f}, {num_heads} heads, hidden {hidden}: {smem} bytes of shared "
                      f"memory a CTA at a tile of {r} rows, more than the H100's {_MAX_SMEM}")
    if not fits:
        raise ValueError(reason)
    k = cluster_size(num_heads)
    return next(((r, s) for r, s in fits if -(-b // r) * k <= _SMS), fits[-1])


def _check(x_eeg, x_eye, x_phy, weights: Weights, num_heads: int):
    """Validate CUDA operands; returns ``(B, F, hidden, classes, tile rows)``."""
    device = x_eeg.device
    if x_eeg.dim() != 2 or 0 in x_eeg.shape:
        raise ValueError(f"embeddings must be non-empty (B, F), got {tuple(x_eeg.shape)}")
    b, f = x_eeg.shape
    hidden, ncls = weights[4].shape[0], weights[6].shape[0]
    dtype = x_eeg.dtype
    step = 8 if dtype == torch.bfloat16 else 4
    if num_heads < 1 or f % num_heads or f % step:
        raise ValueError(f"F={f}, {num_heads} heads: the kernel needs F % heads == 0 and F a "
                         f"multiple of {step} (16-byte rows in {dtype})")
    shapes = ((3 * f, f), (3 * f,), (f, f), (f,), (hidden, f), (hidden,), (ncls, hidden),
              (ncls,), (ncls, hidden), (ncls,))
    for name, t in (("x_eeg", x_eeg), ("x_eye", x_eye), ("x_phy", x_phy)):
        check_cuda(name, t, device, (b, f), F32_BF16)
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        check_cuda(f"weight {i}", t, device, shape, (dtype,))
    if any(t.dtype != dtype for t in (x_eye, x_phy)):
        raise TypeError("the three embeddings must share one dtype")
    if any(t.data_ptr() % 16 for t in (x_eeg, x_eye, x_phy, *weights)):
        raise ValueError("the kernel reads 16-byte vectors: every operand must be 16-byte aligned")
    return b, f, hidden, ncls, plan(b, f, num_heads, hidden, ncls, dtype)[0]


def fusion_head(x_eeg, x_eye, x_phy, *weights: torch.Tensor,
                num_heads: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: ``(arousal, valence)`` logits ``(B, classes)`` in the
    embeddings' dtype (fp32 or bf16) from the three ``(B, F)`` embeddings
    and :func:`head_weights` of the same dtype. A CPU tensor takes
    :func:`fusion_head_plain`; a CUDA tensor launches the kernel, or
    raises."""
    if len(weights) != 10:
        raise ValueError(f"expected the 10 head weights, got {len(weights)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_eeg, x_eye, x_phy, *weights)):
        raise RuntimeError("the fused head is forward only: call it under torch.no_grad()")
    if x_eeg.device.type == "cpu":
        return fusion_head_plain(x_eeg, x_eye, x_phy, *weights, num_heads=num_heads)
    if x_eeg.device.type != "cuda":
        raise ValueError(f"no fusion-head kernel for device {x_eeg.device}")
    b, f, hidden, ncls, tile_rows = _check(x_eeg, x_eye, x_phy, weights, num_heads)
    oa = torch.empty(b, ncls, device=x_eeg.device, dtype=x_eeg.dtype)
    ov = torch.empty(b, ncls, device=x_eeg.device, dtype=x_eeg.dtype)
    KERNELS[x_eeg.dtype].launch(x_eeg.device, ptr(x_eeg), ptr(x_eye), ptr(x_phy),
                                *map(ptr, weights), ptr(oa), ptr(ov), b, tile_rows, f, num_heads,
                                hidden, ncls, cluster_size(num_heads))
    return oa, ov


def fused_mha_fusion_head(x_eeg, x_eye, x_phy, mha, classifier,
                          num_heads: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, F)`` x3 -> ``(arousal, valence)``: :func:`fusion_head` on the
    weights of a port ``MultiheadAttention`` and ``MEMHACLClassifier``."""
    return fusion_head(x_eeg, x_eye, x_phy, *head_weights(mha, classifier),
                       num_heads=num_heads)

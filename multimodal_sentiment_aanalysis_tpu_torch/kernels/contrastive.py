"""Supervised InfoNCE: the Hopper kernel and its plain version.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/contrastive.py``.
:func:`fused_supervised_infonce_multi` is a ``torch.autograd.Function``:

- forward: ``_infonce_kernel``'s computation for P problems in one launch
  (``csrc/infonce.cu``): similarity ``n1 n2^T / temp``, positives by label
  equality with the diagonal zeroed and both axes masked by ``valid``,
  invalid columns at -1e30, row-max log-sum-exp, masked mean. The (B, B)
  matrix stays on the chip. Each problem has its own labels, validity and
  temperature: one train step's three per-modality losses are P = 3; under
  ``torch.func.vmap`` over S models the Function's ``vmap`` rule makes one
  launch of P = 3 S problems (the JAX package serializes S launches per loss
  there, a TPU-only choice). A single loss is P = 1
  (:func:`fused_supervised_infonce`).
- backward: the JAX package's closed form ``_core_bwd`` in torch, including
  the r_i term through the row max, which is real for rows with no positive;
  written for one model, so under ``vmap`` each model gets its own
  temperature gradient.

L2 normalisation stays outside the kernel, so its gradient is autograd's.

The kernel has an fp32 and a bf16 form, chosen by the dtype of the
features. As in the JAX kernel, the bf16 form takes bf16 ``n1``/``n2`` and
computes the dots and the loss in fp32 (``valid`` and ``temp`` enter in
fp32, the losses come back in fp32); the closed-form backward runs in fp32
and returns the features' gradients in their dtype (``_core_bwd``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import F32, F32_BF16, check_cuda, kernel_forms, models_first, ptr, upcast

# fp32 and bf16 forms, by the dtype of the features
KERNELS = kernel_forms("infonce", "msa_infonce", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3)
KERNEL = KERNELS[torch.float32]

_EPS = 1e-12
_NEG = -1e30
_ROWS_PER_BLOCK = 8  # kWarps in csrc/infonce.cu: each row keeps B floats in smem
_MAX_SMEM = 227 * 1024
MAX_BATCH = _MAX_SMEM // (4 * _ROWS_PER_BLOCK)


def _masked_sim(n1, n2, labels, valid, temp):
    """``(raw, shifted, e, pos)`` of every problem: the kernel's forward.
    ``labels``/``valid`` are ``(B,)`` shared by the problems or ``(P, B)``
    per problem; ``temp`` a scalar or ``(P,)``."""
    b = n1.shape[-2]
    raw = n1 @ n2.transpose(-1, -2)
    pos = (labels[..., :, None] == labels[..., None, :]).to(raw.dtype)
    pos = pos * (1.0 - torch.eye(b, dtype=raw.dtype, device=raw.device))
    pos = pos * valid[..., :, None] * valid[..., None, :]
    sim = torch.where(valid[..., None, :] > 0, raw / temp[..., None, None], _NEG)
    shifted = sim - sim.amax(dim=-1, keepdim=True)
    return raw, shifted, torch.exp(shifted), pos


def infonce_plain(n1, n2, labels, valid, temp) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: ``(P,)`` losses from
    normalised ``n1, n2 (P, B, D)``, ``labels`` and ``valid`` ``(P, B)``
    (or ``(B,)`` shared) and ``temp`` ``(P,)`` (or a scalar), in fp32."""
    n1, n2, valid, temp = map(upcast, (n1, n2, valid, temp))
    _, _, e, pos = _masked_sim(n1, n2, labels, valid, temp)
    p = (e * pos).sum(-1)
    a = e.sum(-1)
    loss = -torch.log((p + _EPS) / (a + _EPS))
    return (loss * valid).sum(-1) / valid.sum(-1).clamp_min(1.0)


def infonce(n1, n2, labels, valid, temp) -> torch.Tensor:
    """The forward kernel on normalised features: ``(P,)`` fp32 losses of
    ``n1, n2 (P, B, D)`` (fp32 or bf16) with per-problem ``labels (P, B)``
    int64, ``valid (P, B)`` and ``temp (P,)`` fp32. A CPU tensor takes
    :func:`infonce_plain`; a CUDA tensor launches the kernel, or raises."""
    if n1.device.type == "cpu":
        return infonce_plain(n1, n2, labels, valid, temp)
    if n1.device.type != "cuda":
        raise ValueError(f"no InfoNCE kernel for device {n1.device}")
    device = n1.device
    if n1.dim() != 3 or 0 in n1.shape:
        raise ValueError(f"features must be non-empty (P, B, D), got {tuple(n1.shape)}")
    g, b, d = n1.shape
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} > {MAX_BATCH}: each row keeps B floats in shared memory")
    check_cuda("n1", n1, device, dtypes=F32_BF16)
    check_cuda("n2", n2, device, (g, b, d), (n1.dtype,))
    check_cuda("valid", valid, device, (g, b), F32)
    check_cuda("temp", temp, device, (g,), F32)
    if (labels.dtype != torch.int64 or labels.device != device
            or tuple(labels.shape) != (g, b) or not labels.is_contiguous()):
        raise ValueError("labels must be a contiguous int64 (P, B) tensor on the features' "
                         "device")
    row_loss = torch.empty(g, b, device=device, dtype=torch.float32)
    loss = torch.empty(g, device=device, dtype=torch.float32)
    KERNELS[n1.dtype].launch(device, ptr(n1), ptr(n2), ptr(labels), ptr(valid), ptr(temp),
                             ptr(row_loss), ptr(loss), g, b, d)
    return loss


def _per_problem(n1, labels, valid, temp):
    """One model's shared ``labels``/``valid`` ``(B,)`` and scalar ``temp``
    repeated for each of its G problems, contiguous."""
    g, b = n1.shape[:2]
    return (labels.expand(g, b).contiguous(), valid.expand(g, b).contiguous(),
            temp.reshape(1).expand(g).contiguous())


class _InfoNCE(torch.autograd.Function):
    """G losses of one model from ``n1, n2 (G, B, D)``, ``labels (B,)``,
    ``valid (B,)`` and a scalar ``temp``."""

    @staticmethod
    def forward(n1, n2, labels, valid, temp):
        return infonce(n1.contiguous(), n2.contiguous(), *_per_problem(n1, labels, valid, temp))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        """``_core_bwd`` of the JAX package, batched over the G problems, in
        fp32; the features' gradients in their dtype."""
        n1, n2, labels, valid, temp = ctx.saved_tensors
        dtype = n1.dtype
        n1, n2 = upcast(n1), upcast(n2)
        raw, shifted, e, pos = _masked_sim(n1, n2, labels, valid, temp)
        p = (e * pos).sum(2, keepdim=True)
        a = e.sum(2, keepdim=True)
        w = (valid[:, None] / valid.sum().clamp_min(1.0)) * g[:, None, None]
        grad_s = w * (e / (a + _EPS) - pos * e / (p + _EPS))
        # through the row-max subtraction: vanishes when the row has positive
        # mass, real for rows with none; ties split evenly like jnp.max's VJP
        r = w * (a / (a + _EPS) - p / (p + _EPS))
        is_max = (shifted == 0.0).to(e.dtype)
        grad_s = grad_s - r * is_max / is_max.sum(2, keepdim=True)
        dn1 = ((grad_s @ n2) / temp).to(dtype)
        dn2 = ((grad_s.transpose(1, 2) @ n1) / temp).to(dtype)
        # the model's one temperature: summed over its G problems
        dtemp = -(grad_s * raw).sum() / (temp * temp)
        return dn1, dn2, None, None, dtemp.reshape(temp.shape)

    @staticmethod
    def vmap(info, in_dims, n1, n2, labels, valid, temp):
        """All S models' G problems as one launch of P = S G problems."""
        n1, n2, labels, valid, temp = models_first(info, in_dims, n1, n2, labels, valid, temp)
        s, g, b, d = n1.shape
        per_model = lambda v: v[:, None].expand(s, g, *v.shape[1:]).reshape(s * g, *v.shape[1:])
        loss = infonce(n1.reshape(s * g, b, d), n2.reshape(s * g, b, d), per_model(labels),
                       per_model(valid), per_model(temp))
        return loss.reshape(s, g), 0


def _valid(mask: torch.Tensor | None, b: int, device: torch.device) -> torch.Tensor:
    if mask is None:
        return torch.ones(b, device=device)
    return mask.to(torch.float32).contiguous()


def fused_supervised_infonce_multi(feats1: torch.Tensor, feats2: torch.Tensor,
                                   labels: torch.Tensor, temperature: torch.Tensor | float,
                                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """G supervised-InfoNCE losses sharing labels, mask and temperature, in
    one launch: ``feats1, feats2 (G, B, D)`` -> ``(G,)``. Same numerics as G
    calls of :func:`..ops.losses.supervised_infonce`. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel, or raises; under
    ``torch.func.vmap`` over S models it is one launch for all S G losses.
    The mask and the temperature enter in fp32 and the losses are fp32, in
    either dtype of the features (JAX ``fused_supervised_infonce``)."""
    temp = (temperature.to(torch.float32) if isinstance(temperature, torch.Tensor)
            else torch.tensor(temperature, device=feats1.device))
    b = feats1.shape[1]
    return _InfoNCE.apply(F.normalize(feats1, dim=2, eps=_EPS), F.normalize(feats2, dim=2, eps=_EPS),
                          labels.to(torch.int64), _valid(mask, b, feats1.device), temp)


def fused_supervised_infonce(feat1: torch.Tensor, feat2: torch.Tensor, labels: torch.Tensor,
                             temperature: torch.Tensor | float,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """One loss (G = 1): the JAX ``fused_supervised_infonce`` contract."""
    return fused_supervised_infonce_multi(feat1[None], feat2[None], labels, temperature,
                                          mask)[0]

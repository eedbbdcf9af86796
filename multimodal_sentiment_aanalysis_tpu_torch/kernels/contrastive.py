"""Supervised InfoNCE: the Hopper kernel and its plain version.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/contrastive.py``.
:func:`fused_supervised_infonce_multi` is a ``torch.autograd.Function``:

- forward: ``_infonce_kernel``'s computation for P problems in one launch
  (``csrc/infonce.cu``): similarity ``n1 n2^T / temp``, positives by label
  equality with the diagonal zeroed and both axes masked by ``valid``,
  invalid columns at -1e30, row-max log-sum-exp, masked mean. One train
  step's three per-modality losses are P = 3; under ``torch.func.vmap`` over
  S models the Function's ``vmap`` rule makes one launch of P = 3 S problems
  (the JAX package serializes S launches per loss there, a TPU-only choice).
  A single loss is P = 1 (:func:`fused_supervised_infonce`). Problems come in
  groups that share one row of labels and validity and one temperature
  (:func:`infonce`): a model's three losses read its ``(B,)`` rows, passed as
  views, with no per-problem copies.
- backward: the JAX package's closed form ``_core_bwd`` in torch, including
  the r_i term through the row max, which is real for rows with no positive;
  written for one model, so under ``vmap`` each model gets its own
  temperature gradient.

L2 normalisation stays outside the kernel, so its gradient is autograd's.

The kernel computes the similarities on the tensor cores, a tile of 64
query rows against 64-key tiles, and folds each key tile into running row
statistics (the max, sum e, sum e * pos), so no (B, B) matrix and no row of
B values stays on the chip: any B the grid takes runs. The feature width is
bounded by the CTA's shared memory, which holds the query tile whole
(:func:`plan_smem`).

The kernel has an fp32 and a bf16 form, chosen by the dtype of the
features. The fp32 form takes its products as three TF32 passes (fp32
accuracy); as in the JAX kernel, the bf16 form takes bf16 ``n1``/``n2`` and
computes the dots (exact bf16 products, fp32 sums) and the loss in fp32
(``valid`` and ``temp`` enter in fp32, the losses come back in fp32); the
closed-form backward runs in fp32 and returns the features' gradients in
their dtype (``_core_bwd``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import F32, F32_BF16, check_cuda, kernel_forms, models_first, ptr, upcast

# fp32 and bf16 forms, by the dtype of the features
KERNELS = kernel_forms("infonce", "msa_infonce", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5)
KERNEL = KERNELS[torch.float32]

_EPS = 1e-12
_NEG = -1e30
# csrc/infonce.cu: kKeys-row stages of kChunkBytes of each row, padded to
# kLd 32-bit words; kStages of them in the ring beside the query tile
_TILE_ROWS, _CHUNK_BYTES, _ROW_BYTES, _STAGES = 64, 128, 144, 4
_MAX_SMEM = 227 * 1024
_MAX_PROBLEMS = 65535  # grid y


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


def plan_smem(d: int, dtype: torch.dtype) -> int:
    """The shared memory of one CTA of the kernel at feature width ``d`` in
    ``dtype``, which its launcher checks byte for byte: the query tile whole
    and the ring, in chunks of 128 bytes of each row, and the labels (int64)
    and validity of four key tiles. Raises ``ValueError`` past the 227 KB a
    block may use (above D = 640 in fp32, 1280 in bf16)."""
    chunks = -(-d * torch.finfo(dtype).bits // 8 // _CHUNK_BYTES)
    smem = (chunks + _STAGES) * _TILE_ROWS * _ROW_BYTES + _STAGES * _TILE_ROWS * (8 + 4)
    if smem > _MAX_SMEM:
        raise ValueError(f"feature width {d}: the query tile takes {smem} bytes of shared "
                         f"memory > {_MAX_SMEM}")
    return smem


def _group(p: int, labels, valid, temp) -> int:
    """Problems per row of ``labels (Q, B)``, ``valid (Q, B)`` and ``temp
    (Q,)`` for P problems: P / Q, where Q divides P."""
    q = temp.shape[0] if temp.dim() == 1 else 0
    if q < 1 or p % q or labels.dim() != 2 or labels.shape[0] != q or valid.shape[:1] != (q,):
        raise ValueError(f"labels {tuple(labels.shape)}, valid {tuple(valid.shape)} and temp "
                         f"{tuple(temp.shape)} must be (Q, B), (Q, B) and (Q,) with Q dividing "
                         f"the {p} problems")
    return p // q


def infonce(n1, n2, labels, valid, temp) -> torch.Tensor:
    """The forward kernel on normalised features: ``(P,)`` fp32 losses of
    ``n1, n2 (P, B, D)`` (fp32 or bf16) with ``labels (Q, B)`` int64,
    ``valid (Q, B)`` and ``temp (Q,)`` fp32, Q dividing P: problem ``p``
    takes row ``p // (P / Q)``, so each row serves ``P / Q`` consecutive
    problems (one model's three losses share one; Q = P gives each problem
    its own). A CPU tensor takes :func:`infonce_plain` on the rows repeated
    per problem; a CUDA tensor launches the kernel, or raises."""
    if n1.dim() != 3 or 0 in n1.shape:
        raise ValueError(f"features must be non-empty (P, B, D), got {tuple(n1.shape)}")
    p, b, d = n1.shape
    group = _group(p, labels, valid, temp)
    if n1.device.type == "cpu":
        per = lambda t: t.repeat_interleave(group, 0) if group > 1 else t
        return infonce_plain(n1, n2, per(labels), per(valid), per(temp))
    if n1.device.type != "cuda":
        raise ValueError(f"no InfoNCE kernel for device {n1.device}")
    device = n1.device
    if p > _MAX_PROBLEMS:
        raise ValueError(f"{p} problems > {_MAX_PROBLEMS}, the grid's limit")
    check_cuda("n1", n1, device, dtypes=F32_BF16)
    smem = plan_smem(d, n1.dtype)
    check_cuda("n2", n2, device, (p, b, d), (n1.dtype,))
    check_cuda("valid", valid, device, (p // group, b), F32)
    check_cuda("temp", temp, device, dtypes=F32)
    if (labels.dtype != torch.int64 or labels.device != device
            or tuple(labels.shape) != (p // group, b) or not labels.is_contiguous()):
        raise ValueError("labels must be a contiguous int64 (Q, B) tensor on the features' "
                         "device")
    row_loss = torch.empty(p, b, device=device, dtype=torch.float32)
    loss = torch.empty(p, device=device, dtype=torch.float32)
    KERNELS[n1.dtype].launch(device, ptr(n1), ptr(n2), ptr(labels), ptr(valid), ptr(temp),
                             ptr(row_loss), ptr(loss), p, b, d, group, smem)
    return loss


class _InfoNCE(torch.autograd.Function):
    """G losses of one model from ``n1, n2 (G, B, D)``, ``labels (B,)``,
    ``valid (B,)`` and a scalar ``temp``."""

    @staticmethod
    def forward(n1, n2, labels, valid, temp):
        # the G problems share the model's rows: (1, B) views and a (1,) temperature
        return infonce(n1.contiguous(), n2.contiguous(), labels[None], valid[None],
                       temp.reshape(1))

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
        # each model's G problems share its rows: (S, B) labels and validity, (S,) temperatures
        loss = infonce(n1.reshape(s * g, b, d), n2.reshape(s * g, b, d), labels, valid, temp)
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

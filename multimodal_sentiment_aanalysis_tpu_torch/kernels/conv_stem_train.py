"""EEG stem tail: BatchNorm + GELU + dropout + MaxPool over the conv output,
forward and backward.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/kernels/conv_stem_train.py``:
:func:`fused_stage_train` is a ``torch.autograd.Function`` whose forward is
``_fwd_kernel`` and whose backward is ``_bwd_kernel``, both in
``csrc/stem_tail.cu``:

- forward: one pass over ``conv (B, T, C)`` with the statistics it is
  given, exact erf-GELU, dropout with p > 0 from an in-kernel Philox
  generator seeded from a ``torch.Generator`` (no mask tensor exists), and
  ``MaxPool1d(pool)`` routed to the first max. In train mode it also writes
  one int32 code per pooled cell: winner index + ``pool`` * keep bit.
- backward: the code routes ``dpool`` to the winner, one ``gelu_grad``,
  kept cells scaled by ``1 / (1 - p)``; the kernel writes ``dy`` over the
  covered rows plus per-chunk partial dgamma/dbeta, summed here. The BN
  input-gradient combine ``inv * gamma * (dy - dbeta/N - xhat * dgamma/N)``
  and the zero tail rows stay in torch, as ``_fst_bwd`` keeps them in XLA.

The statistics enter without gradient (the caller computes them under
``no_grad``): the combine already carries their dependence, as in JAX.

The plain versions take the keep mask as a tensor, so a test can feed the
same random numbers to both packages; on the CPU the wrapper draws that mask
from the generator with ``torch.rand``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda_f32, ptr
from .conv_stem import gelu_max_pool

KERNEL = CudaKernel(
    "stem_tail", "msa_stem_tail",
    [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_float, ctypes.c_uint]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
)
BWD_KERNEL = CudaKernel(
    "stem_tail", "msa_stem_tail_bwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5,
)

_ROWS_PER_CHUNK = 64  # pooled rows per partial dgamma/dbeta sum in the backward


def _keep_scale(p: float) -> float:
    return 1.0 / (1.0 - p) if p > 0.0 else 1.0


def _threshold(p: float) -> int:
    """Keep an element iff its 32 random bits are >= this (P = 1 - p)."""
    return min(int(round(p * 2.0 ** 32)), 2 ** 32 - 1)


def _check_args(conv, gamma, beta, mean, var, p: float, pool: int) -> None:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1)")
    if conv.dim() != 3 or 0 in conv.shape or not 1 <= pool <= conv.shape[1]:
        raise ValueError(f"conv must be a non-empty (B, T, C) tensor with T >= pool {pool}")
    if conv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stem-tail kernel for device {conv.device}")
    if conv.device.type == "cuda":
        c = conv.shape[2]
        check_cuda_f32("conv", conv, conv.device)
        for name, v in (("gamma", gamma), ("beta", beta), ("mean", mean), ("var", var)):
            check_cuda_f32(name, v, conv.device, (c,))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def stem_tail_fwd(conv, gamma, beta, mean, var, p: float, pool: int, eps: float = 1e-5,
                  generator: torch.Generator | None = None, with_code: bool = True):
    """The forward kernel: ``(pooled, code)``, ``code`` None unless
    ``with_code``. A CPU tensor takes :func:`fused_stage_train_plain` with
    a keep mask drawn by ``torch.rand`` from ``generator``; a CUDA tensor
    launches the kernel (its Philox seed drawn on the device from
    ``generator``), or raises."""
    _check_args(conv, gamma, beta, mean, var, p, pool)
    if conv.device.type == "cpu":
        keep = torch.rand(conv.shape, generator=generator) >= p if p > 0.0 else None
        res = fused_stage_train_plain(conv, gamma, beta, mean, var, pool, eps, p, keep,
                                      with_code)
        return res if with_code else (res, None)
    b, t, c = conv.shape
    device = conv.device
    out = torch.empty(b, t // pool, c, device=device, dtype=torch.float32)
    code = (torch.empty(b, t // pool, c, device=device, dtype=torch.int32)
            if with_code else None)
    seed = None
    if p > 0.0:  # drawn on the device: no host sync
        seed = torch.randint(0, 2 ** 62, (1,), device=device, dtype=torch.int64,
                             generator=generator)
    KERNEL.launch(device, ptr(conv), ptr(gamma), ptr(beta), ptr(mean), ptr(var), eps,
                  _keep_scale(p), _threshold(p), ptr(seed) if seed is not None else None,
                  ptr(out), ptr(code) if code is not None else None, b, t, c, pool)
    return out, code


def fused_stage_train_plain(conv, gamma, beta, mean, var, pool: int, eps: float = 1e-5,
                            p: float = 0.0, keep: torch.Tensor | None = None,
                            with_code: bool = False):
    """Plain PyTorch version of the forward kernel. ``keep`` is the
    ``(B, T, C)`` keep mask (True = kept), needed when ``p > 0``. Returns
    the pooled ``(B, T // pool, C)``, or ``(pooled, code)`` with
    ``with_code``."""
    y = (conv - mean) * torch.rsqrt(var + eps) * gamma + beta
    if p == 0.0 and not with_code:
        return gelu_max_pool(y, pool)
    b, t, c = conv.shape
    t_out = t // pool
    a = torch.nn.functional.gelu(y[:, : t_out * pool]).reshape(b, t_out, pool, c)
    kept = torch.ones_like(a, dtype=torch.bool)
    if p > 0.0:
        if keep is None:
            raise ValueError("p > 0 needs a keep mask")
        kept = keep[:, : t_out * pool].reshape(b, t_out, pool, c)
        a = torch.where(kept, a * _keep_scale(p), 0.0)
    out, win = a.max(dim=2)  # first max wins, as torch MaxPool1d
    if not with_code:
        return out
    kw = kept.gather(2, win[:, :, None]).squeeze(2)
    return out, (win + pool * kw).to(torch.int32)


class _StemTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, conv, gamma, beta, mean, var, p, pool, eps, generator, with_code):
        out, code = stem_tail_fwd(conv, gamma, beta, mean, var, p, pool, eps, generator,
                                  with_code)
        if with_code:
            ctx.save_for_backward(conv, gamma, beta, mean, var, code)
            ctx.p, ctx.pool, ctx.eps = p, pool, eps
        return out

    @staticmethod
    def backward(ctx, dpool):
        conv, gamma, beta, mean, var, code = ctx.saved_tensors
        p, pool, eps = ctx.p, ctx.pool, ctx.eps
        inv = torch.rsqrt(var + eps)
        scale = gamma * inv
        shift = beta - mean * scale
        dy_cov, dg_part, db_part = stem_tail_bwd(conv, dpool.contiguous(), code, scale,
                                                 shift, mean, inv, p, pool)
        dgamma, dbeta = dg_part.sum(0), db_part.sum(0)
        b, t, c = conv.shape
        dy = torch.nn.functional.pad(dy_cov, (0, 0, 0, t - dy_cov.shape[1]))
        n = b * t
        xhat = (conv - mean) * inv
        dconv = (inv * gamma) * (dy - dbeta / n - xhat * (dgamma / n))
        return dconv, dgamma, dbeta, None, None, None, None, None, None, None


def fused_stage_train(conv: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor, p: float, pool: int,
                      eps: float = 1e-5,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """``(conv - mean) * rsqrt(var + eps) * gamma + beta`` -> erf-GELU ->
    dropout(p) -> ``MaxPool1d(pool)``; ``conv (B, T, C)`` NLC, the rest
    ``(C,)``. Returns ``(B, T // pool, C)``, differentiable in ``conv``,
    ``gamma`` and ``beta`` (pass ``mean``/``var`` without gradient).

    Dropout draws from ``generator`` (on the tensor's device; the default
    generator when None). A CPU tensor takes the plain versions; a CUDA
    tensor launches the kernels, or raises.
    """
    with_code = torch.is_grad_enabled() and any(
        v.requires_grad for v in (conv, gamma, beta))  # the backward's routing table
    return _StemTail.apply(conv, gamma, beta, mean, var, float(p), pool, eps, generator,
                           with_code)


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------


def stem_tail_bwd_plain(conv, dpool, code, scale, shift, mean, inv, p: float, pool: int):
    """Plain PyTorch version of :func:`stem_tail_bwd` (one partial chunk)."""
    b, t, c = conv.shape
    t_out = dpool.shape[1]
    code = code.long()
    jwin = code % pool
    x = conv[:, : t_out * pool].reshape(b, t_out, pool, c).gather(2, jwin[:, :, None]).squeeze(2)
    y = x * scale + shift
    phi = torch.exp(-0.5 * y * y) * 0.3989422804014327
    g = dpool * (0.5 * (1.0 + torch.erf(y * 0.7071067811865476)) + y * phi)
    g = torch.where(code >= pool, g * _keep_scale(p), 0.0)
    dy = torch.zeros(b, t_out, pool, c, dtype=conv.dtype, device=conv.device)
    dy.scatter_(2, jwin[:, :, None], g[:, :, None])
    xhat = (x - mean) * inv
    return (dy.reshape(b, t_out * pool, c), (g * xhat).sum((0, 1))[None],
            g.sum((0, 1))[None])


def stem_tail_bwd(conv, dpool, code, scale, shift, mean, inv, p: float, pool: int):
    """Winner-routed backward of the stem tail: ``(dy (B, t_out * pool, C),
    dgamma partials (chunks, C), dbeta partials (chunks, C))``; the caller
    sums the partials over their first axis. ``scale = gamma * inv`` and
    ``shift = beta - mean * scale`` with ``inv = rsqrt(var + eps)``."""
    if conv.device.type == "cpu":
        return stem_tail_bwd_plain(conv, dpool, code, scale, shift, mean, inv, p, pool)
    if conv.device.type != "cuda":
        raise ValueError(f"no stem-tail kernel for device {conv.device}")
    device = conv.device
    b, t, c = conv.shape
    t_out = t // pool
    check_cuda_f32("conv", conv, device)
    check_cuda_f32("dpool", dpool, device, (b, t_out, c))
    if code.dtype != torch.int32 or code.device != device or tuple(code.shape) != (b, t_out, c):
        raise ValueError("code must be the forward's int32 (B, T // pool, C) tensor")
    for name, v in (("scale", scale), ("shift", shift), ("mean", mean), ("inv", inv)):
        check_cuda_f32(name, v, device, (c,))
    chunks = -(-(b * t_out) // _ROWS_PER_CHUNK)
    dy = torch.empty(b, t_out * pool, c, device=device, dtype=torch.float32)
    dg_part = torch.empty(chunks, c, device=device, dtype=torch.float32)
    db_part = torch.empty(chunks, c, device=device, dtype=torch.float32)
    BWD_KERNEL.launch(device, ptr(conv), ptr(dpool), ptr(code), ptr(scale), ptr(shift),
                      ptr(mean), ptr(inv), _keep_scale(p), ptr(dy), ptr(dg_part),
                      ptr(db_part), b, t, c, pool, _ROWS_PER_CHUNK)
    return dy, dg_part, db_part

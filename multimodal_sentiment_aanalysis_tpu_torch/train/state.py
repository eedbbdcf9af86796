"""Train-step helpers of the single-subject and LOSO trainers.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/state.py``. For
the single-subject trainer:

- :func:`clip_by_global_norm`: scale every gradient by
  ``min(1, max_norm / (norm + 1e-6))``, the JAX function's rule (and
  torch ``clip_grad_norm_``'s);
- :func:`make_adamw`: ``torch.optim.AdamW`` over the given param groups; the
  JAX package runs optax ``adamw`` (no kernel), and one step of both agrees
  to float noise (``tests/test_torch_port_train.py``) with torch's default
  implementation on either device;
- :func:`set_learning_rate` on every param group;
- :class:`RunningStatsSnapshot`: the NaN skip's memory of the BatchNorm
  running stats. The JAX step selects old or new params, optimizer state and
  batch stats with ``jnp.where`` on a finite loss; here the loss is checked
  before ``backward``, so a skipped batch never reaches the optimizer
  (params and optimizer state are untouched) and only the running stats,
  which the forward already moved, are put back.

For the LOSO trainer, whose S models' parameters are the rows of one
``(S, N)`` tensor (the JAX trainer's ``vmap``-stacked pytree, flattened):

- :func:`clip_rows_by_global_norm`: the same clip rule per model;
- :class:`StackedAdamW`: optax ``adamw`` arithmetic over the rows, each
  model with its own step count and learning-rate lane, and the per-model
  NaN skip as a select on the device (``ok = isfinite(loss) & active``
  keeps the old row, moments and count where false), so a step never
  reads anything back to the host; with ``moment_dtype=torch.bfloat16`` it
  is the JAX ``adamw_lowp``;
- :func:`cast_floating`: the mixed-precision cast of a parameter row or an
  input batch (JAX ``cast_floating``).

Module and update masks (the phased curriculum) wait for ROADMAP A7.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn


def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the ``.grad`` of ``params`` in place by ``min(1, max_norm /
    (norm + 1e-6))``; returns the global norm before clipping."""
    return torch.nn.utils.clip_grad_norm_(list(params), max_norm)


def make_adamw(param_groups: list[dict], lr: float, weight_decay: float) -> torch.optim.AdamW:
    """AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, decoupled
    weight decay on every parameter)."""
    return torch.optim.AdamW(param_groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class RunningStatsSnapshot:
    """Copies of every BatchNorm running mean and variance of ``model``,
    taken at construction; :meth:`restore` writes them back."""

    def __init__(self, model: nn.Module):
        self._pairs = [(buf, buf.detach().clone())
                       for m in model.modules() if isinstance(m, nn.BatchNorm1d)
                       for buf in (m.running_mean, m.running_var)]

    @torch.no_grad()
    def restore(self) -> None:
        for buf, saved in self._pairs:
            buf.copy_(saved)


def cast_floating(t: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``t`` (a parameter row, an input) in the compute ``dtype``; as it is
    when None. The cast is differentiable, so a row's gradient reaches the
    fp32 master row rounded to ``dtype``, as in the JAX trainer."""
    return t if dtype is None else t.to(dtype)


def clip_rows_by_global_norm(grads: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Each row of ``grads (S, N)`` (one model's flattened gradient) scaled
    by ``min(1, max_norm / (norm + 1e-6))`` with its own global norm."""
    norm = torch.linalg.vector_norm(grads, dim=1)
    return grads * torch.clamp(max_norm / (norm + 1e-6), max=1.0)[:, None]


class StackedAdamW:
    """optax ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay
    on every parameter) over the rows of an ``(S, N)`` parameter tensor.

    ``lr`` is an ``(S,)`` lane on the device, so a per-model plateau
    schedule writes it without a host sync. :meth:`step` updates the rows
    in place (views of them stay valid) where ``ok`` is true and leaves the
    row, its moments and its step count as they were elsewhere.

    ``moment_dtype`` is the dtype the moments are carried in (the
    parameters' when None), JAX ``scale_by_adam_lowp``: each step reads them
    into the gradients' dtype, forms the new moments and the update there,
    and rounds only what it carries to the next step. With the parameters'
    dtype every step is bit-identical to the fp32 optimizer.
    """

    def __init__(self, params: torch.Tensor, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype: torch.dtype | None = None):
        s = params.shape[0]
        self.lr = torch.full((s,), lr, dtype=torch.float32, device=params.device)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.moment_dtype = params.dtype if moment_dtype is None else moment_dtype
        self.mu = torch.zeros_like(params, dtype=self.moment_dtype)
        self.nu = torch.zeros_like(params, dtype=self.moment_dtype)
        self.count = torch.zeros(s, dtype=torch.int32, device=params.device)

    @torch.no_grad()
    def step(self, params: torch.Tensor, grads: torch.Tensor, ok: torch.Tensor) -> None:
        b1, b2 = self.b1, self.b2
        count = self.count + 1
        mu = (1.0 - b1) * grads + b1 * self.mu.to(grads.dtype)
        nu = (1.0 - b2) * (grads * grads) + b2 * self.nu.to(grads.dtype)
        mu_hat = mu / (1.0 - b1 ** count.to(torch.float32))[:, None]
        nu_hat = nu / (1.0 - b2 ** count.to(torch.float32))[:, None]
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * params
        keep = ok[:, None]
        params.copy_(torch.where(keep, params + -self.lr[:, None] * update, params))
        self.mu = torch.where(keep, mu.to(self.moment_dtype), self.mu)
        self.nu = torch.where(keep, nu.to(self.moment_dtype), self.nu)
        self.count = torch.where(ok, count, self.count)

"""Train-step helpers of the single-subject trainer.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/state.py``:

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

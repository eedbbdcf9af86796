"""Train-step helpers of the single-subject and LOSO trainers.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/state.py``. For
the single-subject trainer:

- :func:`clip_by_global_norm`: scale every gradient by
  ``min(1, max_norm / (norm + 1e-6))``, the JAX function's rule (and
  torch ``clip_grad_norm_``'s); where some parameters are shards of a
  tensor-parallel model, ``norm`` is the whole parameter vector's
  (:func:`..parallel.collectives.global_grad_norm`), as GSPMD forms it;
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
  input batch (JAX ``cast_floating``);
- :class:`RowLayout`: where each parameter and BatchNorm running stat of
  the model sits in its row, shared by the LOSO and phased trainers.

Module masks (the phased curriculum, JAX ``module_mask``,
``zero_masked_grads`` and ``make_masked_adamw``), in two forms:

- on a module: :func:`module_mask` gives each parameter name a flag,
  :func:`apply_grad_mask` sets ``requires_grad`` to the grad set's flags (a
  frozen parameter gets no gradient and stays out of the clip norm, as a
  zeroed JAX gradient does), and :func:`make_masked_adamw` is a
  ``torch.optim.AdamW`` over the update set alone;
- on the ``(S, N)`` row: a mask is a list of column ranges
  (:meth:`RowLayout.columns`); the phased trainer's loss takes the views
  outside the grad set's ranges detached, so their gradient columns are
  zero, and ``StackedAdamW(columns=...)`` updates only the update set's
  columns: the others get no update and no weight decay, which is what
  ``optax.masked(adamw)`` followed by ``zero_masked_grads`` computes.

A mask names the JAX package's top-level modules (``eeg_net``,
``fusion_stack``, ``attn_w1``, ...); :func:`module_of` maps a port
parameter name to its JAX module. A top-level leaf that is a bare array
(``temperature``, ``contrastive_weight``) is selected only when its own
name is listed.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch
import torch.nn as nn

from ..parallel.collectives import global_grad_norm


def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the ``.grad`` of ``params`` in place by ``min(1, max_norm /
    (norm + 1e-6))``; returns the global norm before clipping. Shards of a
    tensor-parallel model (tagged ``tp_axis``) count with every model
    rank's block: a collective over the model axis, so every rank calls it."""
    params = list(params)
    if not any(getattr(p, "tp_axis", None) is not None for p in params):
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    norm = global_grad_norm(params)
    coef = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(coef.to(p.grad.dtype))
    return norm


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


def as_dtype(name: str | torch.dtype | None) -> torch.dtype | None:
    """``"bfloat16"`` (the JAX argument's spelling) or a torch dtype."""
    return getattr(torch, name) if isinstance(name, str) else name


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
    """optax ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay)
    over the rows of an ``(S, N)`` parameter tensor.

    ``lr`` is an ``(S,)`` lane on the device, so a per-model plateau
    schedule writes it without a host sync. :meth:`step` updates the rows
    in place (views of them stay valid) where ``ok`` is true (every row when
    it is None) and leaves the row, its moments and its step count as they
    were elsewhere.

    ``columns`` is the update mask, a list of ``(start, stop)`` column
    ranges (every column when None): the columns outside it get no update
    and no weight decay, and the moments cover only the columns inside it.
    :meth:`reset` zeroes the moments and the step counts (JAX ``tx.init``).

    ``moment_dtype`` is the dtype the moments are carried in (the
    parameters' when None), JAX ``scale_by_adam_lowp``: each step reads them
    into the gradients' dtype, forms the new moments and the update there,
    and rounds only what it carries to the next step. With the parameters'
    dtype every step is bit-identical to the fp32 optimizer.
    """

    def __init__(self, params: torch.Tensor, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype: torch.dtype | None = None,
                 columns: list[tuple[int, int]] | None = None):
        s, n = params.shape
        self.lr = torch.full((s,), lr, dtype=torch.float32, device=params.device)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.moment_dtype = params.dtype if moment_dtype is None else moment_dtype
        self.columns = [(0, n)] if columns is None else list(columns)
        width = sum(stop - start for start, stop in self.columns)
        self.mu = torch.zeros((s, width), dtype=self.moment_dtype, device=params.device)
        self.nu = torch.zeros_like(self.mu)
        self.count = torch.zeros(s, dtype=torch.int32, device=params.device)

    @torch.no_grad()
    def reset(self) -> None:
        self.mu.zero_()
        self.nu.zero_()
        self.count.zero_()

    @torch.no_grad()
    def step(self, params: torch.Tensor, grads: torch.Tensor,
             ok: torch.Tensor | None = None) -> None:
        b1, b2 = self.b1, self.b2
        count = self.count + 1
        c1 = (1.0 - b1 ** count.to(torch.float32))[:, None]
        c2 = (1.0 - b2 ** count.to(torch.float32))[:, None]
        keep = None if ok is None else ok[:, None]
        at = 0
        for start, stop in self.columns:
            p, g = params[:, start:stop], grads[:, start:stop]
            m_old, v_old = self.mu[:, at:at + stop - start], self.nu[:, at:at + stop - start]
            at += stop - start
            mu = (1.0 - b1) * g + b1 * m_old.to(g.dtype)
            nu = (1.0 - b2) * (g * g) + b2 * v_old.to(g.dtype)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
            new = p + -self.lr[:, None] * update
            mu, nu = mu.to(self.moment_dtype), nu.to(self.moment_dtype)
            if keep is not None:
                new, mu, nu = (torch.where(keep, a, b) for a, b in
                               ((new, p), (mu, m_old), (nu, v_old)))
            p.copy_(new)
            m_old.copy_(mu)
            v_old.copy_(nu)
        self.count = count if ok is None else torch.where(ok, count, self.count)


# --------------------------------------------------------------------------
# module masks (the phased curriculum)
# --------------------------------------------------------------------------

# the JAX top-level modules that the port names otherwise, by port prefix
_JAX_MODULES = {"attention_weights.0": "attn_w1", "attention_weights.2": "attn_w2",
                "fusion": "fusion_stack"}


def module_of(name: str) -> str:
    """The JAX package's top-level module (or bare leaf) of the port
    parameter ``name``."""
    for prefix, module in _JAX_MODULES.items():
        if name.startswith(prefix + "."):
            return module
    return name.split(".")[0]


def module_mask(names: Iterable[str], module_names: Iterable[str]) -> dict[str, bool]:
    """Each parameter name -> whether it lies under one of the named JAX
    top-level modules (JAX ``module_mask`` over the flax tree)."""
    selected = set(module_names)
    return {n: module_of(n) in selected for n in names}


def apply_grad_mask(model: nn.Module, mask: dict[str, bool]) -> None:
    """``requires_grad`` of each parameter of ``model`` set to its flag:
    the module form of JAX ``zero_masked_grads`` before the clip."""
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])


def make_masked_adamw(model: nn.Module, update_mask: dict[str, bool], lr: float,
                      weight_decay: float) -> torch.optim.AdamW:
    """AdamW over the parameters of ``model`` that ``update_mask`` selects
    (JAX ``make_masked_adamw``): the others are never stepped or decayed."""
    return make_adamw([{"params": [p for n, p in model.named_parameters() if update_mask[n]]}],
                      lr, weight_decay)


class RowLayout:
    """Where each parameter of ``model`` (then each ``extra`` entry, a
    ``(name, shape)``) sits in a flattened parameter row, and each of its
    BatchNorm running means and variances in a flattened stats row: the
    stacked state of the LOSO and phased trainers."""

    def __init__(self, model: nn.Module, extra: Iterable[tuple[str, tuple]] = ()):
        named = list(model.named_parameters())
        extra = list(extra)
        self.names = [n for n, _ in named] + [n for n, _ in extra]
        self.shapes = [p.shape for _, p in named] + [torch.Size(s) for _, s in extra]
        self.sizes = [math.prod(s) for s in self.shapes]
        buffers = dict(model.named_buffers())
        self.stat_names = [f"{name}.{part}" for name, m in model.named_modules()
                           if isinstance(m, nn.BatchNorm1d)
                           for part in ("running_mean", "running_var")]
        self.stat_shapes = [buffers[n].shape for n in self.stat_names]

    @staticmethod
    def _views(row: torch.Tensor, names: list, shapes: list) -> dict[str, torch.Tensor]:
        sizes = [math.prod(s) for s in shapes]
        lead = row.shape[:-1]
        return {n: p.view((*lead, *s)) for n, p, s in zip(names, row.split(sizes, -1), shapes)}

    def params(self, row: torch.Tensor) -> dict[str, torch.Tensor]:
        """Named views of parameter row(s) ``(..., N)``."""
        return self._views(row, self.names, self.shapes)

    def stats(self, row: torch.Tensor) -> dict[str, torch.Tensor]:
        """Named views of BN-stat row(s) ``(..., M)``."""
        return self._views(row, self.stat_names, self.stat_shapes)

    def columns(self, module_names: Iterable[str]) -> list[tuple[int, int]]:
        """The column ranges of the parameters under ``module_names`` (JAX
        top-level names), adjacent ranges merged."""
        mask = module_mask(self.names, module_names)
        ranges: list[tuple[int, int]] = []
        at = 0
        for name, size in zip(self.names, self.sizes):
            if mask[name]:
                if ranges and ranges[-1][1] == at:
                    ranges[-1] = (ranges[-1][0], at + size)
                else:
                    ranges.append((at, at + size))
            at += size
        return ranges

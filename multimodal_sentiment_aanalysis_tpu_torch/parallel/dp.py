"""Batch data parallelism over a mesh's ranks.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/parallel/dp.py``, one
process per rank. Two forms, as in JAX:

1. the ``shard_map`` form, with *local* semantics
   (:func:`make_dp_train_step`, :func:`make_dp_eval_step`): each rank runs
   the loss on its block of the batch with its own BatchNorm statistics
   and contrastive terms; the gradients are summed over ranks weighted by
   each rank's share of the valid rows (so the CE means are the global
   batch's), the BatchNorm running stats averaged, the metric sums summed;
   then the grad mask, the global-norm clip, the masked optimizer step run
   identically on every rank, so the parameters stay replicated;
2. the GSPMD form, with *global* semantics (:func:`global_batch_step`, and
   :class:`..train.MultiTaskTrainer` with ``mesh=``): the step runs on the
   rank's block inside :func:`.collectives.global_batch`, where every site
   that reduces over the batch (BatchNorm statistics, the stem tail's
   backward, the in-model InfoNCE, the masked CE means) reduces over the
   global batch, so the result is the one-process step's.

The dropout masks of a rank come from its own generator (the caller's; the
trainers seed it from ``(seed, rank)``, :func:`.mesh.rank_seed`), so a
multi-rank run equals the one-process run only at dropout 0.

On a tensor-parallel ``(data, model)`` mesh (:mod:`.tp`) both forms work on
the data axis: each rank takes its data row's block of the batch, the
gradients and the BatchNorm running stats are summed over the data axis
alone (a replicated parameter's gradient is already the same on every model
rank, a shard's is its own block), and the global-norm clip forms the whole
parameter vector's norm (:func:`..train.state.clip_by_global_norm`).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn as nn

from ..train.state import clip_by_global_norm
from .collectives import global_batch, reduce_sum_, sum_grads_
from .mesh import _map, shard_batch


def pad_batch_to_devices(batch: dict, mask: torch.Tensor, n_devices: int):
    """Pad a ``(B, ...)`` batch so that B divides by ``n_devices``: copies
    of row 0, masked out."""
    rem = -mask.shape[0] % n_devices
    if rem == 0:
        return batch, mask
    batch = {k: torch.cat([v, v[:1].expand(rem, *v.shape[1:])]) for k, v in batch.items()}
    return batch, torch.cat([mask, mask.new_zeros(rem)])


def make_dp_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, mesh,
                       clip_norm: float | None = 1.0, grad_mask: dict[str, bool] | None = None,
                       update_mask: dict[str, bool] | None = None) -> Callable:
    """A data-parallel train step with the ``shard_map`` form's local
    semantics (module docstring).

    ``loss_fn(params, stats, batch, generator) -> (loss, sums)`` has
    :func:`..train.make_phase_loss`'s shape: ``loss`` a mean over
    ``batch['mask']``'s valid rows, ``sums`` metric sums over them, the
    BatchNorm running stats moved in place through the ``stats`` tensors.
    ``optimizer`` holds (some of) the ``params`` tensors. ``grad_mask`` and
    ``update_mask`` map a parameter name to whether it is in the grad set
    (outside it the gradient is zero, as JAX's ``zero_masked_grads``) and
    the update set (outside it no update and no weight decay).

    Returns ``step(params, stats, batch, generator=None) -> sums``: ``batch``
    is the global batch (its leading axis divisible by the mesh size, e.g.
    through :func:`pad_batch_to_devices`), each rank takes its block; the
    returned sums are the global batch's.
    """
    group, world = mesh.get_group(0), mesh.size(0)

    def step(params: dict[str, torch.Tensor], stats: dict[str, torch.Tensor], batch: dict,
             generator: torch.Generator | None = None) -> torch.Tensor:
        local = shard_batch(mesh, batch)
        for p in params.values():
            p.grad = None
        loss, sums = loss_fn(params, stats, local, generator)
        loss.backward()
        n_local, n = local["mask"].sum(), batch["mask"].sum()  # every rank holds the batch
        names = [k for k, p in params.items() if p.grad is not None]
        sum_grads_([params[k] for k in names], group,
                   torch.where(n > 0, n_local / n.clamp_min(1.0), 0.0))
        with torch.no_grad():
            for s in stats.values():
                if s.is_floating_point():
                    reduce_sum_(s, group).div_(world)
        if grad_mask is not None:
            for k in names:
                if not grad_mask[k]:
                    params[k].grad.zero_()
        if clip_norm is not None:
            clip_by_global_norm([params[k] for k in names], clip_norm)
        if update_mask is not None:
            for k in names:
                if not update_mask[k]:
                    params[k].grad = None  # the optimizer skips it: no update, no decay
        optimizer.step()
        return reduce_sum_(sums.detach().clone(), group)

    return step


def make_dp_eval_step(metrics_fn: Callable, mesh) -> Callable:
    """A data-parallel evaluation: ``metrics_fn(params, stats, batch)``
    returns sums over the block's valid rows (a tensor, or a dict of
    them); the ranks' sums are summed, so the caller divides by the global
    count once. Returns ``eval_step(params, stats, batch)`` over the global
    ``batch``."""
    group = mesh.get_group(0)

    @torch.no_grad()
    def eval_step(params: dict, stats: dict, batch: dict):
        out = metrics_fn(params, stats, shard_batch(mesh, batch))
        return _map(lambda m: reduce_sum_(m.detach().clone(), group), out)

    return eval_step


def _grad_leaves(state: Any) -> list[torch.Tensor]:
    if isinstance(state, nn.Module):
        return [p for p in state.parameters() if p.requires_grad]
    if isinstance(state, torch.Tensor):
        return [state] if state.requires_grad and state.is_leaf else []
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        return [t for s in state for t in _grad_leaves(s)]
    return []


def global_batch_step(step_fn: Callable, mesh) -> Callable:
    """The GSPMD form (JAX ``gspmd_jit_step``): ``step_fn(state, batch) ->
    (state, metrics)``, a one-process step whose ``state`` holds the
    replicated model (modules or leaf tensors) and its optimizer, run on
    this rank's block of the global ``batch`` inside
    :func:`.collectives.global_batch`, whose valid rows are
    ``batch['mask']``'s (every row where it has no ``"mask"``). Each
    gradient of the state's parameters is summed over the ranks as it is
    accumulated (before ``step_fn`` reads it), and each tensor of ``metrics`` (this rank's share
    of a loss, or of a sum) is summed over the ranks, so the step is the
    one-process step on the global batch."""
    group = mesh.get_group(0)

    def sum_grad(t: torch.Tensor) -> None:
        reduce_sum_(t.grad, group)

    def step(state, batch):
        hooks = [p.register_post_accumulate_grad_hook(sum_grad) for p in _grad_leaves(state)]
        rows = next(iter(batch.values()))
        count = (batch["mask"].sum() if "mask" in batch
                 else torch.tensor(float(rows.shape[0]), device=rows.device))
        try:
            with global_batch(group, count):
                new_state, metrics = step_fn(state, shard_batch(mesh, batch))
        finally:
            for h in hooks:
                h.remove()
        return new_state, _map(lambda m: reduce_sum_(m.detach().clone(), group)
                               if isinstance(m, torch.Tensor) else m, metrics)

    return step

"""The few collectives the port's parallelism uses, on ``torch.distributed``.

Port-only plumbing (the JAX package gets its collectives from ``psum`` /
``pmean`` and GSPMD). Every collective here is built from ``all_reduce``
and ``broadcast`` alone: those two (and ``barrier``) are what the ``gloo``
backend offers for CUDA tensors, and two ``gloo`` ranks on one card are how
a one-card machine runs a multi-rank program (NCCL refuses two ranks on one
device). ``torch.distributed.nn.functional`` is not used: its gather's
backward needs ``reduce_scatter``, which ``gloo`` lacks on CUDA.

- :func:`all_reduce_sum`: the sum over ranks, differentiable (the
  gradient of a sum is the sum of the ranks' gradients);
- :func:`gather_blocks`: every rank's equal-shaped block, stacked in rank
  order along ``dim``, differentiable (a zero-filled ``(W, ...)`` buffer
  with the rank's own slot written in, all-reduced; the backward is this
  rank's slice of the all-reduced gradient), and :func:`gather_rows`, the
  same without a graph;
- :func:`broadcast_from`: a tensor from one rank to all.

- :func:`sum_grads_`: the ``.grad`` of a set of parameters summed over the
  ranks in one all-reduce, optionally weighted.

:data:`TRAFFIC` counts the bytes and calls of every all-reduce made here
in this process (:func:`reset_traffic` zeroes it), as the kernels' launch
counters count launches.

The global-batch context: :func:`global_batch` marks the forwards run
inside it as one rank's block of a batch spread over ``group``, whose
valid-row count the caller passes (every rank holds the whole planned
mask, so it costs no collective). The sites that reduce over the batch
(BatchNorm statistics, the stem tail's backward, the in-model InfoNCE, the
masked CE means and accuracies) read :func:`batch_group` or
:func:`global_count` and, under a group of more than one rank, reduce over
every rank's rows; outside the context (or under one rank) each stays
exactly what it is in one process. The context is entered explicitly by
the data-parallel trainers and steps (:class:`..train.MultiTaskTrainer`,
:mod:`.dp`), never read from the environment.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch
import torch.distributed as dist

# (group, the global batch's valid-row count) of the enclosing global_batch
_GLOBAL_BATCH: contextvars.ContextVar = contextvars.ContextVar("msa_global_batch", default=None)
TRAFFIC = {"all_reduce_calls": 0, "all_reduce_bytes": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


@contextlib.contextmanager
def global_batch(group, count: torch.Tensor) -> Iterator[None]:
    """Run the forwards (and their backwards) inside as one rank's block of
    a batch spread over ``group``, ``count`` the whole batch's valid rows
    (its mask's sum); a group of one rank, or None, changes nothing."""
    multi = group is not None and dist.get_world_size(group) > 1
    if multi and count is None:
        raise ValueError("a batch spread over several ranks needs its valid-row count")
    token = _GLOBAL_BATCH.set((group, count) if multi else None)
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def batch_group():
    """The process group of the enclosing :func:`global_batch`, or None."""
    ctx = _GLOBAL_BATCH.get()
    return None if ctx is None else ctx[0]


def global_count(mask: torch.Tensor) -> torch.Tensor:
    """``mask.sum()`` over the enclosing global batch (the count
    :func:`global_batch` was given): this rank's alone outside it."""
    ctx = _GLOBAL_BATCH.get()
    return mask.sum() if ctx is None else ctx[1]


def reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in place, without a graph."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    TRAFFIC["all_reduce_calls"] += 1
    TRAFFIC["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_sum_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_sum_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its gradient is the sum
    of the ranks' gradients."""
    return _AllReduceSum.apply(x, group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """``(W, *x.shape)``: rank r's ``x`` at ``[r]``, without a graph."""
    buf = x.new_zeros((dist.get_world_size(group), *x.shape))
    buf[dist.get_rank(group)] = x.detach()
    return reduce_sum_(buf, group)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_sum_(grad.contiguous().clone(), ctx.group)[dist.get_rank(ctx.group)], None


def gather_blocks(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape), concatenated in rank order
    along ``dim``, differentiable."""
    out = _GatherBlocks.apply(x, group) if x.requires_grad else _gather(x, group)
    return torch.cat(out.unbind(0), dim=dim)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order, without a
    graph (results and state at the subject-sharded trainers' boundaries)."""
    return _gather(x, group).flatten(0, 1)


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` as rank ``src`` of ``group`` holds it (``x`` must have the same
    shape and dtype on every rank), in place."""
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


def sum_grads_(params: list[torch.Tensor], group, weight: torch.Tensor | float = 1.0) -> None:
    """Replace the ``.grad`` of each of ``params`` that has one by
    ``weight`` times it, summed over the ranks of ``group``: one all-reduce
    of the gradients laid end to end."""
    got = [p for p in params if p.grad is not None]
    flat = reduce_sum_(torch.cat([p.grad.reshape(-1) for p in got]) * weight, group)
    for p, g in zip(got, flat.split([p.numel() for p in got])):
        p.grad.copy_(g.view_as(p))

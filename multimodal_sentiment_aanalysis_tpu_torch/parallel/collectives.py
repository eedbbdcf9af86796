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

The model axis of tensor parallelism (:mod:`.tp`), Megatron's three
autograd pairs over its process group, each a method of :class:`ModelAxis`:

- :meth:`ModelAxis.copy`: identity forward, sum all-reduce backward (a
  replicated activation entering a sharded region: each rank's input
  gradient is a partial sum);
- :meth:`ModelAxis.reduce`: sum all-reduce forward, identity backward (the
  partial products of a row-parallel layer leaving it);
- :meth:`ModelAxis.gather`: every rank's block concatenated along ``dim``
  forward; the backward takes this rank's slice of the gradient with **no
  sum**, since the work downstream of a gather is replicated, so every
  model rank already holds the whole gradient. (:func:`gather_blocks` sums
  in its backward, which is right on the data axis, where each rank's term
  is its own, and would multiply every sharded gradient by the axis size
  here.)

:func:`global_grad_norm` is the norm of a whole parameter vector some of
whose tensors are model-axis shards (tagged ``tp_axis`` by
:func:`.tp.shard_by_specs`): their squares summed over the model axis,
every replicated tensor counted once.

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


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_sum_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return reduce_sum_(x.detach().contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rank, ctx.dim, ctx.n = dist.get_rank(group), dim, x.shape[dim]
        return torch.cat(_gather(x.contiguous(), group).unbind(0), dim)

    @staticmethod
    def backward(ctx, grad):
        # a copy: two gathered tensors may get views of one gradient (a sum's
        # two inputs), which would leave two parameters' .grad sharing memory
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).clone(), None, None


class ModelAxis:
    """The model axis of a ``(data, model)`` mesh as one rank sees it: its
    process group, its ``size`` and this rank's ``index`` along it. A
    sharded tensor holds block ``index`` of ``size`` equal blocks along its
    split dim. Copying a sharded module keeps the axis (a process group is
    not copied)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)

    def __deepcopy__(self, memo) -> "ModelAxis":
        return self

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (replicated) entering a sharded region: the sum of the
        ranks' input gradients flows back."""
        return _CopyToModel.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial ``x``; the gradient flows back
        unchanged."""
        return _ReduceFromModel.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block ``x`` concatenated along ``dim`` in rank order;
        the backward keeps this rank's slice of the (replicated) gradient."""
        return _GatherFromModel.apply(x, self.group, dim)

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of the replicated ``x`` along ``dim``."""
        n = x.shape[dim] // self.size
        return self.copy(x).narrow(dim, self.index * n, n)

    def whole(self, module, name: str) -> torch.Tensor:
        """``module``'s tensor ``name`` whole: gathered along its split dim
        (``module.tp_split``), as it is where it is replicated."""
        t, dim = getattr(module, name), module.tp_split.get(name)
        return t if dim is None else self.gather(t, dim)


def global_grad_norm(params: list[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of the ``.grad`` s of ``params`` as one vector: the
    squares of the model-axis shards (tensors tagged ``tp_axis``) summed
    over that axis, each replicated tensor counted once."""
    got = [p for p in params if p.grad is not None]
    sq = [p.grad.detach().float().pow(2).sum() for p in got]
    zero = got[0].grad.new_zeros((), dtype=torch.float32)
    shard = sum((s for p, s in zip(got, sq) if getattr(p, "tp_axis", None) is not None), zero)
    whole = sum((s for p, s in zip(got, sq) if getattr(p, "tp_axis", None) is None), zero)
    axis = next(p.tp_axis for p in got if getattr(p, "tp_axis", None) is not None)
    return (reduce_sum_(shard.reshape(1), axis.group)[0] + whole).sqrt()

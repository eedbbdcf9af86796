"""Device meshes over ``torch.distributed`` ranks.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/parallel/mesh.py``. The
JAX package drives every device from one process; the port runs one process
per card, the way ``torchrun`` launches ranks, and a mesh is a
one-dimensional :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, its axis named like JAX's (``"data"``);
tensor parallelism's 2-D ``(data, model)`` mesh is :func:`.tp.make_mesh_2d`.

:func:`make_mesh` (through :func:`start_group`) starts the default group when none exists: from the
``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) when it is set, otherwise a one-process
group, the counterpart of JAX's one-device mesh, which runs the one-device
program. The backend is ``nccl`` for ``cuda`` and ``gloo`` for ``cpu``; a
group the caller started first is used as it is, with its backend (two
``gloo`` ranks on one card, for one). Each rank's device is
``cuda:LOCAL_RANK`` (:func:`mesh_device`), or the CPU when the caller asks
for it. Every group started here waits at most :data:`TIMEOUT` for a
collective, so a dead rank fails the run instead of hanging it.

:class:`SubjectBlocks` is the subject-sharded trainers' split of the padded
LOSO subject axis into one contiguous block per rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.checkpoint import save_checkpoint, set_generator_state
from .collectives import broadcast_from, gather_rows, reduce_sum_

TIMEOUT = datetime.timedelta(seconds=300)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def start_group(device_type: str | None = None) -> str:
    """The default process group, started when there is none (module
    docstring), and this rank's card set; returns the device type
    (``"cuda"`` when None)."""
    device_type = device_type or "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA card and torch finds none; pass "
                               "device_type='cpu' to run on the CPU")
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    timeout=TIMEOUT)
    return device_type


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device_type: str | None = None) -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over the ranks of the default process
    group (started here when there is none; see the module docstring).
    ``device_type`` is ``"cuda"`` (the default) or ``"cpu"``. ``n_devices``
    other than the world size raises: a rank outside the mesh would have
    nothing to run."""
    device_type = start_group(device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} devices, the process group has {world} ranks "
                         f"(launch {n_devices} ranks, e.g. torchrun --nproc-per-node "
                         f"{n_devices})")
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(axis_name,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: ``cuda:<current card>`` (set from ``LOCAL_RANK``
    by :func:`make_mesh`) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: DeviceMesh, tree: Any) -> Any:
    """This rank's contiguous block of every tensor's leading axis (JAX's
    ``P('data')`` layout) over the mesh's first axis, the data axis (the
    whole mesh of a 1-D one), replicated over a 2-D mesh's model axis; the
    leading axis must divide by the data axis's size."""
    w, r = mesh.size(0), mesh.get_local_rank(0)

    def block(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % w:
            raise ValueError(f"a leading axis of {x.shape[0]} does not split over {w} ranks "
                             "(pad it first: pad_batch_to_devices)")
        b = x.shape[0] // w
        return x[r * b:(r + 1) * b]

    return _map(block, tree)


def replicate(mesh: DeviceMesh, tree: Any) -> Any:
    """Every tensor as rank 0 holds it, on every rank (in place)."""
    group = mesh.get_group()
    return _map(lambda x: broadcast_from(x, 0, group), tree)


class SubjectBlocks:
    """The LOSO subject axis padded to a multiple of the mesh size
    (``n_total``; padding model ``s`` reuses subject ``s % n_subjects``, as
    in JAX) and split into one contiguous block of ``n_local`` models per
    rank. Without a mesh: one block of every subject, and each method is the
    identity."""

    def __init__(self, n_subjects: int, mesh: DeviceMesh | None):
        self.group = None if mesh is None else mesh.get_group()
        self.world = 1 if mesh is None else mesh.size()
        self.rank = 0 if mesh is None else mesh.get_local_rank()
        self.n_subjects = n_subjects
        self.n_total = n_subjects + (-n_subjects % self.world)
        self.n_local = self.n_total // self.world
        self.lo, self.hi = self.rank * self.n_local, (self.rank + 1) * self.n_local

    @property
    def sharded(self) -> bool:
        return self.group is not None

    def subject(self, s: int) -> int:
        """The real subject model ``s`` of the padded axis trains on."""
        return s % self.n_subjects

    def local(self, x):
        """This rank's rows ``[lo, hi)`` of a global ``(n_total, ...)`` array."""
        return x[self.lo:self.hi] if self.sharded else x

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's block of ``x`` along ``dim``: the ``n_total`` rows."""
        if not self.sharded:
            return x
        words = x.movedim(dim, 0).contiguous()
        if x.dtype == torch.bool:  # a sum all-reduce of int32, exact for 0/1
            words = words.to(torch.int32)
        return gather_rows(words, self.group).to(x.dtype).movedim(0, dim)

    def owner(self, s: int) -> int:
        return s // self.n_local

    def from_owner(self, s: int, make) -> Any:
        """``make(local_index)`` of model ``s`` on the rank that holds it,
        broadcast to every rank (``make`` returns a dict of tensors; every
        rank calls it on its own block's first model for the shapes)."""
        if not self.sharded:
            return make(s)
        owner = self.owner(s)
        out = make(s - self.lo if owner == self.rank else 0)
        return {k: broadcast_from(v.contiguous(), owner, self.group) for k, v in out.items()}


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout generator: ``seed`` itself on
    rank 0 (so a one-rank mesh draws the one-process stream), a stream of
    its own, drawn from ``(seed, rank)``, on every other rank (JAX:
    ``fold_in(key, axis_index)``). On a ``(data, model)`` mesh ``rank`` is
    the data index (``mesh.get_local_rank("data")``): every model rank of a
    data row draws one stream, so dropout on a replicated activation draws
    one mask on all of them."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)[0] >> 1)


def save_on_rank0(path: str, state: dict, generator: torch.Generator, group) -> str:
    """Write a trainer's ``state`` (its ``"generator"`` entry this rank's
    dropout generator) from rank 0 of ``group`` alone, with every rank's
    generator state under ``"rank_generators"``; every rank calls it and
    returns once the file is written. Without a group, the file as one
    process writes it."""
    if group is not None:
        words = generator.get_state().to(device=generator.device, dtype=torch.int32)
        state["rank_generators"] = list(
            gather_rows(words[None], group).to("cpu", torch.uint8).unbind(0))
    if group is None or dist.get_rank(group) == 0:
        save_checkpoint(path, state)
    if group is not None:  # the others wait for the file
        reduce_sum_(torch.zeros(1, device=generator.device), group)
    return path


def restore_rank_generator(generator: torch.Generator, state: dict, rank: int) -> None:
    """Rank ``rank``'s dropout generator from :func:`save_on_rank0`'s file,
    where it holds one (a file of fewer ranks leaves the others' streams as
    they are)."""
    ranks = state.get("rank_generators", [state["generator"]["state"]])
    if rank < len(ranks):
        set_generator_state(generator, {**state["generator"], "state": ranks[rank]},
                            "generator")

"""Multi-card parallelism on ``torch.distributed``, one process per card.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/parallel/``, which
drives every device from one process; the port runs the ranks the way
``torchrun`` launches them (:func:`.mesh.make_mesh`). JAX's three
flavours:

- **Subject sharding** (``mesh=`` of :class:`..train.VectorizedLOSOTrainer`,
  :class:`..train.VectorizedPhasedTrainer`,
  :class:`..train.VectorizedSimCLRTrainer`): the padded LOSO subject axis
  split into one block of models per rank (:class:`.mesh.SubjectBlocks`);
  a step has no collective, results and state are gathered at their
  boundaries. The production scale-out path (``cli vloso --dp``).
- **Batch data parallelism** (:mod:`.dp`): the ``shard_map`` form with
  local semantics (:func:`make_dp_train_step`, :func:`make_dp_eval_step`)
  and the GSPMD form with global semantics (:func:`.dp.global_batch_step`,
  :class:`..train.MultiTaskTrainer` with ``mesh=``, ``cli phased --dp``).
- **Tensor parallelism** (:mod:`.tp`: :func:`make_mesh_2d`,
  :func:`param_partition_specs`, :func:`shard_by_specs`,
  :func:`batch_sharding`, :func:`gather_state_dict`): JAX's Megatron-style
  layout of the flagship on a ``(data, model)`` mesh, each rank holding its
  JAX shard and computing through sharded forms of the layers that still
  launch the kernels, with explicit collectives over the model axis.

:func:`.dryrun.dryrun_multichip` checks the three flavours at flagship
width over ``n`` ranks. The names of :mod:`.dp`, :mod:`.tp` and
:mod:`.dryrun` load on first use (PEP 562): the model and loss modules
import :mod:`.collectives`, :mod:`.dp` imports the trainers and :mod:`.tp`
the models.
"""

from __future__ import annotations

import importlib

from .mesh import make_mesh, replicate, shard_batch

_LAZY = {
    "make_dp_train_step": "dp",
    "make_dp_eval_step": "dp",
    "pad_batch_to_devices": "dp",
    "global_batch_step": "dp",
    "dryrun_multichip": "dryrun",
    **{name: "tp" for name in ("make_mesh_2d", "param_partition_specs", "shard_by_specs",
                               "batch_sharding", "gather_state_dict")},
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "make_dp_train_step",
    "make_dp_eval_step",
    "pad_batch_to_devices",
    "global_batch_step",
    "dryrun_multichip",
    "make_mesh_2d",
    "param_partition_specs",
    "shard_by_specs",
    "batch_sharding",
    "gather_state_dict",
]

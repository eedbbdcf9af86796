"""Checkpoint files.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/utils/checkpoint.py``
over torch files in place of msgpack: :func:`save_checkpoint` is
``torch.save`` and :func:`load_checkpoint` is ``torch.load`` with
``weights_only=True``, so a file holds tensors, dicts, lists, strings and
numbers only (a trainer's full state stores its dataclasses as dicts and
its numpy generators' ``bit_generator.state`` as the plain dict it is).

- :func:`load_state_dict` reads a model checkpoint as the reference writes
  it (reference ``Tester.py:29-35``): a ``state_dict``, or a dict holding
  one under ``"state_dict"``, with the ``module.`` key prefix of a
  DataParallel model stripped (:func:`strip_module_prefix`);
- :func:`copy_state_` restores a trainer's tensors in place: views of them
  (the BatchNorm stats the forward writes, the optimizer's moment columns)
  stay bound to the restored values;
- :func:`metrics_checkpoint_name`, the metrics-encoded file name.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_checkpoint(path: str, obj: Any) -> str:
    """``torch.save`` ``obj`` to ``path``, creating its directory."""
    path = str(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj, path)
    return path


def load_checkpoint(path: str, map_location: Any = None) -> Any:
    """``torch.load`` of a file :func:`save_checkpoint` wrote, tensors only
    (``weights_only=True``), placed by ``map_location``."""
    return torch.load(str(path), map_location=map_location, weights_only=True)


def strip_module_prefix(state_dict: dict) -> dict:
    """Strip a uniform ``module.`` key prefix (DataParallel checkpoints):
    only when *every* key carries it (reference ``Tester.py:29-35``)."""
    keys = list(state_dict.keys())
    if keys and all(k.startswith("module.") for k in keys):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    return state_dict


def load_state_dict(path: str, map_location: Any = None) -> dict:
    """A model ``state_dict`` from a ``.pt``/``.pth`` file: the file's
    dict, or the one it holds under ``"state_dict"``, prefix-stripped."""
    obj = load_checkpoint(path, map_location)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return strip_module_prefix(dict(obj))


@torch.no_grad()
def copy_state_(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    """``dst.copy_(src)`` once ``src`` has ``dst``'s shape and dtype (a
    file of another configuration raises instead of being cast in)."""
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"{name}: the file holds {tuple(src.shape)} {src.dtype}, the trainer "
                         f"{tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def generator_state(generator: torch.Generator) -> dict:
    """A ``torch.Generator``'s state and the device type it belongs to."""
    return {"device": generator.device.type, "state": generator.get_state()}


def set_generator_state(generator: torch.Generator, saved: dict, name: str) -> None:
    """Restore :func:`generator_state` into ``generator``. A CUDA
    generator's state loads only into a CUDA generator, and a CPU one's
    only into a CPU one: another device type raises."""
    if saved["device"] != generator.device.type:
        raise ValueError(f"{name}: the file holds a {saved['device']} generator's state, which "
                         f"does not load into the trainer's {generator.device.type} generator")
    generator.set_state(saved["state"].cpu())


def metrics_checkpoint_name(prefix: str, metrics: dict[str, float], suffix: str = ".pt") -> str:
    """Metrics-encoded checkpoint file name (reference ``Trainer.py:261``,
    ``MultiTaskTrainer.py:665``)."""
    return "_".join([prefix] + [f"{k}{v:.4f}" for k, v in metrics.items()]) + suffix

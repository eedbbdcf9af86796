"""Device-resident data pipeline.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/data/pipeline.py``: the
whole dataset (~36 MB at MAHNOB-HCI size) is copied to the device once, and
a batch is an ``index_select`` gather on the device. Epochs are static
``(n_batches, batch_size)`` index plans whose tail batch wraps around, with
a validity mask for the padded rows: drawn on the host from a numpy
generator (:func:`epoch_batch_indices`), or on the device from a
``torch.Generator`` (:func:`epoch_plan_on_device`, no host sync).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def epoch_batch_indices(
    n: int,
    batch_size: int,
    rng: np.random.Generator | None = None,
    shuffle: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Static-shape epoch index plan.

    Returns ``(indices, mask)`` of shape ``(n_batches, batch_size)``:
    ``indices`` covers a (shuffled) epoch with the tail batch wrap-padded,
    ``mask`` is 1.0 for real samples and 0.0 for padding.
    """
    order = np.arange(n)
    if shuffle:
        if rng is None:
            rng = np.random.default_rng(0)
        order = rng.permutation(n)
    n_batches = -(-n // batch_size)
    padded = n_batches * batch_size
    pad = np.resize(order, padded)  # wrap-around padding
    mask = np.zeros(padded, np.float32)
    mask[:n] = 1.0
    return (
        pad.reshape(n_batches, batch_size).astype(np.int32),
        mask.reshape(n_batches, batch_size),
    )


class DeviceDataset:
    """A dict of equal-length arrays resident on ``device`` (``"cuda"``
    means the current card, ``cuda:<index>``, where a model's parameters
    land)."""

    def __init__(self, arrays: dict[str, np.ndarray], device: torch.device | str):
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"arrays differ in length: {lengths}")
        self.n = next(iter(lengths.values()))
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.arrays = {k: torch.as_tensor(np.asarray(v), device=self.device)
                       for k, v in arrays.items()}

    def __len__(self) -> int:
        return self.n

    def gather(self, idx: torch.Tensor | np.ndarray) -> dict[str, torch.Tensor]:
        """Rows ``idx`` of every array, gathered on the device: one batch for
        ``idx (B,)``, and ``(S, B, ...)`` for the stacked trainers' ``idx (S,
        B)``."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        flat = idx.reshape(-1)
        return {k: v.index_select(0, flat).view(*idx.shape, *v.shape[1:])
                for k, v in self.arrays.items()}

    def subset(self, idx: np.ndarray) -> "DeviceDataset":
        """A new dataset of rows ``idx`` (made once per experiment)."""
        out = object.__new__(DeviceDataset)
        out.n = len(idx)
        out.device = self.device
        out.arrays = self.gather(idx)
        return out

    def batches(
        self,
        batch_size: int,
        rng: np.random.Generator | None = None,
        shuffle: bool = True,
    ) -> Iterator[tuple[dict[str, torch.Tensor], torch.Tensor]]:
        """Python-level batch iterator: ``(batch, mask)`` per plan row."""
        indices, mask = self.epoch_plan(batch_size, rng, shuffle)
        for b in range(indices.shape[0]):
            yield self.gather(indices[b]), mask[b]

    def epoch_plan(
        self,
        batch_size: int,
        rng: np.random.Generator | None = None,
        shuffle: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident ``(indices, mask)`` of :func:`epoch_batch_indices`,
        drawn from ``rng`` exactly as the JAX package draws it."""
        indices, mask = epoch_batch_indices(self.n, batch_size, rng, shuffle)
        return (torch.as_tensor(indices, device=self.device),
                torch.as_tensor(mask, device=self.device))


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync: a pinned,
    non-blocking copy on a card."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def epoch_plan_on_device(generator: torch.Generator, n: int,
                         batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`epoch_batch_indices`' plan drawn on the generator's device:
    ``torch.randperm`` from ``generator``, wrap-padded to whole batches and
    masked, with nothing read back by the host. Returns int32 ``indices``
    and float32 ``mask``, each ``(n_batches, batch_size)``. Counterpart of
    the JAX ``epoch_plan_on_device`` (its shuffle draws from a JAX key, so
    the two packages' orders differ)."""
    device = generator.device
    order = torch.randperm(n, generator=generator, device=device)
    n_batches = -(-n // batch_size)
    padded = n_batches * batch_size
    tiled = order.repeat(-(-padded // n))[:padded]
    mask = (torch.arange(padded, device=device) < n).to(torch.float32)
    return (tiled.reshape(n_batches, batch_size).to(torch.int32),
            mask.reshape(n_batches, batch_size))

"""Frozen copies of the rules by which the program derives its batches,
pairs and dropout bits from the seed.

The reference works these out again from the seed instead of reading them
from the program:

- :func:`loso_train_rows`: subject ``s``'s leave-one-out training rows
  (trials grouped by subject, the held-out subject's removed);
- :func:`device_epoch_plan`: one model's epoch plan drawn on the device,
  ``torch.randperm`` from the plan generator, tiled to whole batches, the
  tail masked;
- :func:`contrastive_pairs`: the SimCLR stack's balanced pairs of one model
  (a NumPy copy of the reference repository's ``build_contrastive_pairs``);
- :func:`pretrain_plan`: one epoch's pair plans, drawn from the host
  generator model by model;
- :func:`stem_keep_mask`: the stem tail's dropout bits on a card, element
  ``e`` of a model kept iff word ``e mod 4`` of Philox4x32-10 at counter
  ``e div 4`` under the model's 64-bit seed is at least ``round(p 2^32)``;
- :func:`stem_seeds`: those seeds, one int64 per model, drawn on the device
  with ``torch.randint(0, 2**62)`` from the dropout generator.
"""

from __future__ import annotations

import numpy as np
import torch

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_M32 = 0xFFFFFFFF


def loso_train_rows(n_subjects: int, trials: int, held_out: int) -> np.ndarray:
    """The rows of every subject but ``held_out``, in row order."""
    sid = np.repeat(np.arange(n_subjects), trials)
    return np.arange(n_subjects * trials)[sid != held_out]


def device_epoch_plan(generator: torch.Generator, n: int,
                      batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(order (nb, batch) int64, mask (nb, batch) float32)`` positions in
    ``range(n)``, drawn from ``generator`` on its device."""
    order = torch.randperm(n, generator=generator, device=generator.device)
    nb = -(-n // batch)
    tiled = order.repeat(-(-nb * batch // n))[:nb * batch]
    mask = (torch.arange(nb * batch, device=generator.device) < n).to(torch.float32)
    return tiled.reshape(nb, batch), mask.reshape(nb, batch)


def contrastive_pairs(arousal: np.ndarray, valence: np.ndarray, subject_ids: np.ndarray,
                      seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Within each subject every unordered pair of trials is positive iff
    arousal and valence both agree; the larger class is down-sampled to the
    smaller without replacement and the subject's pairs shuffled. Returns
    ``(pairs (P, 2) int64 positions, labels (P,) float32)``."""
    rng = np.random.default_rng(seed)
    pairs_all, labels_all = [], []
    for subj in np.unique(subject_ids):
        idx = np.where(subject_ids == subj)[0]
        if len(idx) < 2:
            continue
        ii, jj = np.triu_indices(len(idx), k=1)
        pos = (arousal[idx][ii] == arousal[idx][jj]) & (valence[idx][ii] == valence[idx][jj])
        pos_pairs = np.stack([idx[ii[pos]], idx[jj[pos]]], 1)
        neg_pairs = np.stack([idx[ii[~pos]], idx[jj[~pos]]], 1)
        if len(pos_pairs) == 0 or len(neg_pairs) == 0:
            continue
        k = min(len(pos_pairs), len(neg_pairs))
        chosen = np.concatenate([pos_pairs[rng.choice(len(pos_pairs), k, replace=False)],
                                 neg_pairs[rng.choice(len(neg_pairs), k, replace=False)]])
        labels = np.concatenate([np.ones(k, np.float32), np.zeros(k, np.float32)])
        perm = rng.permutation(len(chosen))
        pairs_all.append(chosen[perm])
        labels_all.append(labels[perm])
    return np.concatenate(pairs_all).astype(np.int64), np.concatenate(labels_all)


def pretrain_plan(rng: np.random.Generator, n_pairs: np.ndarray, width: int,
                  batch: int) -> np.ndarray:
    """Positions ``(S, nb, batch)`` into each model's pair table (wrapped to
    ``width`` entries): per model a fresh permutation of its ``n_pairs[s]``
    pairs, wrapped modulo its count over ``nb = ceil(width / batch)``
    batches."""
    nb = -(-width // batch)
    out = np.empty((len(n_pairs), nb * batch), np.int64)
    for s, n in enumerate(n_pairs):
        out[s] = rng.permutation(int(n))[np.arange(nb * batch) % int(n)]
    return out.reshape(len(n_pairs), nb, batch)


def stem_seeds(generator: torch.Generator, n_models: int) -> torch.Tensor:
    return torch.randint(0, 2 ** 62, (n_models,), dtype=torch.int64,
                         generator=generator, device=generator.device)


def _mul32(a: torch.Tensor, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` 32-bit words of ``a * b`` for int64 tensors holding
    uint32 values, without overflowing int64."""
    t0 = a * (b & 0xFFFF)
    t1 = a * (b >> 16)
    s = t0 + ((t1 & 0xFFFF) << 16)
    return (t1 >> 16) + (s >> 32), s & _M32


def philox4x32(counter_lo: torch.Tensor, counter_hi: torch.Tensor,
               seed: int) -> torch.Tensor:
    """Philox4x32-10 words ``(N, 4)`` (int64 holding uint32) at the counters
    ``(lo, hi, 0, 0)`` under the key ``(seed low word, seed high word)``."""
    x0, x1 = counter_lo, counter_hi
    x2 = torch.zeros_like(x0)
    x3 = torch.zeros_like(x0)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for _ in range(10):
        hi0, lo0 = _mul32(x0, PHILOX_M[0])
        hi1, lo1 = _mul32(x2, PHILOX_M[1])
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & _M32, (k1 + PHILOX_W[1]) & _M32
    return torch.stack([x0, x1, x2, x3], 1)


def stem_keep_mask(seed: int, shape: tuple[int, int, int], p: float,
                   device) -> torch.Tensor:
    """One model's keep mask over its conv output ``shape = (B, T, C)``
    (channels last, the element index ``(b T + t) C + c``)."""
    n = shape[0] * shape[1] * shape[2]
    idx = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    words = philox4x32(idx & _M32, idx >> 32, int(seed)).reshape(-1)[:n]
    return (words >= min(int(round(p * 2.0 ** 32)), 2 ** 32 - 1)).reshape(shape)

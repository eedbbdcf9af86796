"""Contrastive pair construction for the SimCLR stack.

A numpy copy of ``build_contrastive_pairs`` in
``multimodal_sentiment_aanalysis_tpu/data/pairs.py`` (reference
``dataLoader/DataLoader.py:76-140``): within each subject every unordered
sample pair is positive iff both arousal and valence agree; the larger of the
two classes is down-sampled to the smaller, and the pairs are shuffled. The
generator is drawn in the JAX function's order, subject by subject (two
``choice`` calls, then a ``permutation``), so the same arguments give the
same ``(pair_indices, pair_labels)`` bit for bit.
"""

from __future__ import annotations

import numpy as np


def build_contrastive_pairs(
    arousal: np.ndarray,
    valence: np.ndarray,
    subject_ids: np.ndarray,
    seed: int | np.random.Generator = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Balanced positive/negative pair indices per subject.

    ``arousal``, ``valence``, ``subject_ids``: ``(N,)`` ints; ``seed``: an
    int or a numpy ``Generator``. Returns ``pair_indices (P, 2)`` int32 rows
    of the inputs and ``pair_labels (P,)`` float32, 1.0 for a positive pair.
    A subject with fewer than 2 samples, or without both kinds of pair, adds
    none; with no pairs at all the result is ``(0, 2)`` and ``(0,)``."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    all_pairs: list[np.ndarray] = []
    all_labels: list[np.ndarray] = []
    for subj in np.unique(subject_ids):
        idx = np.where(subject_ids == subj)[0]
        n = len(idx)
        if n < 2:
            continue
        ii, jj = np.triu_indices(n, k=1)
        a, v = arousal[idx], valence[idx]
        pos_mask = (a[ii] == a[jj]) & (v[ii] == v[jj])
        pos_pairs = np.stack([idx[ii[pos_mask]], idx[jj[pos_mask]]], axis=1)
        neg_pairs = np.stack([idx[ii[~pos_mask]], idx[jj[~pos_mask]]], axis=1)
        if len(pos_pairs) == 0 or len(neg_pairs) == 0:
            continue
        num_keep = min(len(pos_pairs), len(neg_pairs))
        pos_sel = pos_pairs[rng.choice(len(pos_pairs), num_keep, replace=False)]
        neg_sel = neg_pairs[rng.choice(len(neg_pairs), num_keep, replace=False)]
        pairs = np.concatenate([pos_sel, neg_sel], axis=0)
        labels = np.concatenate([np.ones(num_keep, np.float32), np.zeros(num_keep, np.float32)])
        perm = rng.permutation(len(pairs))
        all_pairs.append(pairs[perm])
        all_labels.append(labels[perm])
    if not all_pairs:
        return np.zeros((0, 2), np.int32), np.zeros((0,), np.float32)
    return (np.concatenate(all_pairs).astype(np.int32),
            np.concatenate(all_labels).astype(np.float32))

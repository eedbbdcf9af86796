"""Split policies as pure index functions, in numpy alone.

Copies of ``multimodal_sentiment_aanalysis_tpu/data/splits.py``:

- LOSO by subject (reference ``dataLoader/DataLoader.py:45-55``) and by
  index block (``data/Dataset.py:86-113``);
- subject-level holdout 80/5/15 (``dataLoader/MultimodalDataLoader.py:78-110``);
- per-subject fixed counts 16/1/3 (``dataLoader/CrossSubjectDataLoader.py:74-100``);
- shuffled K-fold (``data/Dataset.py:115-138``);
- the binary-label filter: keep {0, 2}, map 2 -> 1 (``data/Dataset.py:69-78``).

The JAX package calls sklearn's ``KFold(shuffle=True)`` and
``train_test_split``; the port has no sklearn, so :func:`_kfold_positions`
and :func:`_train_test_split` compute the same indices from the same
``np.random.RandomState`` draws.
"""

from __future__ import annotations

import math

import numpy as np


def subject_ids_array(n_subjects: int, ex_nums: int) -> np.ndarray:
    """Dense per-sample subject index array, samples grouped by subject."""
    return np.repeat(np.arange(n_subjects), ex_nums)


def loso_split(n_subjects: int, ex_nums: int,
               test_subject_index: int) -> tuple[np.ndarray, np.ndarray]:
    """``(train_idx, test_idx)``: the samples of the subject at position
    ``test_subject_index`` of the subject list are the test set."""
    subject_ids = subject_ids_array(n_subjects, ex_nums)
    test_mask = subject_ids == test_subject_index
    idx = np.arange(n_subjects * ex_nums)
    return idx[~test_mask], idx[test_mask]


def _train_test_split(items: np.ndarray, test_size: float,
                      random_state: int) -> tuple[np.ndarray, np.ndarray]:
    """sklearn ``train_test_split(items, test_size=..., random_state=...)``
    for a float ``test_size``: ``n_test = ceil(test_size * n)``, the test set
    the head of ``RandomState(random_state).permutation(n)`` and the train
    set the rest, in permutation order."""
    n = len(items)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size must lie in (0, 1), got {test_size}")
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(f"test_size {test_size} of {n} samples leaves no train sample")
    perm = np.random.RandomState(random_state).permutation(n)
    return items[perm[n_test:]], items[perm[:n_test]]


def _kfold_positions(n: int, n_splits: int, fold: int,
                     random_state: int) -> tuple[np.ndarray, np.ndarray]:
    """Fold ``fold`` of sklearn ``KFold(n_splits, shuffle=True,
    random_state)`` over ``n`` positions: the positions shuffled by
    ``RandomState(random_state)``, cut into contiguous folds (the first
    ``n % n_splits`` one longer); both sets in ascending order."""
    if n_splits > n:
        raise ValueError(f"cannot have n_splits={n_splits} greater than the number of "
                         f"samples {n}")
    order = np.arange(n)
    np.random.RandomState(random_state).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    start = int(sizes[:fold].sum())
    in_test = np.zeros(n, bool)
    in_test[order[start:start + sizes[fold]]] = True
    return np.flatnonzero(~in_test), np.flatnonzero(in_test)


def subject_holdout_split(
    n_subjects: int,
    ex_nums: int,
    test_size: float = 0.15,
    val_size: float = 0.05,
    random_state: int = 42,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whole subjects into train/val/test sets: two chained train/test splits
    over the subject ids, then the samples of each set."""
    subject_ids = subject_ids_array(n_subjects, ex_nums)
    subjects = np.unique(subject_ids)
    train_s, temp_s = _train_test_split(subjects, test_size + val_size, random_state)
    val_s, test_s = _train_test_split(temp_s, test_size / (test_size + val_size), random_state)
    idx = np.arange(len(subject_ids))
    return (idx[np.isin(subject_ids, train_s)], idx[np.isin(subject_ids, val_s)],
            idx[np.isin(subject_ids, test_s)])


def per_subject_count_split(
    n_subjects: int,
    ex_nums: int,
    train_samples: int = 16,
    val_samples: int = 1,
    random_state: int = 42,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Within each subject: fixed train/val/test sample counts.

    The reference reseeds ``np.random.seed(random_state)`` inside the
    per-subject loop, so every subject gets the *same* shuffle permutation;
    this does too (and, like it, leaves numpy's global RNG reseeded)."""
    subject_ids = subject_ids_array(n_subjects, ex_nums)
    train_idx: list[int] = []
    val_idx: list[int] = []
    test_idx: list[int] = []
    for subject in np.unique(subject_ids):
        sub_idx = np.where(subject_ids == subject)[0]
        np.random.seed(random_state)  # the reference's per-subject reseed
        np.random.shuffle(sub_idx)
        train_idx.extend(sub_idx[:train_samples])
        val_idx.extend(sub_idx[train_samples:train_samples + val_samples])
        test_idx.extend(sub_idx[train_samples + val_samples:])
    return np.array(train_idx), np.array(val_idx), np.array(test_idx)


def kfold_split(
    n_samples: int,
    n_splits: int,
    current_split: int,
    random_state: int = 42,
    indices: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Shuffled K-fold over (optionally pre-filtered) ``indices``: fold
    ``current_split``'s positions mapped back through ``indices``."""
    if not 0 <= current_split < n_splits:
        raise ValueError("current_split must be in the range [0, n_splits)")
    if indices is None:
        indices = np.arange(n_samples)
    train_pos, test_pos = _kfold_positions(len(indices), n_splits, current_split, random_state)
    return indices[train_pos], indices[test_pos]


def binary_label_filter(labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Keep labels {0, 2}; map 2 -> 1. Returns the kept indices and the
    *full* mapped label array, as the reference does."""
    indices = np.where((labels == 0) | (labels == 2))[0]
    mapped = np.where(labels == 2, 1, labels)
    return indices, mapped


def loso_block_split(
    n_samples: int,
    ex_nums: int,
    test_person: int,
    indices: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Block LOSO of the dict-style dataset: the test block is
    ``[test_person * ex_nums, (test_person + 1) * ex_nums)`` intersected with
    the (possibly binary-filtered) ``indices``; train is the rest."""
    if test_person >= n_samples // ex_nums:
        raise ValueError(f"test_person {test_person} out of range for "
                         f"{n_samples // ex_nums} subjects")
    if indices is None:
        indices = np.arange(n_samples)
    start, end = test_person * ex_nums, (test_person + 1) * ex_nums
    test_indices = indices[(indices >= start) & (indices < end)]
    return np.setdiff1d(indices, test_indices), test_indices

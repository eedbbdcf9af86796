"""Leave-one-subject-out split as a pure index function.

A numpy copy of ``loso_split`` in
``multimodal_sentiment_aanalysis_tpu/data/splits.py`` (reference
``dataLoader/DataLoader.py:45-55``): samples are grouped by subject,
``ex_nums`` per subject, and one subject's samples are the test set.
"""

from __future__ import annotations

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

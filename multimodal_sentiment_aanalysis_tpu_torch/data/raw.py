"""Synthetic MAHNOB-HCI-schema dataset.

A numpy copy of ``make_synthetic_hci_data`` in
``multimodal_sentiment_aanalysis_tpu/data/raw.py``: the same seed gives the
same arrays, bit for bit, without importing the JAX package. The real
``hci_data.pkl`` is not distributed; its schema is ``raw_data``,
``features`` (eeg ``(480, 32, 585)``, eye ``(24, 20, 38)``, pps
``(24, 20, 230)``), ``arousal_label``, ``valence_label``, ``subject_list``,
``ch_info`` and ``info``.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_SUBJECT_LISTS

EEG_CHANNELS = 32
EEG_TIME = 585
EYE_DIM = 38
PPS_DIM = 230
N_TRIALS_PER_SUBJECT = 20


def make_synthetic_hci_data(
    seed: int = 42,
    n_subjects: int = 24,
    ex_nums: int = N_TRIALS_PER_SUBJECT,
    subject_lists: list[int] | None = None,
    planted_signal: float = 1.0,
) -> dict:
    """Deterministic synthetic dataset with the reference pickle schema and a
    class-conditional mean shift (``planted_signal``) planted into every
    modality, so a working model beats chance on it."""
    if subject_lists is None:
        subject_lists = list(DEFAULT_SUBJECT_LISTS)[:n_subjects]
    rng = np.random.default_rng(seed)
    n = n_subjects * ex_nums

    arousal = rng.integers(0, 3, size=n).astype(np.int64)
    valence = rng.integers(0, 3, size=n).astype(np.int64)

    # class-conditional signature vectors per modality
    eeg_sig = rng.normal(size=(3, EEG_CHANNELS, EEG_TIME)).astype(np.float32)
    eye_sig = rng.normal(size=(3, EYE_DIM)).astype(np.float32)
    pps_sig = rng.normal(size=(3, PPS_DIM)).astype(np.float32)

    eeg = rng.normal(size=(n, EEG_CHANNELS, EEG_TIME)).astype(np.float32)
    eeg += planted_signal * eeg_sig[arousal]
    eeg += 0.5 * planted_signal * eeg_sig[valence][:, ::-1, :]

    eye = rng.normal(size=(n_subjects, ex_nums, EYE_DIM)).astype(np.float32)
    eye += planted_signal * eye_sig[arousal].reshape(n_subjects, ex_nums, EYE_DIM)
    pps = rng.normal(size=(n_subjects, ex_nums, PPS_DIM)).astype(np.float32)
    pps += planted_signal * pps_sig[valence].reshape(n_subjects, ex_nums, PPS_DIM)

    # a sprinkle of NaNs in non-EEG features, which assemble_features zeroes
    nan_idx = rng.integers(0, eye.size, size=5)
    eye.reshape(-1)[nan_idx] = np.nan

    return {
        "raw_data": {"eeg": eeg.copy()},
        "features": {"eeg": eeg, "eye": eye, "pps": pps},
        "arousal_label": arousal,
        "valence_label": valence,
        "subject_list": np.array(subject_lists),
        "ch_info": [f"EEG{i}" for i in range(EEG_CHANNELS)],
        "info": "synthetic MAHNOB-HCI-schema dataset (deterministic, seeded)",
    }

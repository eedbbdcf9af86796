"""Raw dataset ingest and the synthetic MAHNOB-HCI-schema dataset.

Numpy copies of ``multimodal_sentiment_aanalysis_tpu/data/raw.py``
(reference ``data/RawData.py:15-38``): the dataset ships as one pickle with
keys ``raw_data``, ``features`` (eeg ``(480, 32, 585)``, eye ``(24, 20,
38)``, pps ``(24, 20, 230)``), ``arousal_label``, ``valence_label``,
``subject_list``, ``ch_info`` and ``info``; :class:`RawData` loads it on the
host and :func:`save_pickle` writes one. The real ``hci_data.pkl`` is not
distributed, so :func:`make_synthetic_hci_data` makes a dataset of that
schema: the same seed gives the JAX package's arrays, bit for bit.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np

from ..config import DEFAULT_SUBJECT_LISTS

EEG_CHANNELS = 32
EEG_TIME = 585
EYE_DIM = 38
PPS_DIM = 230
N_TRIALS_PER_SUBJECT = 20


def _load_any_pickle(path: str) -> Any:
    """Load a plain pickle, or a joblib dump (its uncompressed format is a
    plain pickle; a compressed one needs joblib, imported only then)."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except pickle.UnpicklingError as pickle_error:
        try:
            import joblib
        except ImportError as e:
            raise RuntimeError(f"{path} is not a plain pickle, and joblib, which reads "
                               f"compressed dumps, is not installed") from pickle_error
        return joblib.load(path)


class RawData:
    """The dataset pickle as a dict, ``RawData(path).data`` (reference
    ``data/RawData.py:15-38``)."""

    def __init__(self, data_path: str):
        self.data_path = data_path
        self.data = self.load_data()

    def load_data(self) -> dict:
        if not os.path.exists(self.data_path):
            raise FileNotFoundError(f"data path does not exist: {self.data_path}")
        return _load_any_pickle(self.data_path)


def save_pickle(data: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)


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

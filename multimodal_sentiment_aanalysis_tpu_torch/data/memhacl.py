"""ME-MHACL data ingest: ``.npy``-backed arrays, a synthetic stand-in, the
80/20 split.

Numpy copies of ``multimodal_sentiment_aanalysis_tpu/data/memhacl.py``
(reference ``ME-MHACL/data_loader.py:7-77``, ``ME-MHACL/train.py:29-32``),
bit-equal to the JAX functions for the same seed. Each returns the plain
arrays dict that :class:`.pipeline.DeviceDataset` takes.
"""

from __future__ import annotations

import numpy as np


def load_emotion_npy(
    eeg_path: str, eye_path: str, phy_path: str, label_path: str
) -> dict[str, np.ndarray]:
    """Load EEG ``(N, 32, 585)``, eye ``(N, 38)``, physio ``(N, 230)`` and
    labels ``(N, 2)``; the label columns become ``arousal`` and
    ``valence``."""
    eeg = np.load(eeg_path)
    eye = np.load(eye_path)
    phy = np.load(phy_path)
    labels = np.load(label_path)
    if not len(eeg) == len(eye) == len(phy) == len(labels):
        raise ValueError("length mismatch between the four arrays")
    if labels.ndim != 2 or labels.shape[1] != 2:
        raise ValueError(f"labels must be (N, 2), got {labels.shape}")
    return {
        "eeg": eeg.astype(np.float32),
        "eye": eye.astype(np.float32),
        "pps": phy.astype(np.float32),
        "arousal": labels[:, 0].astype(np.int64),
        "valence": labels[:, 1].astype(np.int64),
    }


def make_synthetic_emotion_arrays(
    n: int = 128, seed: int = 0, planted_signal: float = 1.0
) -> dict[str, np.ndarray]:
    """Synthetic stand-in with the ME-MHACL shapes and binary labels; the
    arousal label shifts every modality by ``planted_signal``."""
    rng = np.random.default_rng(seed)
    arousal = rng.integers(0, 2, n).astype(np.int64)
    valence = rng.integers(0, 2, n).astype(np.int64)
    sig = planted_signal * arousal[:, None, None].astype(np.float32)
    return {
        "eeg": (rng.normal(size=(n, 32, 585)) + sig).astype(np.float32),
        "eye": (rng.normal(size=(n, 38)) + sig[:, :, 0]).astype(np.float32),
        "pps": (rng.normal(size=(n, 230)) + sig[:, :, 0]).astype(np.float32),
        "arousal": arousal,
        "valence": valence,
    }


def random_split_indices(
    n: int, train_frac: float = 0.8, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Shuffled indices; the first ``int(train_frac * n)`` train."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_train = int(train_frac * n)
    return order[:n_train], order[n_train:]

"""Feature assembly and normalisation.

A numpy copy of ``assemble_features`` in
``multimodal_sentiment_aanalysis_tpu/data/features.py`` (reference
``data/LoadFeatures.py:24-142``):

1. the precomputed ``data['features'][modality]``, ``np.nan_to_num``-ed;
2. non-EEG modalities get a global z-score then a global min-max, and are
   flattened ``(S, E, D) -> (S*E, D)``;
3. optionally a dataset-level per-feature Z-score (``std == 0 -> 1``) or a
   min-max over the last axis;
4. labels from ``{label_type}_label``.
"""

from __future__ import annotations

import numpy as np


def _global_norm(features: np.ndarray) -> np.ndarray:
    """Global z-score then global min-max (reference LoadFeatures.py:130-142)."""
    features = (features - np.mean(features)) / np.std(features)
    return (features - features.min()) / (features.max() - features.min())


def zscore_normalize(features: np.ndarray) -> np.ndarray:
    """Dataset-level per-feature Z-score with a ``std == 0`` guard."""
    mean = np.mean(features, axis=0)
    std = np.std(features, axis=0)
    std = np.where(std == 0, 1.0, std)
    return (features - mean) / std


def minmax_normalize_lastaxis(data: np.ndarray) -> np.ndarray:
    """Min-max over the last axis with an eps guard."""
    lo = np.min(data, axis=-1, keepdims=True)
    hi = np.max(data, axis=-1, keepdims=True)
    return (data - lo) / ((hi - lo) + 1e-9)


def assemble_features(
    data: dict,
    modalities: list[str],
    subject_lists: list[int] | None = None,
    norm: str | None = "Z_score",
    label_type: str = "arousal",
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """``(features, labels)``: ``features[m]`` shaped ``(N, ...)`` per
    modality and the ``{label_type}_label`` array. ``subject_lists`` is
    accepted and unused, as in the JAX package and the reference."""
    if "features" not in data:
        raise NotImplementedError("needs a dataset dict with precomputed 'features'")
    features: dict[str, np.ndarray] = {}
    for modality in modalities:
        if modality not in data["features"]:
            raise KeyError(f"dataset lacks modality {modality}")
        feature = np.nan_to_num(np.array(data["features"][modality], copy=True))
        if "eeg" not in modality:
            feature = _global_norm(feature)
            feature = feature.reshape(-1, feature.shape[-1])
        if norm == "Z_score":
            feature = zscore_normalize(feature)
        elif norm == "Min_Max":
            feature = minmax_normalize_lastaxis(feature)
        features[modality] = feature

    label_key = "label" if label_type == "ruiwen" else f"{label_type}_label"
    if label_key not in data:
        raise KeyError(f"dataset lacks label key {label_key}")
    label = data[label_key]
    if not isinstance(label, np.ndarray):
        label = np.concatenate(label)
    return features, label

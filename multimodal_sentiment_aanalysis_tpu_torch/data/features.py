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

Beside it: :class:`DataFeatures`, the class facade over a pickle on disk;
:func:`per_subject_zscore`; and the facial action-unit loader
:class:`AuFeatures` with its per-group normalisation.
"""

from __future__ import annotations

import os

import numpy as np

from .raw import RawData


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


def per_subject_zscore(data: np.ndarray, sub_nums: int, ex_nums: int) -> np.ndarray:
    """Per-subject Z-score over the trial axis with nan-aware statistics
    (reference ``common/utils.py:76-95``), to remove inter-subject offsets."""
    eps = 1e-8
    r = data.reshape(sub_nums, ex_nums, -1)
    means = np.nanmean(r, axis=1, keepdims=True)
    stds = np.nanstd(r, axis=1, keepdims=True) + eps
    return ((r - means) / stds).reshape(data.shape)


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
        raise NotImplementedError(
            "raw-signal feature extraction is not wired in the reference either (its "
            "load_<modality>_features dispatch targets undefined methods, reference "
            "LoadFeatures.py:69-71); supply a dict with a 'features' key, or extract features "
            "from data['raw_data'] with multimodal_sentiment_aanalysis_tpu_torch.ops.dsp "
            "(filtering, windows) and .ops.features (e.g. batched(all_frequency_features))")
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


def au_group_normalize(features: np.ndarray, n_au_points: int = 17,
                       features_per_au: int = 7) -> np.ndarray:
    """Each facial action unit's 7-feature block z-scored then min-maxed on
    its own, in float64 (reference ``data/LoadFeatures.py:160-185``)."""
    features = np.array(features, copy=True, dtype=np.float64)
    for au in range(n_au_points):
        lo, hi = au * features_per_au, (au + 1) * features_per_au
        blk = features[:, lo:hi]
        blk = (blk - blk.mean()) / blk.std()
        features[:, lo:hi] = (blk - blk.min()) / (blk.max() - blk.min())
    return features


class AuFeatures:
    """Facial action-unit features (reference ``data/LoadFeatures.py:145-235``):
    per-subject ``{subject}.npy`` files under ``<data dir>/au_feature/``,
    concatenated and NaN-scrubbed. The HCI set ships no AU files; kept for
    the AU branch of the API."""

    def __init__(self, au_data, subject_lists, data_path: str):
        self.au_data = au_data
        self.subject_lists = subject_lists
        self.data_path = data_path
        self.au_features: np.ndarray | None = None

    _normalize = staticmethod(au_group_normalize)

    def compute_au_features(self, feature_dir_name: str = "au_feature") -> np.ndarray:
        au_dir = os.path.join(os.path.dirname(self.data_path), feature_dir_name)
        if not os.path.exists(au_dir):
            raise FileNotFoundError(f"feature directory missing: {au_dir}")
        parts = []
        for subject in self.subject_lists:
            path = os.path.join(au_dir, f"{subject}.npy")
            if not os.path.exists(path):
                raise FileNotFoundError(f"missing file: {path}")
            parts.append(np.load(path))
        self.au_features = np.nan_to_num(np.concatenate(parts, axis=0))
        return self.au_features

    def get_features(self) -> np.ndarray:
        if self.au_features is None:
            self.au_features = self.compute_au_features()
        return self.au_features


class DataFeatures:
    """:func:`assemble_features` of the pickle at ``data_path``, as
    ``.features[modality]`` and ``.label`` (reference
    ``data/LoadFeatures.py:24-128``)."""

    def __init__(
        self,
        data_path: str,
        modalities: list[str] = ("eeg", "eye", "pps"),
        subject_lists: list[int] | None = None,
        Norm: str | None = None,
        label_type: str = "",
    ):
        self.data_path = data_path
        self.subject_lists = subject_lists
        self.ex_nums = 20
        self.features, self.label = assemble_features(
            RawData(data_path).data, modalities=list(modalities),
            subject_lists=subject_lists, norm=Norm, label_type=label_type)

"""Dict-style dataset facade and the config-driven ``load_data``.

Copies of ``multimodal_sentiment_aanalysis_tpu/data/dataset.py`` (reference
``data/Dataset.py:19-181``):

- :class:`FeatureDataset` serves ``({modality: feat}, label)`` over assembled
  features, with the binary-label filter (keep {0, 2}, map 2 -> 1), block
  LOSO by ``test_person``, or the shuffled K-fold dependent split where
  ``test_person`` is the fold;
- :func:`load_data` returns the split as two
  :class:`~.pipeline.DeviceDataset`s on ``device`` carrying eeg, eye, pps and
  both label heads, for the trainers and the ``Tester``.
"""

from __future__ import annotations

import numpy as np
import torch

from .features import assemble_features
from .pipeline import DeviceDataset
from .raw import RawData
from .splits import binary_label_filter, kfold_split, loso_block_split


class FeatureDataset:
    """Index-resolved view over assembled features (reference Dataset.py:19-138)."""

    def __init__(
        self,
        features: dict[str, np.ndarray],
        labels: np.ndarray,
        ex_nums: int = 20,
        mode: str = "train",
        test_person: int = -1,
        cls_num: int = 3,
        dependent: bool = False,
        n_splits: int = 10,
    ):
        labels = np.asarray(labels).reshape(-1)
        n = len(labels)
        indices = np.arange(n)
        if cls_num == 2:
            indices, labels = binary_label_filter(labels)
        if dependent:
            train_idx, test_idx = kfold_split(n, n_splits, test_person, indices=indices)
        else:
            train_idx, test_idx = loso_block_split(n, ex_nums, test_person, indices=indices)
        sel = train_idx if mode == "train" else test_idx
        self.indices = sel
        self.features = {m: f[sel] for m, f in features.items()}
        self.labels = labels[sel]

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int):
        return {m: f[idx] for m, f in self.features.items()}, self.labels[idx]


def load_data(config, test_person: int = -1, data: dict | None = None,
              device: torch.device | str = "cuda") -> tuple[DeviceDataset, DeviceDataset]:
    """``(train, test)`` datasets on ``device`` from a config with the
    reference key layout (``config["data"]["HCI"]``, satisfied by
    :class:`..config.Config`). ``data`` skips the pickle load (for example
    the synthetic dataset)."""
    hci = config["data"]["HCI"]
    training = config["training"]
    if data is None:
        data = RawData(hci["data_path"]).data

    modalities = list(training["using_modalities"])
    features, _ = assemble_features(data, modalities, norm="Z_score",
                                    label_type=hci["label_type"])
    arousal = np.asarray(data["arousal_label"]).reshape(-1)
    valence = np.asarray(data["valence_label"]).reshape(-1)
    n = len(arousal)

    primary = arousal if hci["label_type"] == "arousal" else valence
    indices = np.arange(n)
    if config["num_classes"] == 2:
        indices, primary = binary_label_filter(primary)
        arousal = np.where(arousal == 2, 1, arousal)
        valence = np.where(valence == 2, 1, valence)

    if training["dependent"]:
        train_idx, test_idx = kfold_split(n, training["n_folds"], test_person, indices=indices)
    else:
        train_idx, test_idx = loso_block_split(n, hci["ex_nums"], test_person, indices=indices)

    arrays = {m: features[m].astype(np.float32) for m in modalities}
    arrays["arousal"] = arousal.astype(np.int64)
    arrays["valence"] = valence.astype(np.int64)
    full = DeviceDataset(arrays, device)
    return full.subset(train_idx), full.subset(test_idx)

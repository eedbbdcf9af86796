from .augment import align_modalities, gaussian_views, sliding_window, two_views
from .dataset import FeatureDataset, load_data
from .features import (
    AuFeatures,
    DataFeatures,
    assemble_features,
    au_group_normalize,
    per_subject_zscore,
    zscore_normalize,
)
from .memhacl import load_emotion_npy, make_synthetic_emotion_arrays, random_split_indices
from .pairs import build_contrastive_pairs
from .pipeline import DeviceDataset, epoch_batch_indices, epoch_plan_on_device, host_to_device
from .raw import RawData, make_synthetic_hci_data, save_pickle
from .splits import (
    binary_label_filter,
    kfold_split,
    loso_block_split,
    loso_split,
    per_subject_count_split,
    subject_holdout_split,
    subject_ids_array,
)

__all__ = [
    "AuFeatures",
    "DataFeatures",
    "DeviceDataset",
    "FeatureDataset",
    "RawData",
    "align_modalities",
    "assemble_features",
    "au_group_normalize",
    "binary_label_filter",
    "build_contrastive_pairs",
    "epoch_batch_indices",
    "epoch_plan_on_device",
    "gaussian_views",
    "host_to_device",
    "kfold_split",
    "load_data",
    "load_emotion_npy",
    "loso_block_split",
    "loso_split",
    "make_synthetic_emotion_arrays",
    "make_synthetic_hci_data",
    "per_subject_count_split",
    "per_subject_zscore",
    "random_split_indices",
    "save_pickle",
    "sliding_window",
    "subject_holdout_split",
    "subject_ids_array",
    "two_views",
    "zscore_normalize",
]

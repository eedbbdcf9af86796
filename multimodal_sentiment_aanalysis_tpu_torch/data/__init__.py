from .augment import align_modalities, gaussian_views, sliding_window, two_views
from .features import assemble_features, zscore_normalize
from .memhacl import load_emotion_npy, make_synthetic_emotion_arrays, random_split_indices
from .pairs import build_contrastive_pairs
from .pipeline import DeviceDataset, epoch_batch_indices, epoch_plan_on_device, host_to_device
from .raw import make_synthetic_hci_data
from .splits import loso_split, subject_ids_array

__all__ = [
    "DeviceDataset",
    "align_modalities",
    "assemble_features",
    "build_contrastive_pairs",
    "epoch_batch_indices",
    "epoch_plan_on_device",
    "gaussian_views",
    "host_to_device",
    "load_emotion_npy",
    "loso_split",
    "make_synthetic_emotion_arrays",
    "make_synthetic_hci_data",
    "random_split_indices",
    "sliding_window",
    "subject_ids_array",
    "two_views",
    "zscore_normalize",
]

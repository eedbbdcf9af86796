from .augment import align_modalities, gaussian_views, sliding_window, two_views
from .features import assemble_features, zscore_normalize
from .memhacl import load_emotion_npy, make_synthetic_emotion_arrays, random_split_indices
from .pipeline import DeviceDataset, epoch_batch_indices, epoch_plan_on_device
from .raw import make_synthetic_hci_data
from .splits import loso_split

__all__ = [
    "DeviceDataset",
    "align_modalities",
    "assemble_features",
    "epoch_batch_indices",
    "epoch_plan_on_device",
    "gaussian_views",
    "load_emotion_npy",
    "loso_split",
    "make_synthetic_emotion_arrays",
    "make_synthetic_hci_data",
    "random_split_indices",
    "sliding_window",
    "two_views",
    "zscore_normalize",
]

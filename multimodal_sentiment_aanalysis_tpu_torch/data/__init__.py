from .features import assemble_features, zscore_normalize
from .pipeline import DeviceDataset, epoch_batch_indices, epoch_plan_on_device
from .raw import make_synthetic_hci_data
from .splits import loso_split

__all__ = [
    "DeviceDataset",
    "assemble_features",
    "epoch_batch_indices",
    "epoch_plan_on_device",
    "loso_split",
    "make_synthetic_hci_data",
    "zscore_normalize",
]

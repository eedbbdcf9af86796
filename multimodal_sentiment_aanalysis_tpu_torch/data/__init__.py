from .pipeline import DeviceDataset, epoch_batch_indices

__all__ = ["DeviceDataset", "epoch_batch_indices"]

"""Data augmentation.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/data/augment.py``:

- :func:`gaussian_views`, :func:`two_views`: Gaussian-noise views of whole
  batches on their device (reference ``ME-MHACL/data_loader.py:40-77``),
  drawn from an explicit ``torch.Generator`` (JAX draws from a key, so the
  two packages' noise differs; the tests compare at noise 0 or by
  distribution);
- :func:`sliding_window`, :func:`align_modalities`: numpy copies of the
  host-side precompute (reference ``common/data_process.py:96-157``),
  bit-equal to the JAX functions.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_views(
    generator: torch.Generator,
    eeg: torch.Tensor,
    eye: torch.Tensor,
    pps: torch.Tensor,
    noise_eeg: float = 0.01,
    noise_eye: float = 0.05,
    noise_pps: float = 0.05,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One view per modality: ``x + scale * N(0, 1)``, the noise drawn from
    ``generator`` (on the tensors' device) in the order eeg, eye, pps."""

    def noisy(x: torch.Tensor, scale: float) -> torch.Tensor:
        return x + scale * torch.randn(x.shape, generator=generator, device=x.device,
                                       dtype=x.dtype)

    return noisy(eeg, noise_eeg), noisy(eye, noise_eye), noisy(pps, noise_pps)


def two_views(generator: torch.Generator, eeg, eye, pps, **noise):
    """Two independent views (ME-MHACL ``ContrastiveDataset``), one after
    the other from ``generator``."""
    return (gaussian_views(generator, eeg, eye, pps, **noise),
            gaussian_views(generator, eeg, eye, pps, **noise))


def sliding_window(
    trial: np.ndarray, label, win_len: int, overlap: float
) -> tuple[np.ndarray, np.ndarray]:
    """Windows of one ``(samples, channels)`` trial, and a label per window,
    with the reference's loop bound."""
    if overlap == 0:
        win_num = trial.shape[0] // win_len
        chans = trial.shape[1]
        used = win_num * win_len
        new_trial = trial[:used, :].reshape(win_num, win_len, chans)
    else:
        step = int(win_len * (1 - overlap))
        starts = []
        start = 0
        end = 0
        while end < len(trial) - win_len:
            end = start + win_len
            starts.append(start)
            start += step
        new_trial = np.asarray([trial[s : s + win_len] for s in starts])
    new_label = np.asarray([label] * len(new_trial))
    return new_trial, new_label


def align_modalities(
    eeg_data: np.ndarray, eye_track_data: np.ndarray, f1: int = 256, f2: int = 60
) -> tuple[np.ndarray, np.ndarray]:
    """Trim two streams sampled at ``f1`` and ``f2`` Hz to their common
    duration."""
    time1 = len(eeg_data) / f1
    time2 = len(eye_track_data) / f2
    min_time = min(time1, time2)
    return eeg_data[: int(min_time * f1)], eye_track_data[: int(min_time * f2)]

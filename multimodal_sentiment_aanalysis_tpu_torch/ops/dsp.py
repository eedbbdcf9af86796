"""Signal-processing ops: IIR filtering, normalization, windowing, alignment.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/ops/dsp.py`` (the
reference's ``common/data_process.py``), function for function:

- Butterworth band-pass in two calling conventions (``filter_data``
  sample-major; ``butterworth_filter`` channel-major with the cutoff
  clamping) and the IIR notch (``filter_data_notch``);
- per-trial min-max and z-score normalization;
- sliding-window augmentation (``re_data_slide``), stream alignment
  (``data_align``) and the dependent / independent trial split.

Filter coefficients are designed on the host with scipy (imported inside
the functions, as in JAX). The filtering is :func:`..kernels.iir.sos_filtfilt`:
on a CUDA tensor the hand-written kernel, one launch for every series of a
call (under :func:`.features.batched`, for every trial of the stack), and on
a CPU tensor its plain version.

Device rule: a tensor argument keeps its device; an array or list goes to
``device`` (default ``"cuda"``, which raises on a machine without a card).
Dtype rule: fp32, as the JAX package computes with x64 off; a float64
tensor is filtered in fp64, as JAX does under ``jax.enable_x64``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.iir import sos_filtfilt


def as_signal(x, device="cuda") -> torch.Tensor:
    """``x`` as a float tensor: a tensor keeps its device and, if float64,
    its dtype (else fp32); an array or list becomes fp32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float64 else x.to(torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# host-side filter design (coefficients only)
# ---------------------------------------------------------------------------

def butter_bandpass(order: int, low: float, high: float, fs: float):
    """Butterworth band-pass (b, a) with cutoffs in Hz."""
    from scipy import signal

    b, a = signal.butter(order, [2 * low / fs, 2 * high / fs], "bandpass")
    return np.asarray(b), np.asarray(a)


def iirnotch(notch_freq: float, q: float, fs: float):
    """IIR notch (b, a) at ``notch_freq`` Hz with quality factor ``q``."""
    from scipy import signal

    b, a = signal.iirnotch(w0=notch_freq / (fs / 2), Q=q)
    return np.asarray(b), np.asarray(a)


# ---------------------------------------------------------------------------
# filtering: second-order sections, zero phase
# ---------------------------------------------------------------------------

def filtfilt(b, a, x, axis: int = -1, device="cuda") -> torch.Tensor:
    """Zero-phase IIR filter along ``axis``, over every other axis at once.

    Matches ``scipy.signal.filtfilt(b, a, x)`` to fp32 tolerance (fp64 for a
    float64 tensor). The (b, a) transfer function is factored into
    second-order sections on the host (``tf2sos``), with their steady-state
    initial conditions (``sosfilt_zi``) and ``padlen = 3 * max(len(a),
    len(b))``, as in JAX; the series are filtered in one call of
    :func:`..kernels.iir.sos_filtfilt`."""
    from scipy import signal

    sos = signal.tf2sos(np.asarray(b, np.float64), np.asarray(a, np.float64))
    zi = signal.sosfilt_zi(sos)  # (S, 2), steady state for a unit input
    padlen = 3 * max(len(np.atleast_1d(a)), len(np.atleast_1d(b)))
    x = as_signal(x, device).movedim(axis, -1)
    sos_t = torch.as_tensor(sos, dtype=x.dtype, device=x.device)
    zi_t = torch.as_tensor(zi, dtype=x.dtype, device=x.device)
    y = sos_filtfilt(x.reshape(-1, x.shape[-1]).contiguous(), sos_t, zi_t, padlen)
    return y.reshape(x.shape).movedim(-1, axis)


def filter_data(low: float, high: float, data, fs: float = 250, device="cuda") -> torch.Tensor:
    """Band-pass, sample-major ``(time, channels)`` convention
    (reference ``filter_data``, ``common/data_process.py:8-25``)."""
    b, a = butter_bandpass(4, low, high, fs)
    return filtfilt(b, a, data, axis=0, device=device)


def butterworth_filter(data_raw, fs: float, lcf: float = 1, hcf: float = 70,
                       order: int = 4, device="cuda") -> torch.Tensor:
    """Band-pass, channel-major ``(channels, time)`` convention with the
    reference's cutoff clamping (``common/data_process.py:27-55``), and the
    JAX package's deviation: ``hcf`` clamps just below Nyquist, which scipy's
    design accepts, not to it."""
    if hcf >= fs / 2:
        hcf = 0.999 * fs / 2
    if lcf <= 0 or lcf > fs / 2 or lcf >= hcf:
        lcf = 2
    b, a = butter_bandpass(order, lcf, hcf, fs)
    return filtfilt(b, a, data_raw, axis=-1, device=device)


def filter_data_notch(notch_freq: float, q: float, data, fs: float = 250,
                      device="cuda") -> torch.Tensor:
    """Notch filter, sample-major convention
    (reference ``filter_data_notch``, ``common/data_process.py:57-75``)."""
    b, a = iirnotch(notch_freq, q, fs)
    return filtfilt(b, a, data, axis=0, device=device)


# ---------------------------------------------------------------------------
# normalization (reference :77-94)
# ---------------------------------------------------------------------------

def min_max_trial(trial, device="cuda") -> torch.Tensor:
    """Per-window, per-channel min-max to [0, 1]; input (windows, time, ch)."""
    trial = as_signal(trial, device)
    lo = trial.amin(dim=1, keepdim=True)
    hi = trial.amax(dim=1, keepdim=True)
    rng = torch.where(hi - lo == 0, 1.0, hi - lo)
    return (trial - lo) / rng


def z_score_trial(trial, device="cuda") -> torch.Tensor:
    """Per-window, per-channel z-score (sklearn ``preprocessing.scale``
    semantics: population std, std == 0 -> left centered)."""
    trial = as_signal(trial, device)
    mean = trial.mean(dim=1, keepdim=True)
    std = trial.std(dim=1, keepdim=True, correction=0)
    std = torch.where(std == 0, 1.0, std)
    return (trial - mean) / std


# ---------------------------------------------------------------------------
# sliding-window augmentation (reference :96-136)
# ---------------------------------------------------------------------------

def sliding_window_indices(n_samples: int, win_len: int, overlap: float):
    """Start indices of the reference's augmentation windows.

    The exact loop bounds of ``re_data_slide``
    (``common/data_process.py:114-126``), including the quirk that the loop
    condition tests the PREVIOUS window's end, so the final window may
    overrun (the reference clips it by Python slicing); overrunning windows
    are dropped here, as in the JAX package.
    """
    if overlap == 0:
        win_num = n_samples // win_len
        return np.arange(win_num) * win_len
    step = int(win_len * (1 - overlap))
    starts = []
    start = end = 0
    while end < n_samples - win_len:
        end = start + win_len
        starts.append(start)
        start += step
    return np.asarray([s for s in starts if s + win_len <= n_samples], np.int64)


def re_data_slide(trial, label, win_len: int, overlap: float,
                  is_filter: bool = False, norm_method: str | None = None, device="cuda"):
    """Sliding-window augmentation of one ``(time, ch)`` trial -> ``(windows,
    win_len, ch)`` and the label repeated per window. ``is_filter`` applies
    the 1-50 Hz band-pass then the 60 Hz notch (fs 250, the reference's
    defaults) to the whole trial first; the windows are one gather."""
    trial = as_signal(trial, device)
    if is_filter:
        trial = filter_data(1, 50, trial)
        trial = filter_data_notch(60, 5, trial)
    starts = sliding_window_indices(trial.shape[0], win_len, overlap)
    idx = starts[:, None] + np.arange(win_len)[None, :]
    windows = trial[torch.as_tensor(idx, dtype=torch.int64, device=trial.device)]
    if norm_method == "min_max":
        windows = min_max_trial(windows)
    elif norm_method == "z_score":
        windows = z_score_trial(windows)
    new_label = np.asarray([label] * windows.shape[0])
    return windows, new_label


def data_align(eeg_data, eye_track_data, f1: float = 256, f2: float = 60):
    """Clip two modality streams to the same wall-clock duration
    (reference ``data_align``, ``common/data_process.py:138-157``)."""
    t1 = len(eeg_data) / f1
    t2 = len(eye_track_data) / f2
    t = min(t1, t2)
    return eeg_data[: int(t * f1)], eye_track_data[: int(t * f2)]


def split_train_test_unimodal(data, label, mode: str, split_rate: float = 0.7,
                              random_seed: int = 11):
    """Dependent/independent trial-level split (reference
    ``common/data_process.py:159-202``) on the host, bit-matching its
    ``random.shuffle`` index order."""
    import random as _random

    data = np.asarray(data)
    label = np.asarray(label)
    if mode == "dependent":
        indices = list(range(len(data)))
        _random.seed(random_seed)
        _random.shuffle(indices)
        split_idx = int(math.floor((1 - split_rate) * len(indices)))
        train_idx, test_idx = indices[split_idx:], indices[:split_idx]
        return data[train_idx], label[train_idx], data[test_idx], label[test_idx]
    if mode == "independent":
        tr_d, tr_l, te_d, te_l = [], [], [], []
        for item in range(len(data)):
            indices = list(range(len(data[item])))
            _random.seed(random_seed)
            _random.shuffle(indices)
            split_idx = int(math.floor((1 - split_rate) * len(indices)))
            train_idx, test_idx = indices[split_idx:], indices[:split_idx]
            tr_d.append(data[item][train_idx])
            tr_l.append(label[item][train_idx])
            te_d.append(data[item][test_idx])
            te_l.append(label[item][test_idx])
        return (np.concatenate(tr_d), np.concatenate(tr_l),
                np.concatenate(te_d), np.concatenate(te_l))
    raise ValueError(f"unknown mode {mode!r}")

"""Feature extraction: time-domain and frequency-domain EEG features.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/ops/features.py`` (the
reference's ``common/feature_extract.py``), function for function: signal
energy, Hjorth activity / mobility / complexity, differential entropy per
band through Butterworth sub-bands, the Welch PSD and its band means, FFT
bin power, and the two combined vectors.

Every function takes one trial as ``(samples, channels)`` (the reference's
convention), under the device and dtype rules of :mod:`.dsp`; the spectra
are ``torch.fft`` (the JAX package's are ``jnp.fft``). :func:`batched` maps
any of them over a leading trial axis with ``torch.func.vmap``: a whole
``(trials, samples, channels)`` stack runs with no Python loop over trials
or channels, and each filter call of a feature is one kernel launch for the
whole stack.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from .dsp import as_signal, butterworth_filter

DEFAULT_BAND = (1, 4, 8, 13, 31, 75)
DE_BAND = (1, 4, 8, 13, 31, 70)


def batched(fn, *args, **kwargs):
    """``fn`` (with ``args`` and ``kwargs`` bound) over a leading trial axis,
    through ``torch.func.vmap``. An array argument of the returned callable
    goes to ``kwargs``' ``device`` (default ``"cuda"``), as the features'
    own arrays do. ``fn`` must return tensors (``welch_psd``'s numpy
    frequencies do not map)."""
    mapped = torch.func.vmap(partial(fn, *args, **kwargs) if args or kwargs else fn)
    device = kwargs.get("device", "cuda")

    def run(*trials):
        return mapped(*(as_signal(t, device) for t in trials))

    return run


# ---------------------------------------------------------------------------
# time domain
# ---------------------------------------------------------------------------

def signal_energy(trial, device="cuda") -> torch.Tensor:
    """Per-channel energy sum(x^2) (reference ``get_engery``, ``:31-45``)."""
    return torch.square(as_signal(trial, device)).sum(dim=0)


def hjorth_activity(trial, device="cuda") -> torch.Tensor:
    """Variance of the mean-centered signal (reference ``:47-62``)."""
    trial = as_signal(trial, device)
    centered = trial - trial.mean(dim=0, keepdim=True)
    return torch.square(centered).mean(dim=0)


def hjorth_mobility_complexity(trial, device="cuda"):
    """Mobility/complexity with the reference's exact formulation
    (``:64-118``): first difference with a 0 inserted at the front,
    TP = sum x^2 (not centered), M4 = mean of squared second differences.
    """
    trial = as_signal(trial, device)
    n = trial.shape[0]
    d = torch.cat([torch.zeros_like(trial[:1]), torch.diff(trial, dim=0)], dim=0)
    m2 = torch.square(d).sum(dim=0) / n
    tp = torch.square(trial).sum(dim=0)
    dd = d[1:] - d[:-1]
    m4 = torch.square(dd).sum(dim=0) / n
    mobility = torch.sqrt(m2 / tp)
    complexity = torch.sqrt(m4 * tp / (m2 * m2))
    return mobility, complexity


def hjorth(trial, device="cuda") -> torch.Tensor:
    """[activity | mobility | complexity] concat (reference ``:106-118``)."""
    trial = as_signal(trial, device)
    mob, comp = hjorth_mobility_complexity(trial)
    return torch.cat([hjorth_activity(trial), mob, comp])


def all_timedomain_features(trial, device="cuda") -> torch.Tensor:
    """[energy | activity | mobility | complexity] (reference ``:121-132``)."""
    trial = as_signal(trial, device)
    mob, comp = hjorth_mobility_complexity(trial)
    return torch.cat([signal_energy(trial), hjorth_activity(trial), mob, comp])


# ---------------------------------------------------------------------------
# frequency domain
# ---------------------------------------------------------------------------

def differential_entropy(trial, fs: float = 256, band=DE_BAND, device="cuda") -> torch.Tensor:
    """Per-band differential entropy log(2*pi*e*var)/2 after order-3
    Butterworth sub-banding (reference ``compute_DE``, ``:138-160``); var
    uses ddof=1. Returns (n_bands, channels) like the reference: one filter
    call a band."""
    x = as_signal(trial, device).transpose(0, 1)  # (channels, samples)
    n = x.shape[1]
    de = []
    for lo, hi in zip(band[:-1], band[1:]):
        sub = butterworth_filter(x, fs, lo, hi, order=3)
        var = torch.square(sub - sub.mean(dim=1, keepdim=True)).sum(dim=1) / (n - 1)
        de.append(torch.log(2 * math.pi * math.e * var) / 2)
    return torch.stack(de)  # (bands, channels)


def _hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', n)`` semantics)."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def welch_psd(trial, fs: float = 256, nperseg: int = 500, noverlap: int | None = None,
              device="cuda"):
    """Welch PSD of (samples, channels) -> (freqs, (channels, n_freqs)).

    ``scipy.signal.welch(x, fs, nperseg=..., noverlap=...)``'s defaults:
    periodic Hann window, constant detrend per segment, density scaling,
    one-sided spectrum; ``nperseg`` is cut to the trial's length. The
    frequencies are numpy, as in JAX.
    """
    x = as_signal(trial, device).transpose(0, 1)  # (channels, samples)
    n = x.shape[1]
    nperseg = min(nperseg, n)
    if noverlap is None:
        noverlap = nperseg // 2
    win = _hann_periodic(nperseg)
    scale = float(1.0 / (fs * (win**2).sum()))

    segs = x.unfold(-1, nperseg, nperseg - noverlap)  # (channels, segments, nperseg)
    segs = segs - segs.mean(dim=-1, keepdim=True)  # detrend='constant'
    segs = segs * torch.as_tensor(win, dtype=segs.dtype, device=segs.device)
    spec = torch.fft.rfft(segs, dim=-1)
    pxx = (spec.real**2 + spec.imag**2) * scale
    # one-sided doubling, except DC and (for even nperseg) Nyquist
    n_freqs = pxx.shape[-1]
    doubler = np.ones(n_freqs)
    doubler[1:n_freqs - 1 if nperseg % 2 == 0 else n_freqs] = 2.0
    pxx = pxx * torch.as_tensor(doubler, dtype=pxx.dtype, device=pxx.device)
    pxx = pxx.mean(dim=1)  # average over segments
    freqs = np.fft.rfftfreq(nperseg, 1.0 / fs)
    return freqs, pxx


def power_spectral_density(trial, fs: float = 256, band=DEFAULT_BAND,
                           sliding_window: int = 500, overlap: float = 0.25,
                           device="cuda") -> torch.Tensor:
    """Log band-power ratios from the Welch PSD (reference
    ``compute_power_spectral_density``, ``:162-184``): each band's mean
    over its bins (an empty band divides by 1). Returns (n_bands, channels).
    """
    freqs, pxx = welch_psd(trial, fs, sliding_window, int(sliding_window * overlap), device)
    out = []
    for lo, hi in zip(band[:-1], band[1:]):
        sel = (freqs >= lo) & (freqs < hi)
        w = torch.as_tensor(sel, dtype=pxx.dtype, device=pxx.device)
        out.append((pxx * w).sum(dim=1) / max(float(sel.sum()), 1.0))
    ret = torch.stack(out)  # (bands, channels)
    return torch.log(ret / ret.sum(dim=0, keepdim=True))


def bin_power(trial, fs: float = 256, band=DEFAULT_BAND, device="cuda") -> torch.Tensor:
    """Per-band FFT magnitude sums over bins ``floor(f / fs * n)`` (reference
    ``compute_bin_power``, ``:186-226``). Returns (n_bands, channels)."""
    x = as_signal(trial, device).transpose(0, 1)  # (channels, samples)
    n = x.shape[1]
    c = torch.fft.fft(x, dim=1).abs()
    powers = [c[:, int(np.floor(lo / fs * n)):int(np.floor(hi / fs * n))].sum(dim=1)
              for lo, hi in zip(band[:-1], band[1:])]
    return torch.stack(powers)  # (bands, channels)


def all_frequency_features(trial, fs: float = 256, band=DEFAULT_BAND,
                           device="cuda") -> torch.Tensor:
    """[PSD | DE | bin power] along the channel axis (reference
    ``compute_all_frequency_feature``, ``:228-241``): (bands, 3 channels)."""
    trial = as_signal(trial, device)
    return torch.cat([power_spectral_density(trial, fs, band),
                      differential_entropy(trial, fs, band), bin_power(trial, fs, band)], dim=1)

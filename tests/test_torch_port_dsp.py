"""The port's DSP, EEG features and electrode graph (``ops.dsp``,
``ops.features``, ``ops.graph``), ``ops.bilstm_stack``, and the IIR filter
kernel's plain version (``kernels.iir``), on the CPU.

- Every function the JAX ``ops`` exports from ``dsp``, ``features`` and
  ``graph``, and ``bilstm_stack``, against the JAX one on the same seeded
  numpy inputs. The filters in fp32 at 2e-4 absolute on unit-normal
  (585, 32) trials (the gap measures ~3.6e-5: fp32 recurrences in another
  rounding); in fp64 (a float64 tensor) against ``scipy.signal.filtfilt`` at
  1e-5 (scipy filters the (b, a) form, the port second-order sections:
  ~1e-6 at the 1-4 Hz order-3 band) and against JAX under
  ``jax.enable_x64`` at 1e-9 (the same sections, the same order).
- ``tests/test_ops_dsp.py``'s scipy and numpy goldens, repeated on the
  port at that file's bars.
- The filter kernel's walk (``csrc/iir.cu``: a warp's ring of time steps,
  chunks of 32, the forward output split between the ring and a scratch)
  emulated in torch (``torch_iir_emulation``) equal to
  ``sos_filtfilt_plain`` bit for bit at every ``KERNEL_SHAPES`` entry, in
  fp32 and fp64, with every copy landing as early or as late as its wait
  allows, and at smaller rings.
- ``batched`` over 3 trials equal to a loop of single trials; the splits'
  indices bit for bit; a graph cache written by either package loaded by
  the other; ``load_electrode_positions`` through a stand-in
  ``pandas.read_excel``; the port's ``ops.__all__`` a superset of JAX's;
  the plain filter differentiable, its gradient against ``jax.grad``.

The ``gpu``-marked tests hold the CUDA kernel against its plain version on
the card (fp32 and fp64, 1e-4 and 1e-10 of the largest output; one
recording of 12,000 samples too), count one launch per filter call over a
stack, and check the refusals. They skip without a card and import no JAX (JAX is
imported inside the CPU tests), so they run on a machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_port_dsp.py``.
"""

import math

import numpy as np
import pytest
import torch
from scipy import signal

from multimodal_sentiment_aanalysis_tpu_torch import ops
from multimodal_sentiment_aanalysis_tpu_torch.data import features as data_features
from multimodal_sentiment_aanalysis_tpu_torch.kernels import iir
from multimodal_sentiment_aanalysis_tpu_torch.ops import dsp
from torch_iir_emulation import Walk
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FP32_ATOL = 2e-4  # fp32 filters against JAX
# the clamped case's pole next to Nyquist (0.999 fs / 2) is ill-conditioned
# in fp32: the port's and JAX's fp32 outputs each sit ~1e-3 from the fp64
# result (0.93e-3 and 0.72e-3 measured, signal scale 4.1), 1.1e-3 apart
CLAMPED_FP32_ATOL = 3e-3
SCIPY_ATOL = 1e-5  # fp64 filters against scipy's (b, a) form
X64_ATOL = 1e-9    # fp64 filters against JAX under enable_x64
CPU = "cpu"


def _jops():
    from multimodal_sentiment_aanalysis_tpu import ops as jops

    return jops


def _trial(seed: int = 0, shape=(585, 32)) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# the filters
# --------------------------------------------------------------------------

# name -> (function name, leading arguments, keyword arguments, input
# layout, scipy's (b, a): the clamped case's cutoffs as the rule sets them,
# lcf 0 -> 2 Hz and hcf 200 -> 0.999 * 64 Hz)
FILTERS = {
    "filter_data 1-50 Hz fs 250": ("filter_data", (1, 50), dict(fs=250), "sample",
                                   signal.butter(4, [2 / 250, 100 / 250], "bandpass")),
    "butterworth 1-70 Hz fs 256": ("butterworth_filter", (256, 1, 70), dict(order=4), "channel",
                                   signal.butter(4, [2 / 256, 140 / 256], "bandpass")),
    "butterworth DE band 1-4 Hz order 3": ("butterworth_filter", (256, 1, 4), dict(order=3),
                                           "channel", signal.butter(3, [2 / 256, 8 / 256],
                                                                    "bandpass")),
    "butterworth clamped fs 128": ("butterworth_filter", (128,), dict(lcf=0, hcf=200, order=3),
                                   "channel", signal.butter(3, [4 / 128, 0.999], "bandpass")),
    "notch 60 Hz Q 5": ("filter_data_notch", (60, 5), dict(fs=250), "sample",
                        signal.iirnotch(60 / 125, 5)),
}


def _filter_call(mod, name: str, x):
    fn, lead, kw, layout, _ = FILTERS[name]
    if layout == "channel":
        return getattr(mod, fn)(x, *lead, **kw)
    return getattr(mod, fn)(*lead, x, **kw)


def _filter_input(name: str) -> np.ndarray:
    x = _trial(3)
    return x.T.copy() if FILTERS[name][3] == "channel" else x


def _scipy_filter(name: str, x: np.ndarray) -> np.ndarray:
    *_, layout, (b, a) = FILTERS[name]
    return signal.filtfilt(b, a, x, axis=0 if layout == "sample" else -1)


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_fp32_matches_jax(name):
    x = _filter_input(name)
    got = _filter_call(ops, name, torch.from_numpy(x).float())
    want = np.asarray(_filter_call(_jops(), name, x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    atol = CLAMPED_FP32_ATOL if "clamped" in name else FP32_ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_fp64_matches_scipy_and_jax_x64(name):
    import jax

    x = _filter_input(name)
    got = _filter_call(ops, name, torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _scipy_filter(name, x), rtol=0, atol=SCIPY_ATOL)
    with jax.enable_x64(True):
        want = np.asarray(_filter_call(_jops(), name, x))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=X64_ATOL)


def test_filtfilt_any_axis_matches_jax():
    """A (4, 585, 3) stack filtered along axis 1, every other axis at once."""
    x = _trial(4, (4, 585, 3))
    b, a = dsp.butter_bandpass(4, 1, 40, 256)
    got = ops.filtfilt(b, a, x, axis=1, device=CPU)
    want = np.asarray(_jops().filtfilt(b, a, x, axis=1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)
    flat = ops.filtfilt(b, a, np.moveaxis(x, 1, -1).reshape(12, 585), device=CPU)
    torch.testing.assert_close(got, flat.reshape(4, 3, 585).transpose(1, 2), rtol=0, atol=0)


def test_plain_filter_gradient_matches_jax():
    """The CPU filter is differentiable, as the JAX scan is: d/dx of
    sum(w * filtfilt(x)) against ``jax.grad`` under x64."""
    import jax
    import jax.numpy as jnp

    x, w = _trial(5, (2, 40)), _trial(6, (2, 40))
    b, a = dsp.iirnotch(50, 5, 250)
    xt = torch.from_numpy(x).requires_grad_()
    (ops.filtfilt(b, a, xt) * torch.from_numpy(w)).sum().backward()
    with jax.enable_x64(True):
        want = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * _jops().filtfilt(b, a, v)))(
            jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=0, atol=1e-10)


def test_sos_filtfilt_plain_is_the_jax_recurrence():
    """``kernels.iir.sos_filtfilt_plain`` on scipy's sections against the
    JAX ``_filtfilt_1d`` it ports, x64, at padlen 1 and at a padlen one short
    of the series."""
    import jax
    import jax.numpy as jnp
    from multimodal_sentiment_aanalysis_tpu.ops.dsp import _filtfilt_1d

    sos = signal.butter(3, [0.05, 0.4], "bandpass", output="sos")
    zi = signal.sosfilt_zi(sos)
    x = _trial(7, (3, 20))
    for padlen in (1, 19):
        got = iir.sos_filtfilt(torch.from_numpy(x), torch.from_numpy(sos), torch.from_numpy(zi),
                               padlen)
        with jax.enable_x64(True):
            want = jax.vmap(lambda v: _filtfilt_1d(jnp.asarray(sos), jnp.asarray(zi), padlen,
                                                   v))(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_filter_refusals():
    sos = torch.tensor([[0.2, 0.4, 0.2, 1.0, -0.3, 0.1]])
    zi = torch.ones(1, 2)
    with pytest.raises(ValueError, match="more than padlen"):
        iir.sos_filtfilt(torch.zeros(2, 6), sos, zi, 6)
    with pytest.raises(ValueError, match=r"sos must be \(S, 6\)"):
        iir.sos_filtfilt(torch.zeros(2, 6), sos[:, :5], zi, 1)
    with pytest.raises(ValueError, match="no filter kernel for device meta"):
        iir.sos_filtfilt(torch.zeros(2, 6, device="meta"), sos.to("meta"), zi.to("meta"), 1)
    with pytest.raises(ValueError, match="more than padlen"):  # scipy's rule, 3 * 9 samples
        ops.filter_data(1, 50, np.zeros((27, 2)), device=CPU)


def test_array_default_device_is_the_card():
    """An array goes to ``device``, whose default is "cuda": without a card
    that raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        ops.filter_data_notch(60, 5, _trial(1, (100, 2)))
    with pytest.raises((AssertionError, RuntimeError)):
        ops.signal_energy(_trial(1, (100, 2)))


def test_cpu_filters_launch_nothing():
    from multimodal_sentiment_aanalysis_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    ops.butterworth_filter(torch.from_numpy(_trial(2, (3, 200))), 256, 1, 70)
    ops.batched(ops.differential_entropy, device=CPU)(_trial(2, (2, 200, 3)))
    counts = launch_counts()
    assert counts["sos_filtfilt"] == 0 and counts["sos_filtfilt_f64"] == 0


# --------------------------------------------------------------------------
# every other function against its JAX counterpart
# --------------------------------------------------------------------------


def _layers(seed: int, n: int, i: int, h: int):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        width = i if k == 0 else 2 * h
        out.append({f"{w}_{d}": (0.3 * rng.normal(size=s)).astype(np.float32)
                    for d in ("fwd", "bwd")
                    for w, s in (("w_ih", (4 * h, width)), ("w_hh", (4 * h, h)), ("b_ih", (4 * h,)),
                                 ("b_hh", (4 * h,)))})
    return out


def _bilstm_stack(mod, x, layers):
    if mod is ops:
        return ops.bilstm_stack(torch.from_numpy(x),
                                [{k: torch.from_numpy(v) for k, v in p.items()} for p in layers])
    import jax.numpy as jnp

    return mod.bilstm_stack(jnp.asarray(x), [{k: jnp.asarray(v) for k, v in p.items()}
                                             for p in layers])


W = _trial(8, (5, 100, 8))
TRIAL = _trial(9)
SMALL = _trial(10, (200, 6))
# name -> (call on the ops module and a keyword dict (the port's device), atol)
MATCHES = {
    "min_max_trial": (lambda m, kw: m.min_max_trial(W, **kw), 1e-6),
    "z_score_trial": (lambda m, kw: m.z_score_trial(W, **kw), 1e-5),
    "z_score_trial constant channel": (
        lambda m, kw: m.z_score_trial(np.ones((2, 10, 3)), **kw), 0.0),
    "min_max_trial constant channel": (
        lambda m, kw: m.min_max_trial(np.ones((2, 10, 3)), **kw), 0.0),
    "re_data_slide no overlap": (lambda m, kw: m.re_data_slide(TRIAL, 2, 128, 0.0, **kw), 0.0),
    "re_data_slide overlap min_max": (
        lambda m, kw: m.re_data_slide(TRIAL, 1, 128, 0.5, norm_method="min_max", **kw), 1e-6),
    "re_data_slide filtered z_score": (
        lambda m, kw: m.re_data_slide(TRIAL, 1, 128, 0.5, is_filter=True, norm_method="z_score",
                                      **kw), 5e-4),
    "re_data_slide overlap 0.75": (lambda m, kw: m.re_data_slide(SMALL, 0, 64, 0.75, **kw), 0.0),
    "signal_energy": (lambda m, kw: m.signal_energy(TRIAL, **kw), 2e-4),
    "hjorth_activity": (lambda m, kw: m.hjorth_activity(TRIAL, **kw), 1e-5),
    "hjorth_mobility_complexity": (lambda m, kw: m.hjorth_mobility_complexity(TRIAL, **kw), 1e-5),
    "hjorth": (lambda m, kw: m.hjorth(TRIAL, **kw), 1e-5),
    "all_timedomain_features": (lambda m, kw: m.all_timedomain_features(TRIAL, **kw), 2e-4),
    "differential_entropy": (lambda m, kw: m.differential_entropy(TRIAL, 256, **kw), 2e-4),
    "welch_psd": (lambda m, kw: m.welch_psd(TRIAL, 256, 500, 125, **kw), 1e-6),
    "welch_psd odd nperseg": (lambda m, kw: m.welch_psd(SMALL, 128, 51, **kw), 1e-6),
    "power_spectral_density": (lambda m, kw: m.power_spectral_density(TRIAL, 256, **kw), 1e-5),
    "bin_power": (lambda m, kw: m.bin_power(TRIAL, 256, **kw), 1e-3),
    "all_frequency_features": (lambda m, kw: m.all_frequency_features(TRIAL, **kw), 1e-3),
    "normalize_adjacency": (lambda m, kw: m.normalize_adjacency(
        np.abs(m.distance_weights(m.synthetic_electrode_positions(32, seed=1))), **kw), 1e-6),
    "create_graph_structure 62": (lambda m, kw: m.create_graph_structure(62, **kw), 1e-6),
    "initialize_graph": (lambda m, kw: m.initialize_graph(4, 32, **kw), 1e-6),
    "graph_indicator": (lambda m, kw: m.graph_indicator(3, 5), 0.0),
    "distance_weights": (lambda m, kw: m.distance_weights(m.synthetic_electrode_positions(32, 2)),
                         0.0),
    "distance_weights default pairs": (
        lambda m, kw: m.distance_weights(m.synthetic_electrode_positions(31, 3)), 0.0),
    "synthetic_electrode_positions": (lambda m, kw: m.synthetic_electrode_positions(62, 4), 0.0),
    "data_align": (lambda m, kw: m.data_align(_trial(11, (2560, 4)), _trial(12, (700, 2))), 0.0),
    "butter_bandpass": (lambda m, kw: m.butter_bandpass(4, 1, 50, 250), 0.0),
    "iirnotch": (lambda m, kw: m.iirnotch(60, 5, 250), 0.0),
    "bilstm_stack": (lambda m, kw: _bilstm_stack(m, _trial(13, (2, 5, 6)).astype(np.float32),
                                                 _layers(14, 2, 6, 4)), 2e-5),
}


def _flatten(out) -> list:
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flatten(o)]
    return [out]


@pytest.mark.parametrize("name", sorted(MATCHES))
def test_matches_jax(name):
    call, atol = MATCHES[name]
    got, want = _flatten(call(ops, dict(device=CPU))), _flatten(call(_jops(), {}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, (g.dtype, w.dtype)
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
            np.testing.assert_allclose(g, w, rtol=0, atol=atol * scale)


@pytest.mark.parametrize("n_windows", [(585, 128, 0.0), (585, 128, 0.5), (585, 100, 0.3),
                                       (256, 64, 0.75), (100, 128, 0.5), (128, 128, 0.5)])
def test_sliding_window_indices_equal(n_windows):
    got = dsp.sliding_window_indices(*n_windows)
    want = _jops().dsp.sliding_window_indices(*n_windows)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode, seed", [("dependent", 11), ("dependent", 3),
                                        ("independent", 11), ("independent", 5)])
def test_split_train_test_unimodal_bit_equal(mode, seed):
    rng = np.random.default_rng(seed)
    shape = (37, 6, 4) if mode == "dependent" else (4, 9, 6, 4)
    data = rng.normal(size=shape)
    label = rng.integers(0, 3, shape[:-2] if mode == "independent" else shape[:1])
    got = ops.split_train_test_unimodal(data, label, mode, 0.7, seed)
    want = _jops().split_train_test_unimodal(data, label, mode, 0.7, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ValueError, match="unknown mode"):
        ops.split_train_test_unimodal(data, label, "loso")


# --------------------------------------------------------------------------
# batched
# --------------------------------------------------------------------------

STACK = _trial(15, (3, 585, 8))
# name -> (function, bound arguments, bound keywords)
BATCHED = {
    "all_timedomain_features": ("all_timedomain_features", (), {}),
    "all_frequency_features": ("all_frequency_features", (), {}),
    "hjorth": ("hjorth", (), {}),
    "differential_entropy fs 128": ("differential_entropy", (), dict(fs=128)),
    "filter_data_notch": ("filter_data_notch", (60, 5), dict(fs=256)),
    "power_spectral_density": ("power_spectral_density", (), {}),
    "bin_power": ("bin_power", (), {}),
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_equals_a_loop_and_jax(name):
    fn, args, kw = BATCHED[name]
    got = ops.batched(getattr(ops, fn), *args, device=CPU, **kw)(STACK)
    loop = torch.stack([getattr(ops, fn)(*args, torch.from_numpy(s).float(), device=CPU, **kw)
                        for s in STACK])
    torch.testing.assert_close(got, loop, rtol=0, atol=0)
    want = np.asarray(_jops().batched(getattr(_jops(), fn), *args, **kw)(STACK))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * scale)


def test_batched_keeps_a_tensor_s_device_and_dtype():
    x = torch.from_numpy(STACK[:, :200])
    out = ops.batched(ops.hjorth)(x)  # the default device is not used for a tensor
    assert out.dtype == torch.float64 and out.device.type == "cpu"


# --------------------------------------------------------------------------
# tests/test_ops_dsp.py's scipy and numpy goldens, on the port
# --------------------------------------------------------------------------


def _golden_filter_data(trial):
    ours = ops.filter_data(1, 50, trial, fs=250, device=CPU).numpy()
    b, a = signal.butter(4, [2 * 1 / 250, 2 * 50 / 250], "bandpass")
    ref = np.stack([signal.filtfilt(b, a, trial[:, c]) for c in range(32)], axis=1)
    np.testing.assert_allclose(ours, ref, atol=5e-4)


def _golden_butterworth(trial):
    x = trial.T
    ours = ops.butterworth_filter(x, 256, 1, 70, order=3, device=CPU).numpy()
    b, a = signal.butter(3, [1 / 128, 70 / 128], "bandpass")
    ref = np.stack([signal.filtfilt(b, a, x[c]) for c in range(32)])
    np.testing.assert_allclose(ours, ref, atol=5e-4)


def _golden_clamping(trial):
    ours = ops.butterworth_filter(trial.T, 128, lcf=0, hcf=200, order=3, device=CPU)
    assert torch.isfinite(ours).all()


def _golden_notch(trial):
    ours = ops.filter_data_notch(60, 5, trial, fs=250, device=CPU).numpy()
    b, a = signal.iirnotch(60 / 125, 5)
    ref = np.stack([signal.filtfilt(b, a, trial[:, c]) for c in range(32)], axis=1)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def _golden_min_max(trial):
    w = np.random.default_rng(0).normal(size=(5, 100, 8))
    out = ops.min_max_trial(w, device=CPU).numpy()
    assert out.min() >= 0 and out.max() <= 1 + 1e-6
    np.testing.assert_allclose(out.min(axis=1), 0, atol=1e-6)


def _golden_z_score(trial):
    w = np.random.default_rng(0).normal(size=(5, 100, 8))
    out = ops.z_score_trial(w, device=CPU).numpy()
    np.testing.assert_allclose(out.mean(axis=1), 0, atol=1e-5)
    np.testing.assert_allclose(out.std(axis=1), 1, atol=1e-4)


def _golden_windows_no_overlap(trial):
    w, labels = ops.re_data_slide(trial, 2, 128, 0.0, device=CPU)
    assert w.shape == (585 // 128, 128, 32)
    np.testing.assert_array_equal(labels, [2] * w.shape[0])
    np.testing.assert_allclose(w.numpy()[0], trial[:128], atol=1e-6)


def _golden_windows_overlap(trial):
    w, _ = ops.re_data_slide(trial, 1, 128, 0.5, device=CPU)
    start = end = 0
    step = int(128 * 0.5)
    ref = []
    while end < len(trial) - 128:  # the reference loop (data_process.py:117-126)
        end = start + 128
        ref.append(trial[start:end])
        start += step
    ref = [r for r in ref if r.shape[0] == 128]
    assert w.shape[0] == len(ref)
    np.testing.assert_allclose(w.numpy(), np.stack(ref), atol=1e-6)


def _golden_data_align(trial):
    rng = np.random.default_rng(0)
    a, b = ops.data_align(rng.normal(size=(2560, 32)), rng.normal(size=(660, 4)), f1=256, f2=60)
    assert len(a) / 256 == len(b) / 60


def _golden_split(trial):
    rng = np.random.default_rng(0)
    data, label = rng.normal(size=(40, 10, 4)), rng.integers(0, 3, 40)
    tr_d, tr_l, te_d, te_l = ops.split_train_test_unimodal(data, label, "dependent", 0.7, 11)
    assert len(tr_d) + len(te_d) == 40
    tr2, *_ = ops.split_train_test_unimodal(data, label, "dependent", 0.7, 11)
    np.testing.assert_array_equal(tr_d, tr2)


def _golden_energy(trial):
    np.testing.assert_allclose(ops.signal_energy(trial, device=CPU).numpy(), (trial**2).sum(0),
                               rtol=1e-5)


def _golden_hjorth(trial):
    h = ops.hjorth(trial, device=CPU).numpy()
    assert h.shape == (96,)
    c0 = trial[:, 0]
    d = np.insert(np.diff(c0), 0, 0)
    n = len(c0)
    m2 = (d**2).sum() / n
    tp = (c0**2).sum()
    m4 = ((d[1:] - d[:-1]) ** 2).sum() / n
    act = ((c0 - c0.mean()) ** 2).mean()
    assert abs(h[0] - act) < 1e-5
    assert abs(h[32] - math.sqrt(m2 / tp)) < 1e-6
    assert abs(h[64] - math.sqrt(m4 * tp / m2 / m2)) < 1e-4


def _golden_timedomain(trial):
    f = ops.all_timedomain_features(trial, device=CPU).numpy()
    assert f.shape == (128,)
    np.testing.assert_allclose(f[:32], (trial**2).sum(0), rtol=1e-5)


def _golden_welch(trial):
    freqs, pxx = ops.welch_psd(trial, fs=256, nperseg=500, noverlap=125, device=CPU)
    rf, rp = signal.welch(trial.T, fs=256, nperseg=500, noverlap=125)
    np.testing.assert_allclose(freqs, rf)
    np.testing.assert_allclose(pxx.numpy(), rp, atol=1e-5 * abs(rp).max())


def _golden_psd(trial):
    ours = ops.power_spectral_density(trial, 256, device=CPU).numpy()
    rf, rp = signal.welch(trial.T, fs=256, nperseg=500, noverlap=125)
    band = [1, 4, 8, 13, 31, 75]
    ret = [rp[:, (rf >= band[i]) & (rf < band[i + 1])].mean(1) for i in range(5)]
    ref = np.log(np.array(ret) / np.sum(ret, axis=0))
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def _golden_de(trial):
    de = ops.differential_entropy(trial, 256, device=CPU).numpy()
    band = [1, 4, 8, 13, 31, 70]
    ref = np.zeros((5, 32))
    for i in range(5):
        b, a = signal.butter(3, [band[i] / 128, band[i + 1] / 128], "bandpass")
        sub = np.stack([signal.filtfilt(b, a, trial[:, c]) for c in range(32)])
        ref[i] = np.log(2 * math.pi * math.e * np.var(sub, axis=1, ddof=1)) / 2
    np.testing.assert_allclose(de, ref, atol=2e-3)


def _golden_bin_power(trial):
    band = [1, 4, 8, 13, 31, 75]
    bp = ops.bin_power(trial, 256, band, device=CPU).numpy()
    c = np.abs(np.fft.fft(trial[:, 0]))
    n = trial.shape[0]
    ref0 = [c[int(np.floor(band[i] / 256 * n)):int(np.floor(band[i + 1] / 256 * n))].sum()
            for i in range(5)]
    np.testing.assert_allclose(bp[:, 0], ref0, rtol=1e-5)


def _golden_frequency_shape(trial):
    f = ops.all_frequency_features(trial, device=CPU).numpy()
    assert f.shape == (5, 96) and np.isfinite(f).all()


def _golden_distance_weights(trial):
    pos = ops.synthetic_electrode_positions(32, seed=1)
    w = ops.distance_weights(pos)
    assert w.shape == (32, 32)
    np.testing.assert_allclose(np.diag(w), 1.0)
    p = pos / 10.0
    d2 = ((p[2] - p[3]) ** 2).sum()
    assert abs(w[2, 3] - min(1.0, 5.0 / d2)) < 1e-12
    d2s = ((p[0] - p[16]) ** 2).sum()
    assert abs(w[0, 16] - (min(1.0, 5.0 / d2s) - 1.0)) < 1e-12


def _golden_normalize(trial):
    adj = np.abs(ops.distance_weights(ops.synthetic_electrode_positions(32, seed=1)))
    norm = ops.normalize_adjacency(adj, device=CPU).numpy()
    deg = adj.sum(1)
    np.testing.assert_allclose(norm, adj / np.sqrt(np.outer(deg, deg)), rtol=1e-5)


GOLDENS = {f.__name__.removeprefix("_golden_"): f for f in (
    _golden_filter_data, _golden_butterworth, _golden_clamping, _golden_notch, _golden_min_max,
    _golden_z_score, _golden_windows_no_overlap, _golden_windows_overlap, _golden_data_align,
    _golden_split, _golden_energy, _golden_hjorth, _golden_timedomain, _golden_welch,
    _golden_psd, _golden_de, _golden_bin_power, _golden_frequency_shape,
    _golden_distance_weights, _golden_normalize)}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_scipy_golden(name):
    GOLDENS[name](np.random.default_rng(0).normal(size=(585, 32)))


# --------------------------------------------------------------------------
# the graph: cache, device, positions
# --------------------------------------------------------------------------


def test_initialize_graph_batched(tmp_path):
    adj, gi = ops.initialize_graph(4, 32, cache_dir=str(tmp_path), device=CPU)
    assert adj.shape == (4, 32, 32) and adj.dtype == torch.float32
    assert adj.stride(0) == 0  # broadcast, not copied
    assert gi.dtype == torch.int64
    np.testing.assert_array_equal(gi.numpy(), ops.graph_indicator(4, 32))
    a2 = ops.create_graph_structure(32, cache_dir=str(tmp_path), device=CPU)
    torch.testing.assert_close(adj[0], a2, rtol=0, atol=1e-7)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_cache_crosses_packages(tmp_path, writer):
    pos = ops.synthetic_electrode_positions(32, seed=7)
    if writer == "jax":
        written = np.asarray(_jops().create_graph_structure(32, pos, str(tmp_path)))
        read = ops.create_graph_structure(32, cache_dir=str(tmp_path), device=CPU).numpy()
    else:
        written = ops.create_graph_structure(32, pos, str(tmp_path), device=CPU).numpy()
        read = np.asarray(_jops().create_graph_structure(32, cache_dir=str(tmp_path)))
    assert [p.name for p in tmp_path.iterdir()] == ["adj_norm_32.npz"]
    with np.load(tmp_path / "adj_norm_32.npz") as cached:
        assert list(cached.keys()) == ["adj"] and cached["adj"].dtype == np.float32
    np.testing.assert_array_equal(read, written)
    fresh = ops.create_graph_structure(32, pos, device=CPU).numpy()  # no cache
    np.testing.assert_allclose(read, fresh, rtol=0, atol=1e-6)


def test_load_electrode_positions(monkeypatch, tmp_path):
    """The xlsx reader through a stand-in ``pandas.read_excel`` (no openpyxl
    here): columns 1:4 of each row, float64, as in JAX."""
    import pandas as pd

    pos = ops.synthetic_electrode_positions(32, seed=3)
    frame = pd.DataFrame({"name": [f"ch{i}" for i in range(32)], "x": pos[:, 0], "y": pos[:, 1],
                          "z": pos[:, 2]})
    seen = []
    monkeypatch.setattr(pd, "read_excel", lambda path: seen.append(path) or frame)
    path = str(tmp_path / "channels_pos_32.xlsx")
    got = ops.load_electrode_positions(path)
    want = _jops().graph.load_electrode_positions(path)
    assert seen == [path, path] and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pos)


# --------------------------------------------------------------------------
# the package surface
# --------------------------------------------------------------------------


def test_ops_exports_every_jax_name():
    jax_names = set(_jops().__all__)
    assert jax_names <= set(ops.__all__), sorted(jax_names - set(ops.__all__))
    assert all(hasattr(ops, name) for name in ops.__all__)


def test_assemble_features_points_at_the_ops():
    with pytest.raises(NotImplementedError, match="ops.dsp"):
        data_features.assemble_features({"raw_data": {}}, ["eeg"])


# --------------------------------------------------------------------------
# card: the kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


# name -> (series, length, order, band in Hz, fs); the main path's stack
# (480 x 32 series of 585) and ragged ones, one section to eight
KERNEL_SHAPES = {"stack": (15360, 585, 4, (1, 70), 256), "notch": (77, 300, None, (60, 5), 250),
                 "order 8": (65, 200, 8, (4, 30), 256), "order 3": (3, 41, 3, (1, 4), 256)}


def _sections(order, band, fs, dtype, device):
    if order is None:
        b, a = signal.iirnotch(band[0] / (fs / 2), band[1])
    else:
        b, a = signal.butter(order, [2 * band[0] / fs, 2 * band[1] / fs], "bandpass")
    sos = signal.tf2sos(b, a)
    padlen = 3 * max(len(a), len(b))
    return (torch.as_tensor(sos, dtype=dtype, device=device),
            torch.as_tensor(signal.sosfilt_zi(sos), dtype=dtype, device=device), padlen)


@pytest.mark.parametrize("late", [False, True], ids=["copies_at_issue", "copies_at_wait"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "fp64"])
@pytest.mark.parametrize("shape", sorted(KERNEL_SHAPES))
def test_kernel_walk_emulation_is_plain_bit_for_bit(shape, dtype, late):
    """``csrc/iir.cu``'s walk emulated on the CPU (``torch_iir_emulation``:
    the ring of ``iir.HOLD_STEPS`` slots, chunks of 32 steps, the odd
    extension copied from mirrored indices, the forward output split
    between the ring and the scratch, the reverse copies back, the
    transposed y stores, every copy landing as early or as late as
    ``cp.async.wait_group`` allows, every read's tag checked) equals
    ``sos_filtfilt_plain`` bit for bit at every kernel shape: the walk
    moves the values and the cascade keeps the plain version's operations.
    The stack's forward pass runs over the ring's edge in both dtypes."""
    n, t, order, band, fs = KERNEL_SHAPES[shape]
    x = torch.from_numpy(_trial(16, (n, t))).to(dtype)
    sos, zi, padlen = _sections(order, band, fs, dtype, CPU)
    got = Walk(x, sos, zi, padlen, iir.HOLD_STEPS[dtype], late).run()
    assert torch.equal(got, iir.sos_filtfilt_plain(x, sos, zi, padlen))


@pytest.mark.parametrize("slots", [128, 160, 288])
@pytest.mark.parametrize("shape", ["notch", "order 8"])
def test_kernel_walk_emulation_at_other_ring_sizes(shape, slots):
    """The walk's index arithmetic at rings smaller than the kernel's, so
    that the ragged shapes also run the scratch, a hold edge inside a chunk
    and reverse copies from the first chunks: still the plain version bit
    for bit (fp32, copies at the wait)."""
    n, t, order, band, fs = KERNEL_SHAPES[shape]
    x = torch.from_numpy(_trial(19, (n, t))).float()
    sos, zi, padlen = _sections(order, band, fs, torch.float32, CPU)
    assert 0 < t + 2 * padlen - slots
    got = Walk(x, sos, zi, padlen, slots, True).run()
    assert torch.equal(got, iir.sos_filtfilt_plain(x, sos, zi, padlen))


def test_hold_steps_keep_four_warps_an_sm():
    """``HOLD_STEPS`` is the largest multiple of 32 whose rings (33 elements
    a step, one a warp) fit a block of 4 warps in the 227 KB a block may use
    on the H100: 128 series an SM, the stack's 480 warps in one wave; the
    scratch holds the forward steps before them."""
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        block = lambda steps: 4 * steps * 33 * size  # noqa: E731
        hold = iir.HOLD_STEPS[dtype]
        assert hold % 32 == 0 and block(hold) <= 227 * 1024 < block(hold + 32)
        assert iir.scratch_steps(585, 27, dtype) == 639 - hold
        assert iir.scratch_steps(41, 21, dtype) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "fp64"])
@pytest.mark.parametrize("shape", sorted(KERNEL_SHAPES))
def test_kernel_matches_plain(cuda, shape, dtype):
    n, t, order, band, fs = KERNEL_SHAPES[shape]
    x = torch.from_numpy(_trial(16, (n, t))).to(cuda, dtype)
    sos, zi, padlen = _sections(order, band, fs, dtype, cuda)
    kernel = iir.KERNELS[dtype]
    before = kernel.launches
    got = iir.sos_filtfilt(x, sos, zi, padlen)
    assert kernel.launches == before + 1
    want = iir.sos_filtfilt_plain(x, sos, zi, padlen)
    torch.cuda.synchronize()
    rel = 1e-4 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(got, want, rtol=0, atol=rel * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "fp64"])
def test_kernel_long_recording_matches_plain(cuda, dtype):
    """One recording of 12,000 samples, order 4: the kernel's one warp runs
    a chain of ~24,000 steps through its ring, most of the forward pass in
    the scratch."""
    x = torch.from_numpy(_trial(18, (1, 12000))).to(cuda, dtype)
    sos, zi, padlen = _sections(4, (1, 70), 256, dtype, cuda)
    assert iir.scratch_steps(12000, padlen, dtype) > 11000
    got = iir.sos_filtfilt(x, sos, zi, padlen)
    want = iir.sos_filtfilt_plain(x, sos, zi, padlen)
    torch.cuda.synchronize()
    rel = 1e-4 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(got, want, rtol=0, atol=rel * want.abs().max().item())


@pytest.mark.gpu
def test_batched_stack_is_one_launch(cuda):
    x = torch.from_numpy(_trial(17, (6, 585, 32))).to(cuda, torch.float32)
    before = iir.KERNEL.launches
    got = ops.batched(ops.filter_data_notch, 60, 5, fs=256)(x)
    assert iir.KERNEL.launches == before + 1
    de = ops.batched(ops.differential_entropy)(x)
    assert iir.KERNEL.launches == before + 1 + 5  # one filter call a band
    want = ops.batched(ops.filter_data_notch, 60, 5, fs=256, device=CPU)(x.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * want.abs().max().item())
    de_cpu = ops.batched(ops.differential_entropy, device=CPU)(x.cpu())
    torch.testing.assert_close(de.cpu(), de_cpu, rtol=0, atol=2e-3)


@pytest.mark.gpu
def test_kernel_refusals(cuda):
    sos, zi, padlen = _sections(4, (1, 70), 256, torch.float32, cuda)
    x = torch.randn(4, 100, device=cuda, requires_grad=True)
    before = iir.KERNEL.launches
    with pytest.raises(RuntimeError, match="no backward"):
        iir.sos_filtfilt(x, sos, zi, padlen)
    with torch.no_grad():
        iir.sos_filtfilt(x, sos, zi, padlen)
    with pytest.raises(TypeError):
        iir.sos_filtfilt(x.detach().half(), sos.half(), zi.half(), padlen)
    big, big_zi, big_pad = _sections(9, (1, 70), 256, torch.float32, cuda)  # 9 sections
    with pytest.raises(ValueError, match="9 sections"):
        iir.sos_filtfilt(torch.randn(4, 100, device=cuda), big, big_zi, big_pad)
    assert iir.KERNEL.launches == before + 1

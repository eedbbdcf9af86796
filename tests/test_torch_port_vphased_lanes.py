"""The port's vectorized phased trainer against the JAX package on the CPU:
its improvement switches and bf16 (the small set of
``tests/test_torch_port_vphased.py``, both trainers from the JAX init).

- ``reset_optimizer_each_epoch=False`` with ``early_stop=True``
  (``es_patience=4``): six ``valence`` epochs, each subject from its own
  learning-rate lane (1e-9, 1e-5, 1e-4, 1e-3) so that decisions come
  within the run: the 1e-9 and 1e-3 subjects' test losses rise every epoch
  (by 0.6-2.3%, far above the packages' drift), so after three bad epochs
  their lanes fall by the phase's factor 0.1 and after four they stop. Every
  epoch's per-subject test and train loss within ``ES_RTOL`` relative (2e-4:
  measured 7.9e-5, the 1e-3 subject's; the others below 2.1e-6), and the
  ``lr`` and ``stopped`` lanes after every epoch and ``stop_epoch`` equal to
  JAX's;
- ``compute_dtype="bfloat16"``: two ``eeg`` epochs against the JAX bf16
  trainer, per-subject train and test losses within 2e-3 relative (the bar of
  ``tests/test_torch_port_bf16.py``), accuracies within one sample; fp32
  master parameters and BatchNorm stats.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_sentiment_aanalysis_tpu_torch.utils import vector_schedule_init
from test_torch_port_vphased import N_SUBJECTS, _tiny_arrays, jax_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ES_PHASE, ES_EPOCHS, ES_LANES = "valence", 6, np.array([1e-9, 1e-5, 1e-4, 1e-3], np.float32)
ES_RTOL = 2e-4
BF16_PHASE, BF16_EPOCHS = "eeg", 2


@pytest.fixture(scope="module")
def arrays():
    return _tiny_arrays()


@pytest.fixture(scope="module")
def es_runs(arrays):
    """Both trainers through ES_EPOCHS of ES_PHASE, each subject from its
    ES_LANES learning rate, moments kept, early stop on."""
    from multimodal_sentiment_aanalysis_tpu.utils import schedule as jschedule

    jt, pt, _ = jax_pair(arrays, reset_optimizer_each_epoch=False, early_stop=True,
                         es_patience=4)
    jt._phase_sched = {ES_PHASE: {**jschedule.vector_schedule_init(N_SUBJECTS, 1e-4),
                                  "lr": jnp.asarray(ES_LANES)}}
    jt._phase_epochs = {ES_PHASE: 0}
    pt._phase_sched = {ES_PHASE: {**vector_schedule_init(N_SUBJECTS, 1e-4),
                                  "lr": torch.from_numpy(ES_LANES.copy())}}
    pt._phase_epochs = {ES_PHASE: 0}
    jt.run_phase(ES_PHASE, ES_EPOCHS)
    pt.run_phase(ES_PHASE, ES_EPOCHS)
    return jt, pt


def test_early_stop_lanes_match_jax(es_runs):
    jt, pt = es_runs
    for split in ("train", "test"):
        np.testing.assert_allclose(np.array(pt.metrics[split]["loss"]),
                                   np.array(jt.metrics[split]["loss"]), rtol=ES_RTOL, atol=0,
                                   err_msg=split)
    for k in ("lr", "stopped"):
        np.testing.assert_array_equal(pt._last_hist[k], np.asarray(jt._last_hist[k]), err_msg=k)
    for k in ("lr", "stopped", "stop_epoch", "es_counter", "plateau_bad"):
        np.testing.assert_array_equal(pt._phase_sched[ES_PHASE][k].numpy(),
                                      np.asarray(jt._phase_sched[ES_PHASE][k]), err_msg=k)
    # the run made decisions: two subjects' lanes cut by 0.1 and stopped
    np.testing.assert_array_equal(pt._phase_sched[ES_PHASE]["stop_epoch"].numpy(), [5, 0, 0, 5])
    np.testing.assert_allclose(pt._phase_sched[ES_PHASE]["lr"].numpy(),
                               ES_LANES * [0.1, 1, 1, 0.1], rtol=1e-6)
    assert pt.stop_report(ES_PHASE) == jt.stop_report(ES_PHASE)


def test_stopped_subjects_are_frozen(es_runs):
    """A stopped subject's test loss repeats exactly after its stop: its
    parameters, BatchNorm stats and moments were selected back."""
    _, pt = es_runs
    te = np.array(pt.metrics["test"]["loss"])  # (E, S)
    for s, stop in enumerate(pt._phase_sched[ES_PHASE]["stop_epoch"].tolist()):
        if stop:
            np.testing.assert_array_equal(te[stop:, s], te[stop - 1, s])


def test_bf16_phase_matches_jax(arrays):
    jt, pt, _ = jax_pair(arrays, compute_dtype="bfloat16")
    jt.run_phase(BF16_PHASE, BF16_EPOCHS)
    pt.run_phase(BF16_PHASE, BF16_EPOCHS)
    rows = {"train": pt.train_idx.shape[1], "test": pt.ex_nums}
    for split in ("train", "test"):
        for k in ("loss", "c_loss", "a_acc", "v_acc"):
            got, want = np.array(pt.metrics[split][k]), np.array(jt.metrics[split][k])
            if k.endswith("acc"):
                np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / rows[split] + 1e-6,
                                           err_msg=f"{split} {k}")
            else:
                np.testing.assert_allclose(got, want, rtol=2e-3, atol=0, err_msg=f"{split} {k}")
    assert pt.params.dtype == pt.stats.dtype == torch.float32
    assert bool(torch.isfinite(pt.params).all())

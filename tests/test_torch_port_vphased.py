"""The port's vectorized phased curriculum against the JAX package on the CPU.

Four subjects of eight trials from the synthetic MAHNOB-HCI set (EEG cut to
16 steps), the flagship at feat_dim 16, batch 8, ``dropout=0.0``, both
trainers from the JAX ``VectorizedPhasedTrainer``'s stacked init
(``vmap(init_one)``, carried in through ``jax_import.phased_state_from_jax``):

- ``_phase_plans`` bit-equal to JAX's, from the same subject seeds;
- the curriculum (1, 1, 1, 2, 2) of both: every epoch's per-subject train
  and test metrics (losses within 1e-4 relative, accuracies equal),
  ``run()``'s accuracies equal, every subject's final parameters within 5 x
  lr and BatchNorm stats within ``STATS_ATOL`` (2e-4, measured 1e-4: a bias
  before a BatchNorm has an exact gradient of 0 that Adam turns into +-lr
  steps on float noise, and the running mean after it follows);
- the same run against four sequential port ``MultiTaskTrainer`` s from the
  same init, seeds and plans: metrics within 1e-4 relative, parameters
  within 5 x lr, BatchNorm stats within ``STATS_ATOL``;
- the row form's steps run no EEG-encoder backward in the phases whose loss
  does not reach it; the refusals; a subject's slice loads strictly; a
  full-state round trip and the per-subject checkpoint files;
- on a card (``gpu``, skipped here): each phase's launches for all models
  at once, frozen columns bit-unchanged, no host sync. The module imports
  no JAX at load, so that the card's test runs without it:
  ``python -m pytest --noconftest -m gpu tests/test_torch_port_vphased.py``.

The schedule lanes and bf16 run against JAX in
``tests/test_torch_port_vphased_lanes.py``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset
from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem_train
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MultimodalTransformerModel,
    phased_state_from_jax,
)
from multimodal_sentiment_aanalysis_tpu_torch.train import (
    METRIC_KEYS,
    PHASE_ORDER,
    PHASES,
    MultiTaskTrainer,
    VectorizedPhasedTrainer,
)
from torch_parallel_ranks import one_rank_mesh  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N_SUBJECTS, EX_NUMS, BATCH, FEAT, T_EEG, LR = 4, 8, 8, 16, 16, 1e-4
CURRICULUM = (1, 1, 1, 2, 2)
STATS_ATOL = 2e-4


def _model(**kw) -> MultimodalTransformerModel:
    return MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG, dropout=0.0, **kw)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _tiny_arrays():
    from test_torch_port_vloso import _tiny_arrays

    return _tiny_arrays()


def jax_pair(arrays, **kw):
    """A JAX and a port ``VectorizedPhasedTrainer`` on ``arrays``, the
    port's state loaded from the JAX trainer's stacked init; also returns
    that init as a stacked ``state_dict``."""
    from multimodal_sentiment_aanalysis_tpu import models as jmodels
    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
    from multimodal_sentiment_aanalysis_tpu.train import VectorizedPhasedTrainer as JaxVPT

    kw = dict(batch_size=BATCH, seed=0, verbose=False, **kw)
    jt = JaxVPT(jmodels.MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG, dropout=0.0),
                JaxDataset(arrays), N_SUBJECTS, EX_NUMS, **kw)
    init = phased_state_from_jax(_np(jt.params), _np(jt.batch_stats))
    pt = VectorizedPhasedTrainer(_model(), DeviceDataset(arrays, "cpu"), N_SUBJECTS, EX_NUMS,
                                 **kw)
    pt.load_stacked_state(init)
    return jt, pt, init


def check_subject_state(got: dict, want: dict, label: str, param_atol: float = 5 * LR):
    for name, t in got.items():
        if "num_batches" in name:
            continue
        atol = STATS_ATOL if "running" in name else param_atol
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=atol,
                                   err_msg=f"{label} {name}")


@pytest.fixture(scope="module")
def arrays():
    return _tiny_arrays()


@pytest.fixture(scope="module")
def runs(arrays):
    """The curriculum through both trainers from one init."""
    jt, pt, init = jax_pair(arrays)
    results = {"jax": jt.run(*CURRICULUM), "port": pt.run(*CURRICULUM)}
    return jt, pt, init, results


def test_phase_plans_bit_equal_to_jax():
    """The per-subject host plans of a ragged split (16 train rows, batch 6)
    draw exactly as the JAX trainer's, from the same subject seeds."""
    from multimodal_sentiment_aanalysis_tpu.train import VectorizedPhasedTrainer as JaxVPT

    pt = VectorizedPhasedTrainer(_model(), DeviceDataset(_tiny_arrays(), "cpu"), 3, 8,
                                 batch_size=6, subject_seeds=[5, 9, 2], verbose=False)
    stub = SimpleNamespace(train_idx=pt.train_idx, batch_size=6, n_total=3, mesh=None,
                           host_rngs=[np.random.default_rng(s) for s in (5, 9, 2)])
    for epochs in (1, 2):
        got, want = pt._phase_plans(epochs), JaxVPT._phase_plans(stub, epochs)
        for g, w in zip(got, want):
            assert g.shape == (3, epochs, 3, 6) and g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))


def test_curriculum_metrics_match_jax(runs):
    jt, pt, _, results = runs
    for split in ("train", "test"):
        assert len(pt.metrics[split]["loss"]) == len(jt.metrics[split]["loss"]) == sum(CURRICULUM)
        for k in METRIC_KEYS:
            for e, (g, w) in enumerate(zip(pt.metrics[split][k], jt.metrics[split][k])):
                if k.endswith("acc"):
                    np.testing.assert_array_equal(g, w, err_msg=f"{split} {k} epoch {e}")
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=0,
                                               err_msg=f"{split} {k} epoch {e}")
    got, want = results["port"], results["jax"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_curriculum_state_matches_jax(runs):
    jt, pt, _, _ = runs
    want = phased_state_from_jax(_np(jt.params), _np(jt.batch_stats))
    for s in range(N_SUBJECTS):
        check_subject_state(pt.subject_variables(s), {k: v[s] for k, v in want.items()},
                            f"subject {s}")
    assert pt._phase_epochs == jt._phase_epochs
    for phase in PHASE_ORDER:  # parity mode: constant lr, nobody stopped
        assert torch.equal(pt._phase_sched[phase]["lr"], torch.full((N_SUBJECTS,), LR))
        assert not bool(pt._phase_sched[phase]["stopped"].any())


def test_matches_sequential_port_trainers(runs, arrays):
    """Subject s of the vectorized run equals a port ``MultiTaskTrainer`` of
    subject s alone (seed ``subject_seeds[s]``), from the same init."""
    _, pt, init, _ = runs
    full = DeviceDataset(arrays, "cpu")
    for s in range(N_SUBJECTS):
        mt = MultiTaskTrainer(_model(), full.subset(pt.train_idx[s]), full.subset(pt.test_idx[s]),
                              batch_size=BATCH, seed=pt.subject_seeds[s], verbose=False)
        mt.model.load_state_dict({k: v[s] for k, v in init.items()})
        mt.run(*CURRICULUM, save=False, plot=False)
        for split in ("train", "test"):
            for k in METRIC_KEYS:
                got = np.array([v[s] for v in pt.metrics[split][k]])
                np.testing.assert_allclose(got, mt.metrics[split][k], rtol=1e-4, atol=1e-7,
                                           err_msg=f"subject {s} {split} {k}")
        check_subject_state(pt.subject_variables(s), mt.model.state_dict(), f"subject {s}")


def test_row_form_runs_no_eeg_backward_outside_its_phases(monkeypatch, arrays):
    """A vectorized step reaches the stem tail's backward (one call for all
    models) only in the phases whose loss reaches the EEG encoder; its
    gradient columns outside the grad set are exact zeros."""
    from test_torch_port_phased import spy_calls

    calls = spy_calls(monkeypatch, conv_stem_train, "stem_tail_bwd_plain")
    pt = VectorizedPhasedTrainer(_model(), DeviceDataset(arrays, "cpu"), N_SUBJECTS, EX_NUMS,
                                 batch_size=BATCH, seed=0, verbose=False)
    plans, masks = pt._phase_plans(1)
    batch = pt._gather(torch.as_tensor(plans[:, 0, 0]))
    batch["mask"] = torch.as_tensor(masks[:, 0, 0])
    pt.model.train()
    for phase in PHASE_ORDER:
        calls.clear()
        grads, _ = pt._clipped_grads(phase, batch)
        assert len(calls) == (2 if phase in ("eeg", "fusion_arousal") else 0), phase
        assert all(shape[0] == N_SUBJECTS for shape in calls)
        inside = torch.zeros(grads.shape[1], dtype=torch.bool)
        for a, b in pt.layout.columns(PHASES[phase].grad_modules):
            inside[a:b] = True
        assert not bool(grads[:, ~inside].any()) and bool(grads[:, inside].any(1).all())


def test_subject_variables_and_refusals(arrays, tmp_path, one_rank_mesh):
    """A subject's slice loads strictly into the flagship model; under a
    one-rank mesh the trainer is the unsharded one, bit for bit (a phase's
    metrics, the rows); a full-state checkpoint round trip leaves the state
    as it was and ``save_checkpoints`` writes each subject's slice;
    ``rng_impl`` is recorded; a 0-epoch phase is a no-op."""
    data = DeviceDataset(arrays, "cpu")
    pt = VectorizedPhasedTrainer(_model(), data, N_SUBJECTS, EX_NUMS, batch_size=BATCH,
                                 seed=3, rng_impl="rbg", verbose=False)
    assert pt.rng_impl == "rbg" and pt.subject_seeds == [3, 4, 5, 6]
    assert pt.run_phase("eye", 0) == {} and not pt.metrics["train"]["loss"]
    pt.run_phase("valence", 1)
    for s in range(N_SUBJECTS):
        model = _model()
        model.load_state_dict(pt.subject_variables(s), strict=True)
    meshed = VectorizedPhasedTrainer(_model(), data, N_SUBJECTS, EX_NUMS, batch_size=BATCH,
                                     seed=3, verbose=False, mesh=one_rank_mesh)
    meshed.run_phase("valence", 1)
    for split in ("train", "test"):
        for k, v in pt.metrics[split].items():
            np.testing.assert_array_equal(meshed.metrics[split][k], v, err_msg=k)
    assert torch.equal(meshed.params, pt.params) and torch.equal(meshed.stats, pt.stats)
    with pytest.raises(ValueError):
        VectorizedPhasedTrainer(_model(), data, N_SUBJECTS, EX_NUMS, subject_seeds=[1, 2])
    params, stats = pt.params.clone(), pt.stats.clone()
    pt.restore_state(pt.save_state(str(tmp_path / "s")))
    assert torch.equal(pt.params, params) and torch.equal(pt.stats, stats)
    paths = pt.save_checkpoints(str(tmp_path / "subjects"))
    assert len(paths) == N_SUBJECTS and sorted(p.name for p in tmp_path.iterdir()) == [
        "s", "subjects"]
    for s, path in enumerate(paths):
        assert os.path.basename(path).startswith(f"TestPerson{s}_ArousalAcc")
        sd = torch.load(path, weights_only=True)
        assert all(torch.equal(t, pt.subject_variables(s)[n]) for n, t in sd.items())


# --------------------------------------------------------------------------
# card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_phased_trainer_on_card_launches_and_frozen_columns(cuda):
    """A small phased trainer (3 subjects, feat_dim 32) on the card: each
    phase's kernels launch once per call for all models (the EEG encoder's
    backward only in ``eeg`` and ``fusion_arousal``), the phase runs under
    ``set_sync_debug_mode("error")``, every column outside its update set is
    bit-unchanged, and the first phase's losses match the CPU's at dropout
    0 (rtol 1e-4)."""
    from multimodal_sentiment_aanalysis_tpu_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(23)
    n = 3 * 8
    arrays = {"eeg": rng.normal(size=(n, 32, 64)).astype(np.float32),
              "eye": rng.normal(size=(n, 38)).astype(np.float32),
              "pps": rng.normal(size=(n, 230)).astype(np.float32),
              "arousal": rng.integers(0, 3, n), "valence": rng.integers(0, 3, n)}

    def make(device):
        model = MultimodalTransformerModel(feat_dim=32, eeg_time=64, dropout=0.0, device=device)
        return VectorizedPhasedTrainer(model, DeviceDataset(arrays, device), 3, 8, batch_size=8,
                                       seed=0, verbose=False)

    card, cpu = make(cuda), make("cpu")
    steps = 2  # 16 train rows per subject, batch 8; one evaluation batch
    forward = dict(bilstm_fwd=2, stem_tail=2, infonce=1, bilstm_gemm=2, bilstm_rec=2)
    full = dict(bilstm_fwd=2, bilstm_cbnd=2, bilstm_segbwd=2, stem_tail=2, stem_tail_bwd=2,
                infonce=1, bilstm_gemm=8, bilstm_rec=2, bilstm_sweep=2, bilstm_cscan=2)
    for phase in PHASE_ORDER:
        before = card.params.clone()
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = card.run_phase_on_device(phase, 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        step = full if phase in ("eeg", "fusion_arousal") else forward
        assert launch_counts() == {k: steps * step.get(k, 0) + forward.get(k, 0)
                                   for k in launch_counts()}, phase
        got = card.record_phase(phase, out)
        if phase == PHASE_ORDER[0]:
            np.testing.assert_allclose(got["loss"], cpu.run_phase(phase, 1)["loss"], rtol=1e-4)
        inside = torch.zeros(card.params.shape[1], dtype=torch.bool, device=cuda)
        for a, b in card.layout.columns(PHASES[phase].update_modules):
            inside[a:b] = True
        assert torch.equal(card.params[:, ~inside], before[:, ~inside]), phase
        assert bool((card.params[:, inside] != before[:, inside]).any(1).all()), phase

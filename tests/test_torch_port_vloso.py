"""The port's vectorized LOSO trainer against the JAX package on the CPU.

Four subjects of eight trials from the synthetic MAHNOB-HCI set (EEG cut to
16 steps), the flagship at feat_dim 16, batch 8, ``dropout=0.0``, both
trainers from the JAX trainer's stacked init (``vmap(init_one)``, carried
in through ``jax_import``):

- two ``train_epoch`` of both trainers: per-subject loss within 1e-4
  relative, arousal and valence accuracy equal; every model's parameters
  after training within 5 x lr (Adam's first steps move each weight by about
  lr * sign(g), so a gradient that is ~0 on one side can flip that sign) and
  its BatchNorm running stats within 1e-5; ``evaluate()`` equal;
- the same run against four sequential port ``Trainer``s fed the same
  shuffles: losses within 1e-5 relative, parameters within 5 x lr;
- an early-stop run (``es_patience=1``, ``plateau_patience=0``, so that
  decisions come within a few epochs) on the host-plan path, each model
  starting from its own learning-rate lane: per-epoch held-out losses
  within 1e-4 relative, and ``stop_epoch``, the ``lr`` lanes and the
  best-checkpoint accuracies equal to JAX's;
- the host epoch plans bit-equal to JAX's, the on-device plans covering
  every train row once per epoch, the schedule lanes against the host
  dataclasses, the per-model NaN skip, and the fused epochs' schedule
  decisions replayed on the host dataclasses.
"""

import numpy as np
import pytest
import torch

import jax

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
    variables_from_torch_state_dict,
)
from multimodal_sentiment_aanalysis_tpu_torch.data import (
    DeviceDataset,
    assemble_features,
    make_synthetic_hci_data,
)
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MultimodalTransformerModel,
    trainer_state_from_jax,
)
from multimodal_sentiment_aanalysis_tpu_torch.train import Trainer, VectorizedLOSOTrainer
from multimodal_sentiment_aanalysis_tpu_torch.utils import (
    EarlyStopping,
    ReduceLROnPlateau,
    vector_schedule_init,
    vector_schedule_step,
)
from torch_parallel_ranks import one_rank_mesh  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N_SUBJECTS, EX_NUMS, BATCH, FEAT, T_EEG, EPOCHS, LR = 4, 8, 8, 16, 16, 2, 1e-4
# early-stop run: one learning-rate lane per model. The 1e-9 model's weights
# barely move, so its held-out loss moves only with its BatchNorm running
# stats: up by 1.4e-5 relative at epoch 2, so it stops there and its lane
# halves; the others improve by 0.5-20% an epoch. Both margins are over 50x
# the held-out loss's drift between the packages (2.4e-7 relative there; a
# single lr of 3e-3 or more for every model makes that drift grow past 1e-4
# by epoch 4 and decides on margins of that size)
ES_LANES, ES_EPOCHS = np.array([1e-9, 1e-5, 1e-4, 1e-3], np.float32), 4


def _tiny_arrays():
    data = make_synthetic_hci_data(seed=5, n_subjects=N_SUBJECTS, ex_nums=EX_NUMS)
    feats, _ = assemble_features(data, ["eeg", "eye", "pps"], norm="Z_score",
                                 label_type="arousal")
    return {
        "eeg": np.ascontiguousarray(feats["eeg"].astype(np.float32)[:, :, :T_EEG]),
        "eye": feats["eye"].astype(np.float32),
        "pps": feats["pps"].astype(np.float32),
        "arousal": np.asarray(data["arousal_label"]).astype(np.int64),
        "valence": np.asarray(data["valence_label"]).astype(np.int64),
    }


def _tree(tree):
    return {jax.tree_util.keystr(k): np.asarray(x)
            for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(arrays, **kw):
    """A JAX and a port ``VectorizedLOSOTrainer`` on ``arrays``, the port's
    state loaded from the JAX trainer's stacked init; also returns that
    init as a stacked ``state_dict`` and contrastive weights."""
    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
    from multimodal_sentiment_aanalysis_tpu.train import VectorizedLOSOTrainer as JaxVLOSO

    args = (N_SUBJECTS, EX_NUMS)
    kw = dict(batch_size=BATCH, seed=0, **kw)
    jt = JaxVLOSO(jmodels.MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG, dropout=0.0),
                  JaxDataset(arrays), *args, **kw)
    sd, cw = trainer_state_from_jax(jax.tree.map(np.asarray, jt.params),
                                    jax.tree.map(np.asarray, jt.batch_stats))
    pt = VectorizedLOSOTrainer(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG,
                                                          dropout=0.0),
                               DeviceDataset(arrays, "cpu"), *args, **kw)
    pt.load_stacked_state(sd, cw)
    return jt, pt, sd, cw


@pytest.fixture(scope="module")
def arrays():
    return _tiny_arrays()


@pytest.fixture(scope="module")
def runs(arrays):
    """Two ``train_epoch`` of both trainers from one init."""
    jt, pt, sd, cw = _pair(arrays)
    history = {"jax": [], "port": []}
    for _ in range(EPOCHS):
        history["jax"].append(jt.train_epoch())
        history["port"].append(pt.train_epoch())
    return jt, pt, history, sd, cw


def test_epoch_metrics_match_jax(runs):
    _, _, history, _, _ = runs
    for j, p in zip(history["jax"], history["port"]):
        assert j.keys() == p.keys() == {"loss", "a_acc", "v_acc"}
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-4, atol=0)
        np.testing.assert_array_equal(p["a_acc"], j["a_acc"])
        np.testing.assert_array_equal(p["v_acc"], j["v_acc"])


def test_parameters_and_stats_after_training_match_jax(runs):
    jt, pt, _, _, _ = runs
    for s in range(N_SUBJECTS):
        got = _tree(variables_from_torch_state_dict(pt.subject_variables(s)))
        want = _tree(jax.tree.map(lambda x: x[s], {"params": jt.params["model"],
                                                    "batch_stats": jt.batch_stats}))
        assert got.keys() == want.keys()
        for k in want:
            atol = 1e-5 if k.startswith("['batch_stats']") else 5 * LR
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=f"{s} {k}")
    np.testing.assert_allclose(
        pt._param_dict(pt.params)["trainer.contrastive_weight"].numpy(),
        np.asarray(jt.params["trainer"]["contrastive_weight"]), rtol=0, atol=5 * LR)


def test_evaluate_matches_jax(runs):
    jt, pt, _, _, _ = runs
    got, want = pt.evaluate(), jt.evaluate()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


class _Replay:
    """A host generator stand-in that hands out given permutations."""

    def __init__(self, perms):
        self.perms = list(perms)

    def permutation(self, n):
        perm = self.perms.pop(0)
        assert len(perm) == n
        return perm


def test_matches_sequential_port_trainers(runs, arrays):
    """Subject s of the vectorized run equals a port ``Trainer`` of subject
    s alone, from the same init and on the same shuffles."""
    _, pt, history, sd, cw = runs
    host = np.random.default_rng(0)  # the vectorized trainer's host stream
    n_train = pt.train_idx.shape[1]
    perms = [[host.permutation(n_train) for _ in range(N_SUBJECTS)] for _ in range(EPOCHS)]
    full = DeviceDataset(arrays, "cpu")
    te = pt._te_metrics().numpy()
    for s in range(N_SUBJECTS):
        model = MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG, dropout=0.0)
        model.load_state_dict({k: v[s] for k, v in sd.items()}, strict=True)
        t = Trainer(model, full.subset(pt.train_idx[s]), full.subset(pt.test_idx[s]),
                    batch_size=BATCH, seed=0, verbose=False)
        with torch.no_grad():
            t.contrastive_weight.copy_(cw[s])
        t.host_rng = _Replay(p[s] for p in perms)
        for e in range(EPOCHS):
            loss, _, _, a_acc = t.train_epoch(e + 1)
            np.testing.assert_allclose(loss, history["port"][e]["loss"][s], rtol=1e-5)
            np.testing.assert_allclose(a_acc, history["port"][e]["a_acc"][s], rtol=0, atol=1e-6)
        te_loss, _, _, te_acc = t.test()
        np.testing.assert_allclose(te_loss, te[s, 0], rtol=1e-5)
        np.testing.assert_allclose(te_acc, te[s, 1], rtol=0, atol=1e-6)
        got = pt.subject_variables(s)
        for k, v in t.model.state_dict().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=5 * LR,
                                       err_msg=f"{s} {k}")


# --------------------------------------------------------------------------
# early stop and plateau LR
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def es_runs(arrays):
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.train.state import set_learning_rate

    jt, pt, _, _ = _pair(arrays, early_stop=True, es_patience=1, plateau_patience=0)
    jt.sched = {**jt.sched, "lr": jnp.asarray(ES_LANES)}
    jt.opt_state = set_learning_rate(jt.opt_state, jt.sched["lr"])
    pt.sched["lr"] = pt.opt.lr = torch.from_numpy(ES_LANES.copy())
    history = {"jax": [], "port": []}
    for epoch in range(1, ES_EPOCHS + 1):
        history["jax"].append(jt._host_es_epoch(epoch))
        history["port"].append(pt._host_es_epoch(epoch))
    return jt, pt, history


def test_early_stop_lanes_match_jax(es_runs):
    jt, pt, history = es_runs
    for j, p in zip(history["jax"], history["port"]):
        np.testing.assert_allclose(p["te_loss"], j["te_loss"], rtol=1e-4, atol=0)
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-4, atol=0)
    for k in ("lr", "stopped", "stop_epoch", "es_counter", "plateau_bad"):
        np.testing.assert_array_equal(pt.sched[k].numpy(), np.asarray(jt.sched[k]), err_msg=k)
    # the run made decisions: model 0 stopped at epoch 2 and its lr halved
    np.testing.assert_array_equal(pt.sched["stop_epoch"].numpy(), [2, 0, 0, 0])
    np.testing.assert_array_equal(pt.sched["lr"].numpy(), ES_LANES * [0.5, 1, 1, 1])
    assert pt.stop_report().splitlines()[0] == jt.stop_report().splitlines()[0]


def test_best_checkpoint_accuracies_match_jax(es_runs):
    jt, pt, _ = es_runs
    for best in (True, False):
        got, want = pt.evaluate(best=best), jt.evaluate(best=best)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"best={best} {k}")


# --------------------------------------------------------------------------
# plans, schedule lanes, NaN skip, fused epochs (port only, or cheap JAX)
# --------------------------------------------------------------------------


def test_epoch_plans_bit_equal_to_jax():
    """The host plans of a ragged split (16 train rows, batch 6) draw exactly
    as the JAX trainer's, from the same seed."""
    from types import SimpleNamespace

    from multimodal_sentiment_aanalysis_tpu.train import VectorizedLOSOTrainer as JaxVLOSO

    pt = VectorizedLOSOTrainer(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                               DeviceDataset(_tiny_arrays(), "cpu"), 3, 8, batch_size=6, seed=3)
    stub = SimpleNamespace(train_idx=pt.train_idx, batch_size=6, n_total=3,
                           host_rng=np.random.default_rng(3))
    for _ in range(2):
        got, want = pt._epoch_plans(), JaxVLOSO._epoch_plans(stub)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_device_plans_cover_every_train_row_once():
    pt = VectorizedLOSOTrainer(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                               DeviceDataset(_tiny_arrays(), "cpu"), 3, 8, batch_size=6, seed=0)
    seen = []
    for _ in range(2):
        plans, masks = pt._device_plans()
        assert plans.shape == masks.shape == (3, 3, 6)  # 16 train rows, batch 6
        for s in range(3):
            real = plans[s].reshape(-1)[masks[s].reshape(-1) == 1.0]
            assert sorted(real.tolist()) == sorted(pt.train_idx[s].tolist())
            assert set(plans[s].reshape(-1).tolist()) <= set(pt.train_idx[s].tolist())
        seen.append(plans)
    assert not torch.equal(seen[0], seen[1])  # a new shuffle every epoch


def test_vector_schedule_matches_host_classes():
    """The ``(S,)`` lanes against the host dataclasses in the calling
    pattern of ``Trainer.run`` (scheduler fed finite losses only, early
    stop every loss, the loop left at the stop), decision for decision,
    and against the JAX vector transition; ``stop_epoch`` stays 0 for a
    lane that never stopped."""
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.utils import schedule as jschedule

    rng = np.random.default_rng(11)
    n_lanes, n_epochs, lr0 = 16, 40, 1e-3
    losses = rng.normal(1.0, 0.3, size=(n_epochs, n_lanes)).astype(np.float32)
    # lanes 0-3 improve by over 1% every epoch
    losses[:, :4] = np.linspace(2.0, 1.0, n_epochs)[:, None] * (1 + 0.1 * np.arange(4))
    losses[5, 6] = np.nan  # the scheduler must skip it, the early stop count it
    state, jstate = vector_schedule_init(n_lanes, lr0), jschedule.vector_schedule_init(n_lanes, lr0)
    lr_hist, best_hist = [], []
    for e in range(n_epochs):
        state, improved = vector_schedule_step(state, torch.from_numpy(losses[e]), e + 1)
        jstate, jimproved = jschedule.vector_schedule_step(jstate, jnp.asarray(losses[e]), e + 1)
        np.testing.assert_array_equal(improved.numpy(), np.asarray(jimproved))
        for k in jstate:
            np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]), err_msg=k)
        lr_hist.append(state["lr"].numpy())
        best_hist.append(improved.numpy())
    stop_epoch = state["stop_epoch"].numpy()
    for lane in range(n_lanes):
        sch, early, host_stop = ReduceLROnPlateau(lr=lr0), EarlyStopping(), 0
        for e in range(n_epochs):
            te = float(losses[e, lane])
            if np.isfinite(te):
                sch.step(te)
            saved = early.step(te)
            assert lr_hist[e][lane] == np.float32(sch.lr), (lane, e)
            assert best_hist[e][lane] == saved, (lane, e)
            if early.should_stop:
                host_stop = e + 1
                break
        assert stop_epoch[lane] == host_stop, lane
    assert (stop_epoch[:4] == 0).all()  # the improving lanes never stopped


def test_nan_batch_skips_only_that_model():
    """A non-finite loss in one model leaves that model's parameters,
    moments, step count and BN running stats as they were; the others
    step."""
    pt = VectorizedLOSOTrainer(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                               DeviceDataset(_tiny_arrays(), "cpu"), 3, 8, batch_size=8, seed=0)
    # each model's batch from another subject's rows; only model 1 sees the inf
    idx = torch.as_tensor(np.stack([pt.train_idx[0][:8], pt.train_idx[1][8:16],
                                    pt.train_idx[2][:8]]))
    pt.data.arrays["eeg"][idx[1, 0], 0, 0] = float("inf")
    before = [t.clone() for t in (pt.params, pt.stats, pt.opt.mu, pt.opt.count)]
    pt.model.train()
    sums = pt._train_step(idx, torch.ones(3, 8), torch.ones(3, dtype=torch.bool))
    after = (pt.params, pt.stats, pt.opt.mu, pt.opt.count)
    for b, a in zip(before, after):
        assert torch.equal(a[1], b[1])
        assert not torch.equal(a[0], b[0]) and not torch.equal(a[2], b[2])
    assert torch.equal(sums[1], torch.zeros(4)) and sums[0, 3] == sums[2, 3] == 8


def test_fused_early_stop_decisions_replay_on_host_classes():
    """The fused epochs' schedule decisions, replayed on the host
    dataclasses over the run's own held-out losses, give every subject's
    stop epoch and LR; a stopped subject is frozen, so its held-out loss
    repeats exactly; the fused epochs are deterministic in the seed."""
    def make():
        return VectorizedLOSOTrainer(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                                     DeviceDataset(_tiny_arrays(), "cpu"), N_SUBJECTS, EX_NUMS,
                                     batch_size=BATCH, seed=0, lr=3e-2, early_stop=True,
                                     es_patience=1, plateau_patience=0)

    pt, n_epochs = make(), 5
    out = pt.train_epochs_fused(n_epochs)
    assert out["loss"].shape == out["te_loss"].shape == (n_epochs, N_SUBJECTS)
    te, stop_epoch = out["te_loss"], pt.sched["stop_epoch"].numpy()
    assert (stop_epoch > 0).any()
    for s in range(N_SUBJECTS):
        sch, early, host_stop = ReduceLROnPlateau(lr=3e-2, patience=0), EarlyStopping(1), 0
        for e in range(n_epochs):
            v = float(te[e, s])
            if np.isfinite(v):
                sch.step(v)
            early.step(v)
            assert np.float32(sch.lr) == out["lr"][e, s], (s, e)
            if early.should_stop:
                host_stop = e + 1
                break
        assert stop_epoch[s] == host_stop, s
        if 0 < host_stop < n_epochs:
            np.testing.assert_array_equal(te[host_stop:, s], te[host_stop - 1, s])
            assert out["stopped"][host_stop - 1:, s].all()
    again = make().train_epochs_fused(n_epochs)
    np.testing.assert_array_equal(again["loss"], out["loss"])


def test_subject_variables_and_unported_options(one_rank_mesh):
    """A subject's slice loads strictly into the flagship model, whose eval
    accuracies equal ``evaluate()``'s; under a one-rank mesh the trainer is
    the unsharded one, bit for bit (an epoch's metrics, the rows, the
    evaluation and a subject's slice)."""
    arrays = _tiny_arrays()
    pt = VectorizedLOSOTrainer(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                               DeviceDataset(arrays, "cpu"), 3, 8, batch_size=8, seed=0)
    pt.train_epoch()
    acc = pt.evaluate()["a_acc"]
    for s in range(3):
        model = MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG).eval()
        model.load_state_dict(pt.subject_variables(s), strict=True)
        rows = pt.test_idx[s]
        with torch.no_grad():
            a, _ = model(*(torch.from_numpy(arrays[k][rows]) for k in ("eeg", "eye", "pps")))
        hit = (a.argmax(1).numpy() == arrays["arousal"][rows]).mean()
        np.testing.assert_allclose(hit, acc[s], rtol=0, atol=1e-6)
    mt = VectorizedLOSOTrainer(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                               DeviceDataset(arrays, "cpu"), 3, 8, batch_size=8, seed=0,
                               mesh=one_rank_mesh)
    ref = VectorizedLOSOTrainer(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                                DeviceDataset(arrays, "cpu"), 3, 8, batch_size=8, seed=0)
    got, want = mt.train_epoch(), ref.train_epoch()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert mt.n_total == 3 and torch.equal(mt.params, ref.params)
    assert torch.equal(mt.stats, ref.stats)
    np.testing.assert_array_equal(mt.evaluate()["a_acc"], ref.evaluate()["a_acc"])
    for k, v in ref.subject_variables(2).items():
        assert torch.equal(mt.subject_variables(2)[k], v), k

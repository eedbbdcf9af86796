"""The port's full-state checkpoints and utilities on the CPU.

Resume, for each of the four trainers: train k epochs, ``save_state``,
build a fresh trainer with another seed (so that a field left unrestored
shows), ``restore_state``, train m more; the result is bit-equal to the
first trainer training the m epochs straight on (saving changes nothing):
every parameter, BatchNorm stat, optimizer tensor and schedule lane, the
generators' states, the host generators, the histories and metrics. The
models keep their reference dropout, so the dropout generator's state
matters. ``VectorizedLOSOTrainer`` with ``early_stop`` on and off, and in
bf16 (``compute_dtype`` and ``moment_dtype``); host-plan and fused epochs,
so that both the host and the plan generator are exercised.

Also: restore refusals (another device type's generator, another
``early_stop``, another moment dtype), ``save_checkpoints`` named by the
JAX method with ``.pt`` for ``.msgpack`` and each file loading strictly
into the flagship, ``checkified`` (an injected NaN named by its op, a
clean audited epoch bit-equal to an unaudited one), ``seed_all``, the
timers.

Four subjects of eight trials from the synthetic MAHNOB-HCI set (EEG cut
to 16 steps), the flagship at feat_dim 16, batch 8.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset, loso_split
from multimodal_sentiment_aanalysis_tpu_torch.models import MultimodalTransformerModel
from multimodal_sentiment_aanalysis_tpu_torch.train import (
    MultiTaskTrainer,
    Trainer,
    VectorizedLOSOTrainer,
    VectorizedPhasedTrainer,
)
from multimodal_sentiment_aanalysis_tpu_torch.utils import (
    StepTimer,
    checkified,
    load_checkpoint,
    save_checkpoint,
    seed_all,
    strip_module_prefix,
    timed,
)
from multimodal_sentiment_aanalysis_tpu_torch.utils.checks import NonFiniteError
from multimodal_sentiment_aanalysis_tpu_torch.utils.timing import timed_fresh, timed_out
from test_torch_port_vloso import _tiny_arrays
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N_SUBJECTS, EX_NUMS, BATCH, FEAT, T_EEG = 4, 8, 8, 16, 16


def _model(seed: int) -> MultimodalTransformerModel:
    """The flagship at its reference dropout, initialised from ``seed``."""
    return MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG,
                                      generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def data():
    return DeviceDataset(_tiny_arrays(), "cpu")


def _split(data, subject=0):
    tr, te = loso_split(N_SUBJECTS, EX_NUMS, subject)
    return data.subset(tr), data.subset(te)


def assert_same(a, b, path="state"):
    """``a`` and ``b`` equal bit for bit: tensors and arrays by value and
    dtype, dicts by key, lists and tuples by item, the rest by ``==``."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def resumed(make, advance_k, advance_m, snapshot, path):
    """k, save, m on one trainer, against k, save, a fresh trainer from
    another seed restoring the file, m; returns both snapshots after m."""
    a = make(0)
    advance_k(a)
    a.save_state(path)
    advance_m(a)
    b = make(7)
    assert_differs = snapshot(b)
    b.restore_state(path)
    advance_m(b)
    want, got = snapshot(a), snapshot(b)
    return want, got, assert_differs


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------


def _trainer_snapshot(t: Trainer) -> dict:
    return {"model": t.model.state_dict(), "cw": t.contrastive_weight.detach(),
            "optimizer": t.optimizer.state_dict(), "generator": t.generator.get_state(),
            "host_rng": t.host_rng.bit_generator.state, "scheduler": t.scheduler,
            "early": t.early, "histories": (t.train_loss, t.test_loss, t.train_acc, t.test_acc)}


def test_trainer_resume_is_bit_equal(data, tmp_path):
    train, test = _split(data)

    def make(seed):
        return Trainer(_model(seed), train, test, batch_size=BATCH, seed=seed, patience=1,
                       checkpoint_dir=str(tmp_path), verbose=False)

    want, got, fresh = resumed(make, lambda t: t.run(2, 0), lambda t: t.run(2, 0),
                               _trainer_snapshot, str(tmp_path / "trainer.pt"))
    assert_same(want, got)
    assert not torch.equal(fresh["generator"], want["generator"])
    assert len(want["histories"][0]) == 4


def _loso_snapshot(vt: VectorizedLOSOTrainer) -> dict:
    return {"tensors": {k: v.clone() for k, v in vt._state_tensors().items()},
            "generator": vt.generator.get_state(),
            "plan_generator": vt.plan_generator.get_state(),
            "host_rng": vt.host_rng.bit_generator.state,
            "epochs_run": getattr(vt, "_epochs_run", None)}


def _loso_epochs(vt: VectorizedLOSOTrainer) -> None:
    vt.train_epoch()
    vt.train_epochs_fused(1)


@pytest.mark.parametrize("early_stop, dtype", [(False, None), (True, None),
                                               (True, "bfloat16")])
def test_loso_resume_is_bit_equal(data, tmp_path, early_stop, dtype):
    def make(seed):
        return VectorizedLOSOTrainer(_model(seed), data, N_SUBJECTS, EX_NUMS,
                                     batch_size=BATCH, seed=seed, early_stop=early_stop,
                                     es_patience=1, plateau_patience=0, compute_dtype=dtype,
                                     moment_dtype=dtype)

    want, got, fresh = resumed(make, _loso_epochs, _loso_epochs, _loso_snapshot,
                               str(tmp_path / "loso.pt"))
    assert_same(want, got)
    moved = ["params", "stats", "opt.mu", "opt.nu", "opt.count"]
    if early_stop:
        moved += ["sched.es_best", "sched.plateau_best", "best_params", "best_stats"]
        assert want["epochs_run"] == 2
    for name in moved:
        assert not torch.equal(want["tensors"][name], fresh["tensors"][name]), name
    if dtype:
        assert want["tensors"]["opt.mu"].dtype == torch.bfloat16


def _mt_snapshot(mt: MultiTaskTrainer) -> dict:
    return {"model": mt.model.state_dict(), "generator": mt.generator.get_state(),
            "host_rng": mt.host_rng.bit_generator.state, "schedulers": mt.schedulers,
            "metrics": mt.metrics, "test_person": mt.test_person}


def test_multitask_resume_is_bit_equal(data, tmp_path):
    train, test = _split(data, 2)

    def make(seed):
        return MultiTaskTrainer(_model(seed), train, test, test_person=2 if seed == 0 else 5,
                                batch_size=BATCH, seed=seed, verbose=False)

    run = lambda *epochs: lambda mt: mt.run(*epochs, save=False, plot=False)
    want, got, _ = resumed(make, run(1, 0, 0, 1, 0), run(0, 1, 0, 1, 1), _mt_snapshot,
                           str(tmp_path / "mt.pt"))
    assert_same(want, got)
    assert len(want["metrics"]["train"]["loss"]) == 5 and want["test_person"] == 2


def _vp_snapshot(vt: VectorizedPhasedTrainer) -> dict:
    return {"params": vt.params.clone(), "stats": vt.stats.clone(),
            "generator": vt.generator.get_state(),
            "host_rngs": [r.bit_generator.state for r in vt.host_rngs],
            "phase_epochs": dict(vt._phase_epochs), "phase_sched": vt._phase_sched,
            "metrics": vt.metrics, "last_test": vt._last_test, "last_hist": vt._last_hist}


def test_vphased_resume_is_bit_equal(data, tmp_path):
    """Across a phase boundary and back into a phase whose lanes and epoch
    count persist (moments kept through a phase, plateau and early-stop
    lanes live)."""
    def make(seed):
        return VectorizedPhasedTrainer(_model(seed), data, N_SUBJECTS, EX_NUMS,
                                       batch_size=BATCH, seed=seed, verbose=False,
                                       reset_optimizer_each_epoch=False, early_stop=True,
                                       es_patience=1)

    def k(vt):
        vt.run_phase("eeg", 1)
        vt.run_phase("fusion_arousal", 1)

    def m(vt):
        vt.run_phase("valence", 1)
        vt.run_phase("fusion_arousal", 2)

    want, got, _ = resumed(make, k, m, _vp_snapshot, str(tmp_path / "vp.pt"))
    assert_same(want, got)
    assert want["phase_epochs"] == {"eeg": 1, "fusion_arousal": 3, "valence": 1}


# --------------------------------------------------------------------------
# refusals and files
# --------------------------------------------------------------------------


def test_restore_refuses_another_configuration(data, tmp_path):
    """A generator saved on another device type, another ``early_stop`` or
    another moment dtype raise, and nothing is cast in; a file loads onto
    the CPU with ``map_location``."""
    vt = VectorizedLOSOTrainer(_model(0), data, N_SUBJECTS, EX_NUMS, batch_size=BATCH)
    path = vt.save_state(str(tmp_path / "a" / "loso.pt"))
    state = load_checkpoint(path, map_location="cpu")
    assert state["generator"]["device"] == "cpu" and state["tensors"]["params"].device.type == "cpu"
    state["generator"]["device"] = "cuda"
    save_checkpoint(str(tmp_path / "cuda.pt"), state)
    before = vt.params.clone()
    with pytest.raises(ValueError, match="cuda generator's state"):
        vt.restore_state(str(tmp_path / "cuda.pt"))
    with pytest.raises(ValueError, match="early_stop"):
        VectorizedLOSOTrainer(_model(0), data, N_SUBJECTS, EX_NUMS, batch_size=BATCH,
                              early_stop=True).restore_state(path)
    with pytest.raises(ValueError, match="opt.mu"):
        VectorizedLOSOTrainer(_model(0), data, N_SUBJECTS, EX_NUMS, batch_size=BATCH,
                              moment_dtype="bfloat16").restore_state(path)
    assert torch.equal(vt.params, before)
    mt = MultiTaskTrainer(_model(0), *_split(data), batch_size=BATCH, verbose=False)
    mt.save_state(str(tmp_path / "mt.pt"))
    state = load_checkpoint(str(tmp_path / "mt.pt"))
    state["generator"]["device"] = "cuda"
    save_checkpoint(str(tmp_path / "mt.pt"), state)
    with pytest.raises(ValueError, match="does not load into the trainer's cpu generator"):
        mt.restore_state(str(tmp_path / "mt.pt"))


def test_strip_module_prefix_only_when_every_key_has_it():
    t = torch.zeros(1)
    assert strip_module_prefix({"module.a": t, "module.b": t}).keys() == {"a", "b"}
    assert strip_module_prefix({"module.a": t, "b": t}).keys() == {"module.a", "b"}
    assert strip_module_prefix({}) == {}


def test_save_checkpoints_names_match_jax_and_load_strictly(data, tmp_path):
    """``save_checkpoints`` writes one file per subject, named as the JAX
    method names them from the same test accuracies (``.pt`` for
    ``.msgpack``), each a ``state_dict`` the flagship loads strictly."""
    from multimodal_sentiment_aanalysis_tpu.train import VectorizedPhasedTrainer as JaxVPT

    vt = VectorizedPhasedTrainer(_model(0), data, N_SUBJECTS, EX_NUMS, batch_size=BATCH,
                                 verbose=False)
    with pytest.raises(ValueError, match="no phase has run"):
        vt.save_checkpoints(str(tmp_path))
    vt.run_phase("valence", 1)
    paths = vt.save_checkpoints(str(tmp_path / "port"))
    jax_paths = JaxVPT.save_checkpoints(
        SimpleNamespace(n_subjects=N_SUBJECTS, _last_test=vt._last_test,
                        subject_variables=lambda sid: {"params": {"w": np.zeros(1)}}),
        str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p).removesuffix(".msgpack") + ".pt" for p in jax_paths]
    for sid, path in enumerate(paths):
        model = MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG)
        model.load_state_dict(torch.load(path, weights_only=True), strict=True)
        assert_same(model.state_dict(), vt.subject_variables(sid))


# --------------------------------------------------------------------------
# checks, seeding, timers
# --------------------------------------------------------------------------


def test_checkified_names_the_op_that_makes_a_nan():
    f = checkified(lambda x: torch.log(x - 2.0).sum())
    with pytest.raises(NonFiniteError, match=r"aten\.log.* produced a NaN"):
        f(torch.ones(3))
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NonFiniteError, match=r"aten\.div.* produced an Inf"):  # sqrt' at 0
        checkified(lambda: torch.sqrt(x).sum().backward())()
    assert float(f(torch.full((3,), 3.0))) == 0.0


def test_checkified_skips_uninitialised_allocations():
    """An allocation's contents are whatever the memory held: after a
    NaN-filled buffer is freed, ``torch.empty`` of its size often returns
    NaN bits. The audit does not read them, and still names the op that
    writes a NaN into such a tensor."""
    def fill_and_sum():
        y = torch.empty(32)
        z = y.new_empty_strided((32,), (1,))
        return y.copy_(torch.ones(32)).sum() + z.fill_(2.0).sum()

    for _ in range(20):
        buffer = torch.full((32,), float("nan"))
        del buffer
        assert float(checkified(fill_and_sum)()) == 96.0
    with pytest.raises(NonFiniteError, match=r"aten\.fill.* produced a NaN"):
        checkified(lambda: torch.empty(32).fill_(float("nan")))()


def test_checkified_epoch_is_bit_equal_and_catches_a_bad_weight(data):
    """A clean train epoch under the audit (forward, backward, AdamW)
    computes what the unaudited one does; an Inf weight raises at the first
    op that turns it into a NaN or an Inf."""
    train, test = _split(data)
    runs = []
    for audit in (False, True):
        t = Trainer(_model(0), train, test, batch_size=BATCH, seed=0, verbose=False)
        epoch = checkified(t.train_epoch) if audit else t.train_epoch
        runs.append((epoch(1), t.model.state_dict(), t.optimizer.state_dict()))
    assert_same(runs[0], runs[1])
    with torch.no_grad():
        t.model.eye_net.proj.weight[0, 0] = float("inf")
    with pytest.raises(NonFiniteError, match="produced"):
        checkified(t.test)()


def test_seed_all():
    np.random.seed(0)
    gen, rng = seed_all(5)
    assert gen.device.type == "cpu" and gen.initial_seed() == 5
    assert rng.random() == np.random.default_rng(5).random()
    assert np.random.random() == np.random.RandomState(5).random_sample()


def test_timers_on_the_cpu():
    calls = []
    seconds, out = timed(lambda x: calls.append(x) or torch.ones(2) * x, 3, iters=4, warmup=2)
    assert len(calls) == 6 and seconds >= 0 and torch.equal(out, torch.full((2,), 3.0))
    from multimodal_sentiment_aanalysis_tpu_torch.utils.timing import timed as best_of

    assert best_of(torch.ones, 3, reps=2) >= 0
    best, out = timed_out(torch.zeros, 2, reps=2)
    assert best >= 0 and out.shape == (2,)
    seen = []
    assert timed_fresh(lambda x: torch.tensor(x), lambda i: seen.append(i) or (i,), reps=3) >= 0
    assert seen == [0, 1, 2, 3]
    timer = StepTimer()
    for _ in range(3):
        with timer:
            pass
    assert len(timer.times) == 3 and timer.rate(64) > 0
    assert StepTimer().rate() == 0.0

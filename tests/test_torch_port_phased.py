"""The port's one-subject phased curriculum against the JAX package on the CPU.

Subject 0 held out of four subjects of eight trials from the synthetic
MAHNOB-HCI set (EEG cut to 16 steps), the flagship at feat_dim 16, batch 8,
``dropout=0.0``, both packages from the JAX ``MultiTaskTrainer``'s init
carried in through ``jax_import``:

- the phase masks: each phase's grad and update set against JAX
  ``module_mask`` leaf by leaf, and as the row's column ranges;
- one step of each phase on one batch against JAX ``make_phase_loss`` and
  the masked update (the JAX trainer's step, jitted once for all five
  phases), in the module form (``MultiTaskTrainer``) and the row form
  (``VectorizedPhasedTrainer``): the loss and metric sums within 1e-5
  relative, the clipped gradient on the grad set within 1e-4 of each
  tensor's largest entry plus 1e-6 of the grad set's largest entry (the
  ``eeg`` step's agree to 1.2e-5 of each tensor's largest; a conv bias
  before a BatchNorm has a gradient of float noise, covered by the second
  term), no gradient
  outside it (``None`` on the module, exact zeros in the row), the
  parameters after the step within 5 x lr (Adam's first step moves a
  weight by about lr * sign(g), and a gradient that is ~0 can flip that
  sign) and the BatchNorm running stats within 1e-5; ``valence`` at a
  clip norm that engages, where the fusion modules carry over 5% of the
  grad set's norm, so a clip over the valence head alone would fail;
- the curriculum (1, 1, 1, 2, 2) through the port's host loop and through
  ``fused_phases=True`` against the JAX trainer's host loop (the JAX
  package's own tests hold its fused phases equal to its host loop):
  every epoch's train and test metrics (losses within 1e-4 relative,
  accuracies equal), the final parameters within 5 x lr and BatchNorm stats
  within 2e-4 (``STATS_ATOL``: measured 8.6e-5);
- no EEG-encoder backward in the phases whose loss does not reach it, the
  refusals, a full-state checkpoint round trip, and the checkpoint and
  figure ``run(save=True, plot=True)`` writes.
"""

import numpy as np
import pytest
import torch

import jax

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset, loso_split
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
    RowLayout,
    VectorizedPhasedTrainer,
    apply_grad_mask,
    module_mask,
)
from test_torch_port_vloso import _tiny_arrays
from torch_parallel_ranks import one_rank_mesh  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N_SUBJECTS, EX_NUMS, BATCH, FEAT, T_EEG, LR = 4, 8, 8, 16, 16, 1e-4
CURRICULUM = (1, 1, 1, 2, 2)
# the one-step test's clip norms: valence's engages (its grad set's norm is
# ~0.2 on this batch)
CLIPS = {**{phase: 1.0 for phase in PHASE_ORDER}, "valence": 1e-3}
# BatchNorm running stats after the curriculum: a bias before a BatchNorm has
# an exact gradient of 0, and Adam moves it by about +-lr on float noise, in
# each package its own way; the running mean follows it (measured: 8.6e-5 at
# fusion.1.running_mean, after fusion.0.bias 1.4e-4 apart; 2.1e-5 in the EEG
# stem, whose near-saturated InfoNCE gradients are noise too)
STATS_ATOL = 2e-4


def _model(**kw) -> MultimodalTransformerModel:
    return MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG, dropout=0.0, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_trainer(arrays, init_sd, **kw) -> MultiTaskTrainer:
    tr, te = loso_split(N_SUBJECTS, EX_NUMS, 0)
    full = DeviceDataset(arrays, "cpu")
    mt = MultiTaskTrainer(_model(), full.subset(tr), full.subset(te), batch_size=BATCH, seed=0,
                          verbose=False, **kw)
    mt.model.load_state_dict(init_sd)
    return mt


@pytest.fixture(scope="module")
def arrays():
    return _tiny_arrays()


@pytest.fixture(scope="module")
def jax_run(arrays):
    """The JAX ``MultiTaskTrainer`` through the curriculum's host loop; its
    init as the port's ``state_dict``."""
    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
    from multimodal_sentiment_aanalysis_tpu.train import MultiTaskTrainer as JaxMTT

    tr, te = loso_split(N_SUBJECTS, EX_NUMS, 0)
    full = JaxDataset(arrays)
    jt = JaxMTT(jmodels.MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG, dropout=0.0),
                full.subset(tr), full.subset(te), batch_size=BATCH, seed=0, verbose=False)
    init = phased_state_from_jax(_np(jt.params), _np(jt.batch_stats))
    jt.run(*CURRICULUM, save=False, plot=False)
    return jt, init


@pytest.fixture(scope="module")
def port_runs(arrays, jax_run):
    """The port's curriculum through the host loop and through fused
    phases, from the JAX init."""
    _, init = jax_run
    runs = {}
    for fused in (False, True):
        mt = _port_trainer(arrays, init, fused_phases=fused)
        mt.run(*CURRICULUM, save=False, plot=False)
        runs[fused] = mt
    return runs


# --------------------------------------------------------------------------
# masks
# --------------------------------------------------------------------------


def test_phase_masks_match_jax_module_mask(jax_run):
    """Each phase's grad and update masks, by parameter, against JAX
    ``module_mask`` over the flax tree (carried to the port's names through
    ``jax_import``); the row's column ranges cover exactly those
    parameters."""
    from multimodal_sentiment_aanalysis_tpu.train.state import module_mask as jax_module_mask

    jt, init = jax_run
    params, stats = _np(jt.params), _np(jt.batch_stats)
    layout = RowLayout(_model())
    bounds = np.cumsum([0, *layout.sizes])
    for phase, spec in PHASES.items():
        for modules in (spec.grad_modules, spec.update_modules):
            as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                     jax_module_mask(params, modules), params)
            want = phased_state_from_jax(as_arrays, stats)
            got = module_mask(layout.names, modules)
            assert set(got) == {n for n in want if n in got} == set(layout.names)
            for name, flag in got.items():
                assert torch.all(want[name] == float(flag)), (phase, name)
            cols = np.zeros(bounds[-1], bool)
            for a, b in layout.columns(modules):
                cols[a:b] = True
            for name, a, b in zip(layout.names, bounds[:-1], bounds[1:]):
                assert cols[a:b].all() == got[name] and cols[a:b].any() == got[name], name
    # phase 3: the fusion modules in the grad set, only the valence head updated
    valence = module_mask(layout.names, PHASES["valence"].grad_modules)
    assert valence["fusion.0.weight"] and valence["attention_weights.2.bias"]
    assert layout.columns(PHASES["valence"].update_modules) == layout.columns({"valence_head"})


# --------------------------------------------------------------------------
# one step of each phase
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_step(arrays, jax_run):
    """One JAX step of every phase from the init on the first train batch
    (the JAX trainer's step body, jitted once for all five phases): loss,
    metric sums, BatchNorm stats, clipped gradients and the updated
    parameters, each as the port's ``state_dict``."""
    import jax.numpy as jnp
    import optax

    from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
        variables_from_torch_state_dict,
    )
    from multimodal_sentiment_aanalysis_tpu.train.multitask import make_phase_loss
    from multimodal_sentiment_aanalysis_tpu.train.state import (
        clip_by_global_norm,
        make_masked_adamw,
        module_mask as jax_module_mask,
        set_learning_rate,
        zero_masked_grads,
    )

    jt, init = jax_run
    model = jt.model
    tr, _ = loso_split(N_SUBJECTS, EX_NUMS, 0)
    rows = tr[:BATCH]
    batch = {k: jnp.asarray(v[rows]) for k, v in arrays.items()}
    batch["mask"] = jnp.ones(BATCH, jnp.float32)
    v0 = variables_from_torch_state_dict({k: t.numpy() for k, t in init.items()})
    params0 = jax.tree.map(jnp.asarray, v0["params"])
    stats0 = jax.tree.map(jnp.asarray, v0["batch_stats"])

    def steps(params, batch_stats, batch, key):
        out = {}
        for phase, spec in PHASES.items():
            grad_mask = jax_module_mask(params, spec.grad_modules)
            update_mask = jax_module_mask(params, spec.update_modules)
            tx = make_masked_adamw(update_mask, 1e-4)
            (loss, (new_bs, metrics)), grads = jax.value_and_grad(
                make_phase_loss(model, spec.loss), has_aux=True)(params, batch_stats, batch, key)
            grads = zero_masked_grads(grads, grad_mask)
            grads, norm = clip_by_global_norm(grads, CLIPS[phase])
            updates, _ = tx.update(zero_masked_grads(grads, update_mask),
                                   set_learning_rate(tx.init(params), LR), params)
            new = optax.apply_updates(params, zero_masked_grads(updates, update_mask))
            out[phase] = {"loss": loss, "metrics": metrics, "stats": new_bs, "grads": grads,
                          "norm": norm, "params": new}
        return out

    out = _np(jax.jit(steps)(params0, stats0, batch, jax.random.key(0)))
    result = {}
    for phase, o in out.items():
        result[phase] = {
            "metrics": np.array([o["metrics"][k] for k in (*METRIC_KEYS, "n")]),
            "norm": float(o["norm"]),
            "grads": phased_state_from_jax(o["grads"], o["stats"]),
            "after": phased_state_from_jax(o["params"], o["stats"]),
        }
    return init, rows, result


def _check_step(phase, want, sums, grads, after, grad_names):
    """One port step against the JAX step: ``grads`` maps every parameter
    name to its clipped gradient (None where none was taken)."""
    np.testing.assert_allclose(np.asarray(sums), want["metrics"], rtol=1e-5, atol=0,
                               err_msg=phase)
    scale = max(float(want["grads"][n].abs().max()) for n in grad_names)
    for name, g in grads.items():
        if name in grad_names:
            ref = want["grads"][name]
            atol = 1e-4 * float(ref.abs().max()) + 1e-6 * scale
            np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{phase} {name}")
        else:
            assert g is None or not bool(g.any()), f"{phase} {name}: gradient outside the grad set"
            assert not bool(want["grads"][name].any())
    for name, t in after.items():
        if "num_batches" in name:
            continue
        atol = 1e-5 if "running" in name else 5 * LR
        np.testing.assert_allclose(t.numpy(), want["after"][name].numpy(), rtol=0, atol=atol,
                                   err_msg=f"{phase} {name}")


def test_valence_clip_engages_over_the_fusion_modules(one_step):
    """The valence step's clip engages, and the fusion modules carry over
    5% of its grad set's norm: clipping over the update set alone would
    scale the valence head's gradient differently."""
    _, _, result = one_step
    want = result["valence"]
    assert want["norm"] > CLIPS["valence"]
    layout = RowLayout(_model())
    grad_set = module_mask(layout.names, PHASES["valence"].grad_modules)
    head = module_mask(layout.names, PHASES["valence"].update_modules)
    sq = lambda mask: sum(float((want["grads"][n].double() ** 2).sum())
                          for n, m in mask.items() if m)
    assert np.sqrt(sq(grad_set) / sq(head)) > 1.05


def test_one_step_of_each_phase_module_form_matches_jax(arrays, one_step):
    init, rows, result = one_step
    mt = _port_trainer(arrays, init)
    batch = mt.train_data.gather(np.arange(BATCH))  # the subset's first rows: tr[:BATCH]
    batch["mask"] = torch.ones(BATCH)
    for phase in PHASE_ORDER:
        mt.model.load_state_dict(init)
        mt.clip_norm = CLIPS[phase]
        opt = mt._optimizer(phase, LR)
        mt.model.train()
        apply_grad_mask(mt.model, mt._masks(phase)[0])
        sums = mt._train_step(phase, batch, opt)
        grads = {n: p.grad for n, p in mt.model.named_parameters()}
        grad_names = {n for n, p in mt.model.named_parameters() if p.requires_grad}
        apply_grad_mask(mt.model, {n: True for n in grads})
        _check_step(phase, result[phase], sums, grads, mt.model.state_dict(), grad_names)


def test_one_step_of_each_phase_row_form_matches_jax(arrays, one_step):
    """Every model of a 4-subject phased trainer from the JAX init, each
    on the same batch, steps as the JAX step does."""
    init, rows, result = one_step
    vt = VectorizedPhasedTrainer(_model(), DeviceDataset(arrays, "cpu"), N_SUBJECTS, EX_NUMS,
                                 batch_size=BATCH, seed=0, verbose=False)
    stacked = {k: t.expand(N_SUBJECTS, *t.shape) for k, t in init.items()}
    idx = torch.as_tensor(np.broadcast_to(rows, (N_SUBJECTS, BATCH)).copy())
    for phase in PHASE_ORDER:
        vt.load_stacked_state(stacked)
        vt.clip_norm = CLIPS[phase]
        vt.opt = vt._phase_optimizer(phase)
        batch = vt._gather(idx)
        batch["mask"] = torch.ones(N_SUBJECTS, BATCH)
        vt.model.train()
        grads, sums = vt._clipped_grads(phase, batch)
        vt.opt.step(vt.params, grads)
        grad_names = {n for n, m in module_mask(vt.layout.names,
                                                PHASES[phase].grad_modules).items() if m}
        views = vt.layout.params(grads)
        for s in range(N_SUBJECTS):
            after = {k: v for k, v in vt.subject_variables(s).items()}
            _check_step(phase, result[phase], sums[s], {n: v[s] for n, v in views.items()},
                        after, grad_names)


# --------------------------------------------------------------------------
# the curriculum
# --------------------------------------------------------------------------


def _check_metrics(got: dict, want: dict, label: str):
    for split in ("train", "test"):
        assert len(got[split]["loss"]) == len(want[split]["loss"]) == sum(CURRICULUM)
        for k in METRIC_KEYS:
            g, w = np.asarray(got[split][k]), np.asarray(want[split][k])
            if k.endswith("acc"):
                np.testing.assert_array_equal(g, w, err_msg=f"{label} {split} {k}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=0,
                                           err_msg=f"{label} {split} {k}")


def _check_state(model, jt, label: str):
    want = phased_state_from_jax(_np(jt.params), _np(jt.batch_stats))
    for name, t in model.state_dict().items():
        if "num_batches" in name:
            continue
        atol = STATS_ATOL if "running" in name else 5 * LR
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=atol,
                                   err_msg=f"{label} {name}")


@pytest.mark.parametrize("fused", [False, True], ids=["host_loop", "fused_phases"])
def test_curriculum_matches_jax(jax_run, port_runs, fused):
    jt, _ = jax_run
    mt = port_runs[fused]
    _check_metrics(mt.metrics, jt.metrics, "fused" if fused else "host loop")
    _check_state(mt.model, jt, "fused" if fused else "host loop")
    assert mt.schedulers.keys() == jt.schedulers.keys()
    for phase, sched in mt.schedulers.items():
        assert sched.lr == jt.schedulers[phase].lr and sched.patience == \
            jt.schedulers[phase].patience


# --------------------------------------------------------------------------
# port only
# --------------------------------------------------------------------------


def spy_calls(monkeypatch, module, name: str) -> list:
    """Every call of ``module.name`` appends its first argument's shape."""
    calls, fn = [], getattr(module, name)

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_phases_outside_the_eeg_loss_run_no_eeg_backward(monkeypatch, arrays):
    """A module-form step runs the stem tail's backward (the EEG encoder's
    first layers) only in the phases whose loss reaches the EEG encoder:
    elsewhere autograd records no node of the encoder."""
    calls = spy_calls(monkeypatch, conv_stem_train, "stem_tail_bwd_plain")
    tr, te = loso_split(N_SUBJECTS, EX_NUMS, 0)
    full = DeviceDataset(arrays, "cpu")
    mt = MultiTaskTrainer(_model(), full.subset(tr), full.subset(te), batch_size=BATCH,
                          seed=0, verbose=False)
    batch = mt.train_data.gather(np.arange(BATCH))
    batch["mask"] = torch.ones(BATCH)
    for phase in PHASE_ORDER:
        calls.clear()
        mt.model.train()
        apply_grad_mask(mt.model, mt._masks(phase)[0])
        mt._train_step(phase, batch, mt._optimizer(phase, LR))
        assert len(calls) == (2 if phase in ("eeg", "fusion_arousal") else 0), phase


def test_refusals_and_checkpoint(arrays, tmp_path, one_rank_mesh):
    """Under a one-rank mesh an epoch and an evaluation are the one-process
    trainer's, bit for bit; fused phases without the optimizer reset raise;
    a full-state checkpoint round trip leaves the trainer as it was;
    ``run(save=True, plot=True)`` writes the model's ``state_dict`` under
    the metrics-encoded name and the progress figure."""
    tr, te = loso_split(N_SUBJECTS, EX_NUMS, 0)
    full = DeviceDataset(arrays, "cpu")
    train, test = full.subset(tr), full.subset(te)
    runs = []
    for mesh in (one_rank_mesh, None):
        t = MultiTaskTrainer(_model(), train, test, batch_size=BATCH, seed=0, verbose=False,
                             mesh=mesh)
        runs.append((t.train_epoch_phase("fusion_arousal"), t.evaluate(), t.model.state_dict()))
    assert runs[0][:2] == runs[1][:2]
    for k, v in runs[1][2].items():
        assert torch.equal(runs[0][2][k], v), k
    mt = MultiTaskTrainer(_model(), train, test, test_person=0, batch_size=BATCH, seed=0,
                          checkpoint_dir=str(tmp_path), verbose=False)
    before = {n: t.clone() for n, t in mt.model.state_dict().items()}
    mt.restore_state(mt.save_state(str(tmp_path / "states" / "mt.pt")))
    for name, t in mt.model.state_dict().items():
        assert torch.equal(before[name], t), name
    no_reset = MultiTaskTrainer(_model(), train, test, batch_size=BATCH,
                                reset_optimizer_each_epoch=False, fused_phases=True,
                                verbose=False)
    assert no_reset.fused_phases is False
    with pytest.raises(ValueError, match="reset_optimizer_each_epoch"):
        no_reset.run_phase_fused("eeg", 1)
    assert mt.run_phase_fused("eeg", 0) == {}
    test_m = mt.run(0, 0, 0, 0, 1, save=True, plot=True)
    name = f"TestPerson0_ArousalAcc{test_m['a_acc']:.4f}_ValenceAcc{test_m['v_acc']:.4f}.pt"
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [name, "TestPerson0_progress.png", "states"])
    assert (tmp_path / "TestPerson0_progress.png").stat().st_size > 0
    path = tmp_path / name
    model = _model()
    model.load_state_dict(torch.load(path), strict=True)
    for name, t in mt.model.state_dict().items():
        assert torch.equal(model.state_dict()[name], t)

"""The port's training slice against the JAX package on the CPU.

- the flagship model in train mode at ``dropout=0.0`` (weights carried in
  through ``jax_import``): outputs, the three contrastive terms, every
  parameter gradient and the BatchNorm running stats after the step,
  against ``jax.value_and_grad`` of ``model.apply(..., train=True,
  mutable=["batch_stats"])``. Outputs 1e-4 absolute; gradients rtol 1e-3
  with atol 1e-4 (the temperature's gradient is ~1e3 at temperature 0.01,
  and the bias of a Linear feeding a BatchNorm has a true gradient of 0,
  so both sides hold rounding noise of ~1e-6 there); running stats 1e-5.
- the port's ``Trainer`` against the JAX ``Trainer`` from one initial state
  on the same tiny LOSO split for 2 epochs: per-epoch train and test
  losses within 1e-4 relative, and the parameters at the end within 5 x lr
  (Adam's first steps move each weight by about lr * sign(g), so a
  gradient that is ~0 on one side can flip that sign; 5 x lr bounds a few
  such flips per weight over the 4 steps);
- ``Trainer.test_with_loaded_model`` against the JAX ``Trainer``'s on the
  same saved weights: the four numbers within 1e-4 relative and the same
  summary line;
- the NaN skip in both packages, one AdamW step against optax, the data
  copies, and the dropout sites.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
    variables_from_torch_state_dict,
)
from multimodal_sentiment_aanalysis_tpu_torch.data import (
    DeviceDataset,
    assemble_features,
    loso_split,
    make_synthetic_hci_data,
)
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MultimodalTransformerModel,
    state_dict_from_jax_variables,
    trainer_state_from_jax,
)
from multimodal_sentiment_aanalysis_tpu_torch.models.layers import TransformerEncoderLayer
from multimodal_sentiment_aanalysis_tpu_torch.train import Trainer

from test_torch_port_models import inputs, jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F_TINY, T_TINY, B = 32, 64, 16


def _tree(tree):
    return {jax.tree_util.keystr(k): np.asarray(x)
            for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grad_tree(model) -> dict:
    """Parameter gradients of a port model as the JAX params tree."""
    sd = {**model.state_dict(), **{n: p.grad for n, p in model.named_parameters()}}
    return _tree(variables_from_torch_state_dict(sd)["params"])


def _batch_labels(b, seed):
    rng = np.random.default_rng(seed)
    arousal, valence = rng.integers(0, 3, b), rng.integers(0, 3, b)
    arousal[0] = 3  # a label that occurs once: its InfoNCE row has no positive
    mask = np.ones(b, np.float32)
    mask[-3:] = 0.0  # wrap-padded rows
    return arousal, valence, mask


# --------------------------------------------------------------------------
# the model in train mode
# --------------------------------------------------------------------------


def one_train_step(feat_dim: int, eeg_time: int, b: int):
    """One train-mode step of both models on the same weights and batch:
    ``(port model after backward, port outputs, JAX outputs, JAX gradients,
    JAX batch stats after the step)``."""
    v = jax_variables(feat_dim, eeg_time, seed=0)
    x = inputs(b, eeg_time, seed=1)
    arousal, valence, mask = _batch_labels(b, 2)
    rng = np.random.default_rng(3)
    wa, wv = (rng.normal(size=(b, 3)).astype(np.float32) for _ in range(2))
    model = jmodels.MultimodalTransformerModel(feat_dim=feat_dim, eeg_time=eeg_time, dropout=0.0)

    def loss_fn(params):
        outs, mutated = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, *x,
            labels=(jnp.asarray(arousal), jnp.asarray(valence), jnp.asarray(mask)),
            train=True, mutable=["batch_stats"])
        a, val, c1, c2, c3 = outs
        return jnp.sum(a * wa) + jnp.sum(val * wv) + c1 + 2 * c2 + 3 * c3, (outs, mutated)

    (_, (ref_outs, mutated)), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])

    port = MultimodalTransformerModel(feat_dim=feat_dim, eeg_time=eeg_time, dropout=0.0)
    port.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    port.train()
    outs = port(*map(torch.from_numpy, x), labels=tuple(map(torch.from_numpy,
                                                            (arousal, valence, mask))))
    a, val, c1, c2, c3 = outs
    ((a * torch.from_numpy(wa)).sum() + (val * torch.from_numpy(wv)).sum()
     + c1 + 2 * c2 + 3 * c3).backward()
    return port, outs, ref_outs, ref_grads, mutated["batch_stats"]


def check_gradients(port, ref_grads) -> None:
    got, want = _grad_tree(port), _tree(ref_grads)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4, err_msg=k)


def check_running_stats(port, ref_stats) -> None:
    got = _tree(variables_from_torch_state_dict(port.state_dict())["batch_stats"])
    want = _tree(ref_stats)
    assert got.keys() == want.keys() and len(want) == 18
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def train_step():
    return one_train_step(F_TINY, T_TINY, B)


def test_train_mode_outputs_match_jax(train_step):
    _, outs, ref_outs, _, _ = train_step
    assert len(outs) == len(ref_outs) == 5
    for got, ref in zip(outs, ref_outs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_train_mode_gradients_match_jax(train_step):
    port, _, _, ref_grads, _ = train_step
    check_gradients(port, ref_grads)


def test_bn_running_stats_after_train_step_match_jax(train_step):
    """Every BatchNorm (stem and trunks) moves its running stats by the JAX
    rule: momentum 0.1 toward the batch mean and the *biased* variance."""
    port, _, _, _, ref_stats = train_step
    check_running_stats(port, ref_stats)


def test_eval_forward_records_gradients():
    """The eval forward is differentiable (it once ran under no_grad), and
    the labels branch works in eval mode, as the trainer's test loss needs."""
    port = MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY).eval()
    x = map(torch.from_numpy, inputs(4, T_TINY))
    outs = port(*x, labels=(torch.tensor([0, 1, 0, 1]), torch.tensor([2, 2, 0, 1])))
    assert len(outs) == 5 and all(o.requires_grad for o in outs)
    sum(o.sum() for o in outs).backward()
    assert all(p.grad is not None for p in port.parameters())


# --------------------------------------------------------------------------
# dropout
# --------------------------------------------------------------------------


def test_transformer_layer_dropout_sites():
    """Three sites (attention output, feed-forward hidden, feed-forward
    output), masks drawn in that order from the generator; none in eval."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(8, 2, 12, dropout=0.3)
    torch.nn.init.xavier_uniform_(layer.self_attn.in_proj_weight)
    x = torch.randn(5, 1, 8)
    layer.eval()
    plain = layer(x)
    layer.train()
    got = layer(x, torch.Generator().manual_seed(4))
    assert torch.equal(got, layer(x, torch.Generator().manual_seed(4)))
    assert not torch.allclose(got, plain)

    gen = torch.Generator().manual_seed(4)
    drop = lambda t: torch.where(torch.rand(t.shape, generator=gen) >= 0.3, t / 0.7, 0.0)
    h = layer.norm1(x + drop(layer.self_attn(x, x, x)))
    ff = layer.linear2(drop(torch.relu(layer.linear1(h))))
    torch.testing.assert_close(got, layer.norm2(h + drop(ff)), rtol=0, atol=0)
    layer.eval()
    torch.testing.assert_close(layer(x, torch.Generator().manual_seed(4)), plain, rtol=0, atol=0)


def test_model_dropout_rates():
    """Reference rates (EEG stem 0.4, the rest 0.3) unless overridden."""
    rates = lambda m: sorted({mod.dropout for mod in m.modules()
                              if isinstance(mod, TransformerEncoderLayer)}
                             | {mod.p for mod in m.modules() if isinstance(mod, torch.nn.Dropout)})
    assert rates(MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY)) == [0.3, 0.4]
    assert rates(MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY,
                                            dropout=0.1)) == [0.1]
    port = MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY).train()
    x = list(map(torch.from_numpy, inputs(4, T_TINY)))
    a1 = port(*x, generator=torch.Generator().manual_seed(1))[0]
    a2 = port(*x, generator=torch.Generator().manual_seed(1))[0]
    a3 = port(*x, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)


# --------------------------------------------------------------------------
# the slice: Trainer against Trainer
# --------------------------------------------------------------------------

N_SUBJECTS, EX_NUMS, TINY_BATCH, EPOCHS = 3, 8, 8, 2


def _tiny_arrays():
    """``cli.py:_load_arrays`` with ``--tiny``, from the port's data copies."""
    data = make_synthetic_hci_data(seed=5, n_subjects=N_SUBJECTS, ex_nums=EX_NUMS)
    feats, _ = assemble_features(data, ["eeg", "eye", "pps"], norm="Z_score",
                                 label_type="arousal")
    return {
        "eeg": np.ascontiguousarray(feats["eeg"].astype(np.float32)[:, :, :T_TINY]),
        "eye": feats["eye"].astype(np.float32),
        "pps": feats["pps"].astype(np.float32),
        "arousal": np.asarray(data["arousal_label"]).astype(np.int64),
        "valence": np.asarray(data["valence_label"]).astype(np.int64),
    }


@pytest.fixture(scope="module")
def trainers():
    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
    from multimodal_sentiment_aanalysis_tpu.train import Trainer as JaxTrainer

    arrays = _tiny_arrays()
    tr_idx, te_idx = loso_split(N_SUBJECTS, EX_NUMS, 1)
    kw = dict(batch_size=TINY_BATCH, seed=0, verbose=False)
    jfull = JaxDataset(arrays)
    jt = JaxTrainer(jmodels.MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY,
                                                       dropout=0.0),
                    jfull.subset(tr_idx), jfull.subset(te_idx), **kw)
    sd, cw = trainer_state_from_jax(jax.tree.map(np.asarray, jt.params),
                                    jax.tree.map(np.asarray, jt.batch_stats))
    port = MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY, dropout=0.0)
    port.load_state_dict(sd, strict=True)
    full = DeviceDataset(arrays, "cpu")
    pt = Trainer(port, full.subset(tr_idx), full.subset(te_idx), **kw)
    with torch.no_grad():
        pt.contrastive_weight.copy_(cw)
    history = {"jax": [], "port": []}
    for epoch in range(1, EPOCHS + 1):
        for name, t in (("jax", jt), ("port", pt)):
            history[name].append((t.train_epoch(epoch), t.test()))
    return jt, pt, history


def test_trainer_epoch_losses_match_jax(trainers):
    _, _, history = trainers
    for (jtr, jte), (ptr, pte) in zip(history["jax"], history["port"]):
        np.testing.assert_allclose(ptr, jtr, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(pte, jte, rtol=1e-4, atol=1e-5)


def test_trainer_parameters_after_training_match_jax(trainers):
    jt, pt, _ = trainers
    lr = 1e-4
    got = _tree(variables_from_torch_state_dict(pt.model.state_dict()))
    want = _tree({"params": jt.params["model"], "batch_stats": jt.batch_stats})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5 * lr, err_msg=k)
    np.testing.assert_allclose(pt.contrastive_weight.detach().numpy(),
                               np.asarray(jt.params["trainer"]["contrastive_weight"]),
                               rtol=0, atol=5 * lr)


def test_test_with_loaded_model_matches_jax(trainers, tmp_path, capsys):
    """Both trainers re-evaluate the same saved weights (the JAX trainer's
    own, as msgpack and as a reference-named ``.pt``): the four numbers
    within 1e-4 relative and the same summary line. The port trainer's
    full state is saved before and restored after, so the test leaves it as
    it found it; ``report=True`` adds the Tester's report and figures."""
    from multimodal_sentiment_aanalysis_tpu.utils.checkpoint import save_checkpoint

    jt, pt, _ = trainers
    variables = {"params": jt.params["model"], "batch_stats": jt.batch_stats}
    save_checkpoint(str(tmp_path / "best_model.msgpack"), variables)
    torch.save(state_dict_from_jax_variables(jax.tree.map(np.asarray, variables)),
               tmp_path / "best_model.pt")
    line = "Test Loss: {:.4f}, CE Loss: {:.4f}, Contrastive Loss: {:.4f}, Acc: {:.4f}\n"
    pt.save_state(str(tmp_path / "state.pt"))
    checkpoint_dir, pt.checkpoint_dir = pt.checkpoint_dir, str(tmp_path)
    try:
        want = jt.test_with_loaded_model(str(tmp_path / "best_model.msgpack"))
        assert capsys.readouterr().out == line.format(*want)
        got = pt.test_with_loaded_model(str(tmp_path / "best_model.pt"))
        assert capsys.readouterr().out == line.format(*got)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        assert pt.test_with_loaded_model(str(tmp_path / "best_model.pt"), report=True) == got
        assert "precision    recall  f1-score   support" in capsys.readouterr().out
        assert (tmp_path / "confusion_arousal.png").stat().st_size > 0
    finally:
        pt.checkpoint_dir = checkpoint_dir
        pt.restore_state(str(tmp_path / "state.pt"))


def test_nan_loss_skips_the_batch_in_both_packages(trainers):
    """A batch with an inf in the EEG leaves params, optimizer state and BN
    running stats as they were, in the JAX trainer and in the port's."""
    jt, pt, _ = trainers
    bad_row = 2
    # JAX: the jitted epoch over a one-batch plan holding the bad row
    arrays = dict(jt.train_data.arrays)
    arrays["eeg"] = arrays["eeg"].at[bad_row, 0, 0].set(jnp.inf)
    plan = jnp.asarray(np.arange(TINY_BATCH, dtype=np.int32)[None])
    out = jt._train_epoch_fn(jt.params, jt.batch_stats, jt.opt_state, jt.dropout_seed, arrays,
                             plan, jnp.ones((1, TINY_BATCH), jnp.float32))
    for before, after in ((jt.params, out[0]), (jt.batch_stats, out[1]),
                          (jt.opt_state, out[2])):
        for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(out[4]["n"]) == 0.0

    # port: one train step on the same batch
    batch = pt.train_data.gather(torch.arange(TINY_BATCH))
    batch["eeg"][bad_row, 0, 0] = float("inf")
    snap = copy.deepcopy((pt.model.state_dict(), pt.optimizer.state_dict(),
                          pt.contrastive_weight.detach()))
    pt.model.train()
    sums = pt._train_step(batch, torch.ones(TINY_BATCH))
    assert torch.equal(sums, torch.zeros(6))
    after = (pt.model.state_dict(), pt.optimizer.state_dict(), pt.contrastive_weight.detach())
    for k, v in snap[0].items():
        assert torch.equal(v, after[0][k]), k
    for k, st in snap[1]["state"].items():
        for name, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(after[1]["state"][k][name]))
    assert torch.equal(snap[2], after[2])


def test_trainer_run_saves_best_state_dict(tmp_path):
    """``run`` drives the plateau schedule and early stopping and saves the
    best model as a reference-named ``state_dict`` that loads strictly."""
    arrays = _tiny_arrays()
    tr_idx, te_idx = loso_split(N_SUBJECTS, EX_NUMS, 0)
    full = DeviceDataset(arrays, "cpu")
    model = MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY,
                                       generator=torch.Generator().manual_seed(1))
    t = Trainer(model, full.subset(tr_idx), full.subset(te_idx), batch_size=TINY_BATCH,
                patience=1, checkpoint_dir=str(tmp_path), verbose=False)
    t.run(epochs=3, test_person=0)
    assert 1 <= len(t.test_loss) <= 3 and all(np.isfinite(t.train_loss))
    fresh = MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY)
    fresh.load_state_dict(torch.load(tmp_path / "best_model.pt"), strict=True)


# --------------------------------------------------------------------------
# optimizer and data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("foreach", [False, True])
def test_adamw_steps_match_optax(foreach):
    import optax

    from multimodal_sentiment_aanalysis_tpu_torch.train import make_adamw

    rng = np.random.default_rng(12)
    params = [rng.normal(size=s).astype(np.float32) for s in [(4, 3), (5,), ()]]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params] for _ in range(3)]
    tx = optax.adamw(1e-4, weight_decay=0.01)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = make_adamw([{"params": tp}], 1e-4, 0.01)
    for g in opt.param_groups:
        g["foreach"] = foreach
    for step in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, step):
            p.grad = torch.from_numpy(g)
        opt.step()
    for p, r in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=1e-6, atol=1e-8)


def test_data_copies_match_jax():
    from multimodal_sentiment_aanalysis_tpu.data import assemble_features as jax_assemble
    from multimodal_sentiment_aanalysis_tpu.data import loso_split as jax_loso
    from multimodal_sentiment_aanalysis_tpu.data import make_synthetic_hci_data as jax_make

    for kw in ({"seed": 42}, {"seed": 7, "n_subjects": 3, "ex_nums": 8}):
        got, want = make_synthetic_hci_data(**kw), jax_make(**kw)
        assert got.keys() == want.keys()
        for m in ("eeg", "eye", "pps"):
            np.testing.assert_array_equal(got["features"][m], want["features"][m])
        for k in ("arousal_label", "valence_label", "subject_list"):
            np.testing.assert_array_equal(got[k], want[k])
        for norm in ("Z_score", "Min_Max", None):
            gf, gl = assemble_features(got, ["eeg", "eye", "pps"], norm=norm)
            wf, wl = jax_assemble(want, ["eeg", "eye", "pps"], norm=norm)
            for m in wf:
                assert gf[m].dtype == wf[m].dtype
                np.testing.assert_array_equal(gf[m], wf[m])
            np.testing.assert_array_equal(gl, wl)
    for sid in (0, 5, 23):
        for g, w in zip(loso_split(24, 20, sid), jax_loso(24, 20, sid)):
            np.testing.assert_array_equal(g, w)


def test_device_dataset_epoch_plan_matches_jax():
    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset

    arrays = {"x": np.arange(21, dtype=np.float32)}
    ours, theirs = DeviceDataset(arrays, "cpu"), JaxDataset(arrays)
    for shuffle in (True, False):
        got = ours.epoch_plan(8, np.random.default_rng(1), shuffle)
        want = theirs.epoch_plan(8, np.random.default_rng(1), shuffle)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = list(ours.batches(8, np.random.default_rng(2)))
    want = list(theirs.batches(8, np.random.default_rng(2)))
    assert len(got) == len(want) == 3
    for (gb, gm), (wb, wm) in zip(got, want):
        np.testing.assert_array_equal(gb["x"].numpy(), np.asarray(wb["x"]))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))

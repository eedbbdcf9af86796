"""The port's vectorized SimCLR trainer against the JAX package on the CPU.

``tests/test_vsimclr.py``'s size: 4 subjects x 8 trials (EEG (32, 64)),
``MultiModalEncoder(feat_dim=32)``, ``ProjectionHead(in_dim=32)``,
``Classifier(in_dim=32)``, batch 8, every dropout 0 for parity. Both
trainers start from the JAX trainer's stacked init (``vmap(init_one)``,
carried in through ``jax_import.simclr_state_from_jax``):

- the LOSO and pair tables, and both kinds of plans (all pretrain epochs
  drawn first, then the finetune epochs), bit-equal to JAX's;
- ``pretrain(2)``: the per-epoch ``(S,)`` losses within 1e-4 relative, every
  subject's encoder and projector within 5 x lr and BatchNorm stats within
  1e-5, but for the biases before a BatchNorm and the running means after
  them (``test_torch_port_simclr.NOISE_PARAMS``, whose exact gradient is 0:
  2 x lr x steps and ``NOISE_MEAN_ATOL``); the pretrain runs at lr 1e-4, as
  ``test_torch_port_simclr.py`` says why;
- ``finetune(2)``: the per-subject accuracies equal, the classifiers within
  5 x lr, the encoder and projector rows bit-unchanged;
- no coupling between subjects: another plan for the last subject leaves
  the others' epoch bit for bit as it was (JAX's
  ``test_no_cross_subject_coupling``), and a step of all S models equals the
  step on each subject's sliced state; a vectorized step against the
  sequential engine's step of one subject;
- with dropout on: the two views draw different masks, the finetune leaves
  the pair row and its BatchNorm stats bit-unchanged; ``mesh=`` raises;
- on a card (``gpu``, skipped here): each epoch's launches for all models at
  once, no host sync, the frozen row. The module imports no JAX at load, so
  that the card's test runs without it:
  ``python -m pytest --noconftest -m gpu tests/test_torch_port_vsimclr.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    Classifier,
    MultiModalEncoder,
    ProjectionHead,
    simclr_state_from_jax,
)
from multimodal_sentiment_aanalysis_tpu_torch.train import VectorizedSimCLRTrainer
from multimodal_sentiment_aanalysis_tpu_torch.train.simclr import pretrain_step
from torch_parallel_ranks import one_rank_mesh  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F, T_EEG, B, N_SUBJECTS, EX_NUMS = 32, 64, 8, 4, 8
PRETRAIN_LR, FINETUNE_LR, EPOCHS = 1e-4, 1e-4, 2


def _trio(dropout: float = 0.0, device=None):
    return (MultiModalEncoder(F, eeg_time=T_EEG, dropout=0.4 if dropout else 0.0, device=device),
            ProjectionHead(F, dropout=dropout, device=device),
            Classifier(F, dropout=dropout, device=device))


def _port(arrays, dropout: float = 0.0, device="cpu", **kw) -> VectorizedSimCLRTrainer:
    kw = dict(batch_size=B, pretrain_lr=PRETRAIN_LR, verbose=False, **kw)
    return VectorizedSimCLRTrainer(*_trio(dropout, device), DeviceDataset(arrays, device),
                                   N_SUBJECTS, EX_NUMS, **kw)


def _arrays():
    from test_torch_port_simclr import tiny_arrays

    return tiny_arrays()


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _jax_state(jt):
    return simclr_state_from_jax(_np(jt.params), _np(jt.batch_stats), _np(jt.clf_params))


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.fixture(scope="module")
def runs(arrays):
    """Both trainers from JAX's stacked init through pretrain(2) and
    finetune(2), with the states after each stage."""
    from multimodal_sentiment_aanalysis_tpu import models as jm
    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
    from multimodal_sentiment_aanalysis_tpu.train import VectorizedSimCLRTrainer as JaxVSimCLR

    jt = JaxVSimCLR(jm.MultiModalEncoder(feat_dim=F, eeg_time=T_EEG, dropout=0.0),
                    jm.ProjectionHead(in_dim=F, dropout=0.0), jm.Classifier(in_dim=F, dropout=0.0),
                    JaxDataset(arrays), N_SUBJECTS, EX_NUMS, batch_size=B,
                    pretrain_lr=PRETRAIN_LR, verbose=False)
    pt = _port(arrays)
    pt.load_stacked_state(*_jax_state(jt))
    out = {"pre": (jt.pretrain(EPOCHS), pt.pretrain(EPOCHS))}
    out["pre_state"] = (_jax_state(jt), [pt.subject_variables(s) for s in range(N_SUBJECTS)])
    row = (pt.params.clone(), pt.stats.clone())
    out["ft"] = (jt.finetune(EPOCHS), pt.finetune(EPOCHS))
    out["ft_state"] = (_jax_state(jt), [pt.subject_variables(s) for s in range(N_SUBJECTS)])
    out["row_frozen"] = torch.equal(row[0], pt.params) and torch.equal(row[1], pt.stats)
    return jt, pt, out


def test_tables_bit_equal_to_jax(runs):
    jt, pt, _ = runs
    for name in ("train_idx", "test_idx", "n_pairs", "pair_idx", "pair_lab"):
        got, want = getattr(pt, name), np.asarray(getattr(jt, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pt.pair_idx.shape == (N_SUBJECTS, int(pt.n_pairs.max()), 2)


def test_plans_bit_equal_to_jax(runs):
    """Both kinds of plans from one generator in JAX's order: every pretrain
    epoch first, then the finetune epochs."""
    from multimodal_sentiment_aanalysis_tpu.train import VectorizedSimCLRTrainer as JaxVSimCLR

    _, pt, _ = runs
    stub = SimpleNamespace(batch_size=B, n_total=N_SUBJECTS, pair_idx=pt.pair_idx,
                           pair_lab=pt.pair_lab, n_pairs=pt.n_pairs, train_idx=pt.train_idx,
                           host_rng=np.random.default_rng(11))
    saved = pt.host_rng
    pt.host_rng = np.random.default_rng(11)
    try:
        for make in ("_pretrain_plans",) * 2 + ("_finetune_plans",) * 2:
            got, want = getattr(pt, make)(), getattr(JaxVSimCLR, make)(stub)
            for g, w in zip(got, want):
                assert g.dtype == np.asarray(w).dtype, make
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=make)
    finally:
        pt.host_rng = saved
    nb = -(-int(pt.n_pairs.max()) // B)
    assert got[0].shape == (N_SUBJECTS, -(-pt.train_idx.shape[1] // B), B)
    rows, _ = pt._pretrain_plans()
    assert rows.shape == (N_SUBJECTS, nb, B, 2)


def test_pretrain_matches_jax(runs):
    from test_torch_port_simclr import check_state

    _, pt, out = runs
    j_hist, p_hist = out["pre"]
    assert len(p_hist) == EPOCHS
    for e, (g, w) in enumerate(zip(p_hist, j_hist)):
        assert g.shape == (N_SUBJECTS,)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0, err_msg=f"epoch {e}")
    steps = EPOCHS * -(-int(pt.n_pairs.max()) // B)
    want, got = out["pre_state"]
    for s in range(N_SUBJECTS):
        for part, label in ((0, "encoder"), (1, "projector")):
            check_state(got[s][part], {k: v[s] for k, v in want[part].items()},
                        f"subject {s} {label}", PRETRAIN_LR, steps)


def test_finetune_matches_jax(runs):
    from test_torch_port_simclr import check_state

    _, pt, out = runs
    want, got = out["ft"]
    assert got.keys() == want.keys() == {"a_acc", "v_acc"}
    for k in want:
        assert got[k].shape == (N_SUBJECTS,)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    want, got = out["ft_state"]
    for s in range(N_SUBJECTS):
        check_state(got[s][2], {k: v[s] for k, v in want[2].items()}, f"subject {s} classifier",
                    FINETUNE_LR, 0)
    assert out["row_frozen"]


def test_run_returns_jax_keys(arrays):
    pt = _port(arrays)
    res = pt.run(1, 1)
    assert res.keys() == {"per_subject", "mean_arousal_acc", "mean_valence_acc"}
    assert res["per_subject"]["a_acc"].shape == (N_SUBJECTS,)
    assert res["mean_valence_acc"] == pytest.approx(float(np.mean(res["per_subject"]["v_acc"])))
    assert pt.finetune(0) == {}


def test_no_cross_subject_coupling(arrays):
    """Perturbing the last subject's pretrain plan leaves every other
    subject's epoch bit for bit as it was (JAX's
    ``test_no_cross_subject_coupling``), and a step of all S models gives
    each subject the loss and gradient of the same step run on its sliced
    row, stats and pairs alone (within float noise: the vmap width changes
    no reduction of one model, but Adam would turn even ulps into lr-sized
    steps over an epoch, as the JAX test says)."""
    rows, labels = (torch.from_numpy(a) for a in _port(arrays)._pretrain_plans())
    alt_rows, alt_labels = rows.clone(), labels.clone()
    alt_rows[-1] = torch.roll(rows[-1], 1, dims=1)
    alt_labels[-1] = 1.0 - labels[-1]
    results = []
    for r, lab in ((rows, labels), (alt_rows, alt_labels)):
        pt = _port(arrays)
        for j in range(r.shape[1]):
            pt.pretrain_step(r[:, j], lab[:, j])
        results.append((pt.params, pt.stats))
    (p_full, s_full), (p_alt, s_alt) = results
    assert torch.equal(p_full[:-1], p_alt[:-1]) and torch.equal(s_full[:-1], s_alt[:-1])
    assert not torch.equal(p_full[-1], p_alt[-1])

    pt = _port(arrays)
    params, stats = pt.params.clone(), pt.stats.clone()
    r, lab = rows[:, 0], labels[:, 0]
    pt.model.train()
    grads, loss = pt._pretrain_grad(pt.params, pt._stat_views, pt.data.gather(r[..., 0]),
                                    pt.data.gather(r[..., 1]), lab)
    for s in range(N_SUBJECTS):
        st = stats[s:s + 1].clone()
        one_grads, one_loss = pt._pretrain_grad(
            params[s:s + 1], pt.layout.stats(st), pt.data.gather(r[s:s + 1, :, 0]),
            pt.data.gather(r[s:s + 1, :, 1]), lab[s:s + 1])
        torch.testing.assert_close(one_loss[0], loss[s], rtol=1e-6, atol=0)
        scale = grads[s].abs().max().item()
        torch.testing.assert_close(one_grads[0], grads[s], rtol=0, atol=1e-6 * scale)
        torch.testing.assert_close(st[0], pt.stats[s], rtol=0, atol=1e-6)


def test_step_matches_sequential_engine(arrays):
    """Subject s of one vectorized pretrain step against the sequential
    engine's step (``train.simclr.pretrain_step``) from the same state on
    the same pairs: loss, gradients, updated parameters, BatchNorm stats."""
    pt = _port(arrays)
    rows, labels = (torch.from_numpy(a[:, 0]) for a in pt._pretrain_plans())
    init = [pt.subject_variables(s) for s in range(N_SUBJECTS)]
    pt.model.train()
    grads, loss = pt._pretrain_grad(pt.params, pt._stat_views, pt.data.gather(rows[..., 0]),
                                    pt.data.gather(rows[..., 1]), labels)
    pt.pre_opt.step(pt.params, grads)
    vt_grads = pt.layout.params(grads)
    for s in (0, N_SUBJECTS - 1):
        enc, proj, _ = _trio()
        enc.load_state_dict(init[s][0])
        proj.load_state_dict(init[s][1])
        enc.train()
        proj.train()
        opt = torch.optim.Adam([*enc.parameters(), *proj.parameters()], lr=PRETRAIN_LR)
        one = pretrain_step(enc, proj, opt, pt.data.gather(rows[s, :, 0]),
                            pt.data.gather(rows[s, :, 1]), labels[s], pt.temperature, None)
        np.testing.assert_allclose(loss[s].item(), one.item(), rtol=1e-5)
        after = pt.subject_variables(s)
        for part, module in ((0, enc), (1, proj)):
            prefix = ("encoder.", "projector.")[part]
            # chip_smoke's gradient bar: 1e-3 of each tensor's largest entry,
            # floored at 1e-7 of the largest of all (measured 1.3e-3 at 16.5
            # on fusion_mlp.0.bias: 7.8e-5 of its largest)
            scale = max(p.grad.abs().max().item() for p in module.parameters())
            for name, p in module.named_parameters():
                bar = 1e-3 * (p.grad.abs().max().item() + 1e-4 * scale)
                torch.testing.assert_close(vt_grads[prefix + name][s], p.grad, rtol=0, atol=bar,
                                           msg=f"{s} {name}")
            for name, t in module.state_dict().items():
                torch.testing.assert_close(after[part][name], t, rtol=0,
                                           atol=1e-5 if "running" in name else 5 * PRETRAIN_LR,
                                           msg=f"{s} {name}")


def test_dropout_views_frozen_row_and_refusals(arrays, one_rank_mesh):
    """With the reference dropouts: the two views of the same rows draw
    different masks, and the finetune leaves the pair row and its BatchNorm
    stats bit-unchanged; subject slices load strictly; under a one-rank mesh
    the trainer is the unsharded one, bit for bit (dropout and all: rank
    0's stream is the unsharded one); ``rng_impl`` is recorded."""
    pt = _port(arrays, dropout=0.5, seed=3, rng_impl="rbg")
    assert pt.rng_impl == "rbg"
    rows = torch.from_numpy(pt._pretrain_plans()[0][:, 0, :, 0])
    view = pt.data.gather(rows)
    pt.model.train()
    z1, z2 = (torch.func.vmap(pt._view_one, randomness="different")(
        pt.params, pt._stat_views, view) for _ in range(2))
    assert not torch.equal(z1, z2)
    pt.pretrain(1)
    before = (pt.params.clone(), pt.stats.clone(), pt.clf_params.clone())
    pt.finetune(1)
    assert torch.equal(pt.params, before[0]) and torch.equal(pt.stats, before[1])
    assert not torch.equal(pt.clf_params, before[2])
    for s in range(N_SUBJECTS):
        for module, sd in zip(_trio(0.5), pt.subject_variables(s)):
            module.load_state_dict(sd, strict=True)
    meshed = _port(arrays, dropout=0.5, seed=3, mesh=one_rank_mesh)
    ref = _port(arrays, dropout=0.5, seed=3)
    np.testing.assert_array_equal(meshed.pretrain(1)[0], ref.pretrain(1)[0])
    np.testing.assert_array_equal(meshed.finetune(1)["a_acc"], ref.finetune(1)["a_acc"])
    for a, b in ((meshed.params, ref.params), (meshed.stats, ref.stats),
                 (meshed.clf_params, ref.clf_params)):
        assert torch.equal(a, b)


def test_fresh_init_per_subject(arrays):
    """Each subject draws its own weights from ``seed + s``: the same seed
    gives the same rows, subjects differ."""
    a, b = _port(arrays, seed=5), _port(arrays, seed=5)
    assert torch.equal(a.params, b.params) and torch.equal(a.clf_params, b.clf_params)
    assert all(not torch.equal(a.params[0], a.params[s]) for s in range(1, N_SUBJECTS))
    c = _port(arrays, seed=6)
    assert torch.equal(c.params[0], a.params[1])


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
def test_vsimclr_on_card_launches_and_frozen_row(cuda):
    """The small trainer on the card: a pretrain epoch launches the stem
    tail and BiLSTM forward and backward kernels once per call for all
    models (4 of each a step: two views), a finetune epoch only their
    forward (2 a step and 2 for the evaluation), both under
    ``set_sync_debug_mode("error")``; the finetune leaves the pair row
    bit-unchanged; the first epoch's losses match the CPU's at dropout 0."""
    from multimodal_sentiment_aanalysis_tpu_torch.kernels import launch_counts, reset_launch_counts

    arrays = _arrays()
    card, cpu = _port(arrays, device=cuda), _port(arrays)
    nb_pre = -(-int(card.n_pairs.max()) // B)
    nb_ft = -(-card.train_idx.shape[1] // B)
    step = dict(bilstm_fwd=4, bilstm_cbnd=4, bilstm_segbwd=4, stem_tail=4, stem_tail_bwd=4,
                bilstm_gemm=4 + 12, bilstm_rec=4, bilstm_sweep=4, bilstm_cscan=4)
    fwd = dict(bilstm_fwd=2, stem_tail=2, bilstm_gemm=2, bilstm_rec=2)

    def on_device(fn):
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out, launch_counts()

    loss, counts = on_device(card.pretrain_epoch_on_device)
    assert counts == {k: nb_pre * step.get(k, 0) for k in counts}
    np.testing.assert_allclose(loss.cpu().numpy(), cpu.pretrain(1)[0], rtol=1e-4)
    row = (card.params.clone(), card.stats.clone())
    (ft_loss, acc), counts = on_device(card.finetune_epoch_on_device)
    assert counts == {k: (nb_ft + 1) * fwd.get(k, 0) for k in counts}
    assert torch.equal(card.params, row[0]) and torch.equal(card.stats, row[1])
    assert bool(torch.isfinite(ft_loss).all()) and acc.shape == (N_SUBJECTS, 2)

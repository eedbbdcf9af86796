"""The port's SimCLR stack against the JAX package on the CPU: the pairs,
the loss, the modules and the sequential engines.

- ``build_contrastive_pairs`` bit-equal to JAX's over several seeds and
  label sets (a subject with one class only, a subject with one sample, no
  pairs at all, a numpy ``Generator`` as the seed);
- ``ntxent_supervised_two_view`` against JAX: value 1e-6 relative, both
  views' gradients;
- ``EyeMLPNet``, ``PPSMLPNet``, ``MultiModalEncoder`` (feat_dim 32, EEG (32,
  64), dropout 0) and ``Classifier`` from JAX's init through ``jax_import``:
  outputs in eval and train mode 1e-5, the BatchNorm running stats after a
  train forward 1e-5, the encoder's gradients against ``jax.grad``, the
  ``jax_import`` round trip exact;
- ``contrastive_pretrain`` and ``finetune`` against the JAX engines over 2
  epochs each from one init, at dropout 0 and batch 8: per-epoch losses and
  ``loss_history`` 1e-4 relative, final accuracies equal, final parameters
  5 x lr and BatchNorm stats 1e-5, but for the two convolution biases before
  a BatchNorm and the running means after them (``NOISE_PARAMS``): their
  exact gradient is 0 and each package's Adam moves them by about lr a step
  on float noise, so they are held to 2 x lr x steps and the means to
  ``NOISE_MEAN_ATOL``. The pretrain runs at lr 1e-4, a tenth of its default,
  as the ME-MHACL engine tests do: at 1e-3 Adam turns last-digit gradient
  differences of near-zero weights into lr-sized steps of either sign, and
  the vectorized trainer's epoch-2 losses part by 2.0e-4 relative (measured
  at this size);
- with dropout on, two views of the same rows draw different masks; the
  engines refuse modules off the data's device.
"""

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.data import (
    DeviceDataset,
    build_contrastive_pairs,
    loso_split,
    subject_ids_array,
)
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    Classifier,
    EyeMLPNet,
    MultiModalEncoder,
    PPSMLPNet,
    ProjectionHead,
    classifier_state_dict_from_jax,
    projection_head_state_dict_from_jax,
    simclr_encoder_state_dict_from_jax,
)
from multimodal_sentiment_aanalysis_tpu_torch.ops import ntxent_supervised_two_view
from multimodal_sentiment_aanalysis_tpu_torch.train import contrastive_pretrain, finetune
from multimodal_sentiment_aanalysis_tpu_torch.train.simclr import encode_pair_view
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F, T_EEG, B, N_SUBJECTS, EX_NUMS = 32, 64, 8, 4, 8
PRETRAIN_LR, FINETUNE_LR, EPOCHS = 1e-4, 1e-4, 2
# the biases before a BatchNorm (exact gradient 0) and the running means of
# the BatchNorms after them
NOISE_PARAMS = ("eeg_net.temp_conv.0.bias", "eeg_net.temp_conv.5.bias")
NOISE_MEANS = ("eeg_net.temp_conv.1.running_mean", "eeg_net.temp_conv.6.running_mean")
# measured after 6 steps: the biases 6.9e-4 (bar 2 x lr x 6 = 1.2e-3), the
# means 3.0e-4 here and 3.1e-4 in the vectorized trainer's run
NOISE_MEAN_ATOL = 1e-3


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _tree(tree):
    import jax

    return {jax.tree_util.keystr(k): np.asarray(x)
            for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def tiny_arrays(seed: int = 0) -> dict[str, np.ndarray]:
    """``tests/test_vsimclr.py``'s set: 4 subjects x 8 trials, EEG (32, 64)."""
    r = np.random.default_rng(seed)
    n = N_SUBJECTS * EX_NUMS
    return {
        "eeg": r.normal(size=(n, 32, T_EEG)).astype(np.float32),
        "eye": r.normal(size=(n, 38)).astype(np.float32),
        "pps": r.normal(size=(n, 230)).astype(np.float32),
        "arousal": r.integers(0, 3, n).astype(np.int64),
        "valence": r.integers(0, 3, n).astype(np.int64),
    }


def check_state(got: dict, want: dict, label: str, lr: float, steps: int) -> None:
    """Parameters within 5 x lr and BatchNorm stats within 1e-5, the noise
    tensors (``NOISE_PARAMS``, ``NOISE_MEANS``) within their bars."""
    assert got.keys() == want.keys()
    for name, t in got.items():
        if "num_batches" in name:
            continue
        if name.endswith(NOISE_PARAMS):
            atol = 2 * lr * steps
        elif name.endswith(NOISE_MEANS):
            atol = NOISE_MEAN_ATOL
        else:
            atol = 1e-5 if "running" in name else 5 * lr
        np.testing.assert_allclose(t.numpy(), np.asarray(want[name]), rtol=0, atol=atol,
                                   err_msg=f"{label} {name}")


# --------------------------------------------------------------------------
# pairs and loss
# --------------------------------------------------------------------------


def _labels(case: str):
    r = np.random.default_rng(len(case))
    if case == "random":
        return r.integers(0, 3, 40), r.integers(0, 3, 40), np.repeat(np.arange(5), 8)
    if case == "one_class_subject":  # subject 1 all one class: no negatives
        a, v = r.integers(0, 3, 30), r.integers(0, 3, 30)
        a[10:20], v[10:20] = 2, 1
        return a, v, np.repeat(np.arange(3), 10)
    if case == "single_sample_subject":  # subject 7 has one sample, ids unsorted
        sids = np.concatenate([np.repeat([3, 0, 5], 9), [7]])
        return r.integers(0, 2, 28), r.integers(0, 2, 28), sids
    if case == "all_distinct":  # every pair negative: no pairs at all
        return np.arange(12) % 3, np.arange(12) // 3, np.repeat(np.arange(2), 6)
    raise ValueError(case)


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("case", ["random", "one_class_subject", "single_sample_subject",
                                  "all_distinct"])
def test_build_contrastive_pairs_bit_equal_to_jax(case, seed):
    from multimodal_sentiment_aanalysis_tpu.data.pairs import build_contrastive_pairs as jax_pairs

    a, v, sids = _labels(case)
    for arg in (seed, None):
        got = build_contrastive_pairs(a, v, sids, seed if arg is not None
                                      else np.random.default_rng(seed))
        want = jax_pairs(a, v, sids, seed if arg is not None else np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    idx, lab = got
    if case == "all_distinct":
        assert idx.shape == (0, 2) and lab.shape == (0,)
    else:
        assert len(lab) and lab.sum() * 2 == len(lab)  # balanced
        assert (sids[idx[:, 0]] == sids[idx[:, 1]]).all()
    if case == "one_class_subject":
        assert not np.isin(idx, np.arange(10, 20)).any()
    if case == "single_sample_subject":
        assert not (idx == 27).any()


@pytest.mark.parametrize("b,temperature", [(8, 0.1), (5, 0.5)])
def test_ntxent_supervised_two_view_matches_jax(b, temperature):
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.ops import losses as jl

    rng = np.random.default_rng(b)
    z1, z2 = (rng.normal(size=(b, 16)).astype(np.float32) for _ in range(2))
    lab = (rng.random(b) < 0.5).astype(np.float32)  # pair labels
    want, (g1, g2) = jax.value_and_grad(jl.ntxent_supervised_two_view, argnums=(0, 1))(
        jnp.asarray(z1), jnp.asarray(z2), jnp.asarray(lab), temperature)
    t1, t2 = (torch.tensor(z, requires_grad=True) for z in (z1, z2))
    got = ntxent_supervised_two_view(t1, t2, torch.from_numpy(lab), temperature)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for t, g in ((t1, g1), (t2, g2)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


def _inputs(b: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, T_EEG)).astype(np.float32),
            rng.normal(size=(b, 38)).astype(np.float32),
            rng.normal(size=(b, 230)).astype(np.float32))


def _perturbed_stats(variables, seed):
    import jax

    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a))
                         .astype(np.float32), variables["batch_stats"])
    return {**variables, "batch_stats": stats}


@pytest.fixture(scope="module")
def jax_modules():
    """Flax encoder (with perturbed running stats, so eval mode means
    something), Eye and PPS MLPs, projection head and classifier."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.models import simclr as js

    x = tuple(map(jnp.asarray, _inputs(4, 0)))
    enc = js.MultiModalEncoder(feat_dim=F, eeg_time=T_EEG, dropout=0.0)
    enc_vars = _np(_perturbed_stats(enc.init({"params": jax.random.key(0),
                                              "dropout": jax.random.key(9)}, *x), 1))
    h = enc.apply(enc_vars, *x)
    proj = js.ProjectionHead(in_dim=F, dropout=0.0)
    proj_vars = _np(proj.init(jax.random.key(1), h))
    clf = js.Classifier(in_dim=F, dropout=0.0)
    clf_vars = _np(clf.init(jax.random.key(2), h))
    mlps = {}
    for name, cls, xi in (("eye", js.EyeMLPNet, x[1]), ("pps", js.PPSMLPNet, x[2])):
        m = cls(feat_dim=F)
        mlps[name] = (m, _np(_perturbed_stats(m.init(jax.random.key(3), xi), 4)))
    return (enc, enc_vars), (proj, proj_vars), (clf, clf_vars), mlps


def _port_encoder(enc_vars) -> MultiModalEncoder:
    enc = MultiModalEncoder(F, eeg_time=T_EEG, dropout=0.0)
    enc.load_state_dict(simclr_encoder_state_dict_from_jax(enc_vars), strict=True)
    return enc


def _port_mlp(name: str, variables) -> torch.nn.Module:
    from multimodal_sentiment_aanalysis_tpu_torch.models.jax_import import _relu_bn_mlp

    m = EyeMLPNet(feat_dim=F) if name == "eye" else PPSMLPNet(feat_dim=F)
    sd = _relu_bn_mlp({"net": variables["params"]["net"]},
                      {"net": variables["batch_stats"]["net"]}, "x")
    m.load_state_dict({k.removeprefix("x."): v for k, v in sd.items()}, strict=True)
    return m


def test_state_dict_names_follow_the_reference():
    enc = MultiModalEncoder(F, eeg_time=T_EEG)
    names = set(enc.state_dict())
    for name in ("eye_net.net.0.weight", "eye_net.net.2.running_var", "eye_net.net.3.bias",
                 "pps_net.net.5.weight", "multihead_attn.in_proj_weight",
                 "fusion_mlp.0.weight", "fusion_mlp.2.running_mean",
                 "eeg_net.bilstm.weight_ih_l1_reverse", "eeg_net.temp_conv.6.weight"):
        assert name in names, name
    assert set(Classifier(F).state_dict()) == {f"{m}.{p}" for m in ("shared.0", "fc_arousal",
                                                                    "fc_valence")
                                               for p in ("weight", "bias")}
    assert Classifier(F).fc_valence.out_features == 3
    # the same weights from the same generator on every construction
    a = MultiModalEncoder(F, eeg_time=T_EEG, generator=torch.Generator().manual_seed(3))
    b = MultiModalEncoder(F, eeg_time=T_EEG, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())


def test_jax_import_round_trip_exact(jax_modules):
    from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
        simclr_classifier_variables_from_torch_state_dict,
        simclr_encoder_variables_from_torch_state_dict,
    )

    (_, ev), _, (_, cv), _ = jax_modules
    clf = Classifier(F, dropout=0.0)
    clf.load_state_dict(classifier_state_dict_from_jax(cv), strict=True)
    for back, module, want in ((simclr_encoder_variables_from_torch_state_dict,
                                _port_encoder(ev), ev),
                               (simclr_classifier_variables_from_torch_state_dict, clf, cv)):
        got, ref = _tree(back(module.state_dict())), _tree(dict(want))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_mlps_match_flax(jax_modules, train):
    import jax.numpy as jnp

    *_, mlps = jax_modules
    x = _inputs(B, 5)
    for name, xi in (("eye", x[1]), ("pps", x[2])):
        jm, variables = mlps[name]
        m = _port_mlp(name, variables).train(train)
        got = m(torch.from_numpy(xi))
        if train:
            want, mut = jm.apply(variables, jnp.asarray(xi), train=True, mutable=["batch_stats"])
            for j in range(2):
                bn = m.net[3 * j + 2]
                stats = mut["batch_stats"]["net"][f"bn_{j}"]
                np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=1e-5)
                np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=1e-5)
        else:
            want = jm.apply(variables, jnp.asarray(xi))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_encoder_and_classifier_match_flax(jax_modules, train):
    """Encoder -> classifier in eval and train mode; in train mode the
    encoder's BatchNorm running stats after the forward too."""
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
        simclr_encoder_variables_from_torch_state_dict,
    )

    (jenc, ev), _, (jclf, cv), _ = jax_modules
    enc = _port_encoder(ev).train(train)
    clf = Classifier(F, dropout=0.0)
    clf.load_state_dict(classifier_state_dict_from_jax(cv), strict=True)
    x = _inputs(B, 3)
    jx = tuple(map(jnp.asarray, x))
    if train:
        h_ref, mut = jenc.apply(ev, *jx, train=True, mutable=["batch_stats"])
    else:
        h_ref = jenc.apply(ev, *jx)
    h = enc(*map(torch.from_numpy, x))
    a, v = clf(h)
    a_ref, v_ref = jclf.apply(cv, h_ref)
    for got, want in ((h, h_ref), (a, a_ref), (v, v_ref)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if train:
        got = _tree(simclr_encoder_variables_from_torch_state_dict(enc.state_dict())
                    ["batch_stats"])
        ref = _tree(mut["batch_stats"])
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_encoder_gradients_match_jax(jax_modules):
    """Train-mode gradients of a weighted sum of the encoder's output with
    respect to every parameter, against ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
        simclr_encoder_variables_from_torch_state_dict,
    )

    (jenc, ev), *_ = jax_modules
    x = _inputs(B, 6)
    w = np.random.default_rng(7).normal(size=(B, F)).astype(np.float32)

    def loss(params):
        out, _ = jenc.apply({"params": params, "batch_stats": ev["batch_stats"]},
                            *map(jnp.asarray, x), train=True, mutable=["batch_stats"])
        return (out * w).sum()

    want = _tree(jax.grad(loss)(jax.tree.map(jnp.asarray, ev["params"])))
    enc = _port_encoder(ev).train()
    (enc(*map(torch.from_numpy, x)) * torch.from_numpy(w)).sum().backward()
    grads = {n: p.grad for n, p in enc.named_parameters()}
    got = _tree(simclr_encoder_variables_from_torch_state_dict(
        {**enc.state_dict(), **grads})["params"])
    assert got.keys() == want.keys()
    scale = max(np.abs(g).max() for g in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5 * scale, err_msg=k)


def test_two_views_draw_independent_dropout_masks():
    """With the reference dropouts, two views of the same rows through
    encoder and projector differ (each draws its own masks); at dropout 0
    they are equal."""
    x = dict(zip(("eeg", "eye", "pps"), map(torch.from_numpy, _inputs(B, 8))))
    for p, differ in ((0.4, True), (0.0, False)):
        enc = MultiModalEncoder(F, eeg_time=T_EEG, dropout=p).train()
        proj = ProjectionHead(F, dropout=p + 0.1 if p else 0.0).train()
        gen = torch.Generator().manual_seed(0)
        z1, z2 = (encode_pair_view(enc, proj, x, gen) for _ in range(2))
        assert (not torch.equal(z1, z2)) == differ, p


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(jax_modules):
    """Both packages' pretrain (2 epochs) on subject 0's LOSO pairs, then
    finetune (2 epochs), from JAX's init; the port's finetune starts from
    the JAX pretrain's encoder, so each engine is held alone."""
    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
    from multimodal_sentiment_aanalysis_tpu.train.simclr import (
        contrastive_pretrain as jax_pretrain,
    )
    from multimodal_sentiment_aanalysis_tpu.train.simclr import finetune as jax_finetune

    (jenc, ev), (jproj, pv), (jclf, cv), _ = jax_modules
    arrays = tiny_arrays()
    tr, te = loso_split(N_SUBJECTS, EX_NUMS, 0)
    sids = subject_ids_array(N_SUBJECTS, EX_NUMS)
    pidx, plab = build_contrastive_pairs(arrays["arousal"][tr], arrays["valence"][tr], sids[tr],
                                         seed=42)
    jfull = JaxDataset(arrays)
    j_enc, j_proj, j_losses = jax_pretrain(jenc, jproj, jfull.subset(tr), pidx, plab,
                                           num_epochs=EPOCHS, lr=PRETRAIN_LR, batch_size=B,
                                           verbose=False, init_variables=(ev, pv))
    j_clf, j_metrics = jax_finetune(jenc, j_enc, jclf, jfull.subset(tr), jfull.subset(te),
                                    num_epochs=EPOCHS, lr=FINETUNE_LR, batch_size=B,
                                    verbose=False, init_classifier_vars=cv)

    full = DeviceDataset(arrays, "cpu")
    enc, proj = MultiModalEncoder(F, eeg_time=T_EEG, dropout=0.0), ProjectionHead(F, dropout=0.0)
    enc_sd, proj_sd, losses = contrastive_pretrain(
        enc, proj, full.subset(tr), pidx, plab, num_epochs=EPOCHS, lr=PRETRAIN_LR, batch_size=B,
        verbose=False, init_variables=(simclr_encoder_state_dict_from_jax(ev),
                                       projection_head_state_dict_from_jax(pv)))
    clf = Classifier(F, dropout=0.0)
    clf_sd, metrics = finetune(enc, simclr_encoder_state_dict_from_jax(_np(j_enc)), clf,
                               full.subset(tr), full.subset(te), num_epochs=EPOCHS,
                               lr=FINETUNE_LR, batch_size=B, verbose=False,
                               init_classifier_vars=classifier_state_dict_from_jax(cv))
    steps = EPOCHS * -(-len(plab) // B)
    return {"jax": (j_enc, j_proj, j_losses, j_clf, j_metrics),
            "port": (enc_sd, proj_sd, losses, clf_sd, metrics), "steps": steps}


def test_pretrain_matches_jax(engines):
    j_enc, j_proj, j_losses, _, _ = engines["jax"]
    enc_sd, proj_sd, losses, _, _ = engines["port"]
    assert len(losses) == EPOCHS
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    check_state(enc_sd, simclr_encoder_state_dict_from_jax(_np(j_enc)), "encoder", PRETRAIN_LR,
                engines["steps"])
    check_state(proj_sd, projection_head_state_dict_from_jax(_np(j_proj)), "projector",
                PRETRAIN_LR, engines["steps"])


def test_finetune_matches_jax(engines):
    _, _, _, j_clf, j_metrics = engines["jax"]
    _, _, _, clf_sd, metrics = engines["port"]
    assert metrics.keys() == j_metrics.keys() == {"a_acc", "v_acc", "loss_history"}
    np.testing.assert_allclose(metrics["loss_history"], j_metrics["loss_history"], rtol=1e-4)
    assert metrics["a_acc"] == j_metrics["a_acc"] and metrics["v_acc"] == j_metrics["v_acc"]
    check_state(clf_sd, classifier_state_dict_from_jax(_np(j_clf)), "classifier", FINETUNE_LR,
                0)


def test_finetune_leaves_the_encoder_frozen():
    """The finetune never moves the encoder, its BatchNorm stats included,
    and leaves it in eval mode."""
    arrays = tiny_arrays(1)
    full = DeviceDataset(arrays, "cpu")
    enc = MultiModalEncoder(F, eeg_time=T_EEG).train()
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    finetune(enc, None, Classifier(F), full.subset(np.arange(24)), full.subset(np.arange(24, 32)),
             num_epochs=1, batch_size=B, verbose=False)
    assert not enc.training
    assert all(torch.equal(v, before[k]) for k, v in enc.state_dict().items())


def test_engines_refuse_modules_off_the_data_device():
    full = DeviceDataset(tiny_arrays(), "meta")
    with pytest.raises(ValueError, match="device"):
        contrastive_pretrain(MultiModalEncoder(F, eeg_time=T_EEG), ProjectionHead(F), full,
                             np.zeros((4, 2), np.int32), np.ones(4, np.float32), num_epochs=1,
                             verbose=False)
    with pytest.raises(ValueError, match="device"):
        finetune(MultiModalEncoder(F, eeg_time=T_EEG), None, Classifier(F), full, full,
                 num_epochs=1, verbose=False)

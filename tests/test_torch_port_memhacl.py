"""The port's ME-MHACL stack against the JAX package on the CPU.

- data copies (``data/memhacl.py``, ``sliding_window``,
  ``align_modalities``) bit-equal to JAX; the noise views by their
  distribution (the generators differ by construction);
- ``ntxent_indexed`` and ``cross_entropy`` against JAX (1e-6 relative);
- every module (encoder, projection head, classifier) against flax in eval
  and train mode, outputs 1e-5 and the BatchNorm running stats after one
  train forward 1e-5; the ``jax_import`` round trip exact;
- the fused head's plain version against the Pallas kernel in interpret
  mode and against flax MHA + mean + ``MEMHACLClassifier`` at F=64, B=37
  (rtol 1e-4, atol 1e-5);
- ``memhacl_pretrain`` and ``memhacl_finetune`` against the JAX engines over
  2 epochs from one init through ``jax_import``, at noise 0 and dropout 0:
  per-epoch losses rtol 1e-4, final accuracies equal. The pretrain runs at
  lr 1e-4, a tenth of its default, on batches of 16: Adam moves every
  weight by about lr * sign(g), and the first step's gradients already
  differ in their last digits between the packages (the JAX BatchNorm
  rule's E[x^2] - E[x]^2 cancels digits in a sum taken in another order),
  so weights whose gradient is within that noise take lr-sized steps of
  either sign; at the default lr on batches of 8 the two trajectories part
  by more than 1e-4 within two epochs. A second witness runs both engines
  in float64 at the default lr on batches of 8: they agree within 1e-6;
- at noise 0 and projector dropout 0.5 the two views' projections are
  bit-equal (one dropout stream for both, as JAX passes one key).

The ``gpu``-marked tests hold the fused head kernel against its plain
version on the card and run a small pretrain + finetune on the card against
the CPU; they skip without a card:
``python -m pytest --noconftest -m gpu tests/test_torch_port_memhacl.py``.
"""

import copy

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch import kernels
from multimodal_sentiment_aanalysis_tpu_torch.data import (
    DeviceDataset,
    align_modalities,
    gaussian_views,
    load_emotion_npy,
    make_synthetic_emotion_arrays,
    random_split_indices,
    sliding_window,
    two_views,
)
from multimodal_sentiment_aanalysis_tpu_torch.kernels import fusion_head
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MEMHACLClassifier,
    MEMHACLEncoder,
    ProjectionHead,
    classifier_state_dict_from_jax,
    memhacl_encoder_state_dict_from_jax,
    projection_head_state_dict_from_jax,
)
from multimodal_sentiment_aanalysis_tpu_torch.ops.losses import cross_entropy, ntxent_indexed
from multimodal_sentiment_aanalysis_tpu_torch.train import (
    memhacl_finetune,
    memhacl_logits,
    memhacl_pretrain,
)
from multimodal_sentiment_aanalysis_tpu_torch.train.memhacl import pretrain_views
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F_TINY, HEADS, HIDDEN, T_TINY, B = 32, 4, 16, 64, 8
N_ENGINE, B_ENGINE, PRETRAIN_LR = 32, 16, 1e-4


def _tree(tree):
    import jax

    return {jax.tree_util.keystr(k): np.asarray(x)
            for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, T_TINY)).astype(np.float32),
            rng.normal(size=(b, 38)).astype(np.float32),
            rng.normal(size=(b, 230)).astype(np.float32))


def _perturbed_stats(variables, seed):
    """Nonzero running means and non-unit variances, so eval mode means
    something."""
    import jax

    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a))
                         .astype(np.float32), variables["batch_stats"])
    return {**variables, "batch_stats": stats}


@pytest.fixture(scope="module")
def jax_modules():
    """Flax encoder, projector and classifier variables at tiny width."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.models import memhacl as jm

    x = tuple(map(jnp.asarray, _inputs(4, 0)))
    enc = jm.MEMHACLEncoder(feat_dim=F_TINY, num_heads=HEADS)
    proj = jm.ProjectionHead(in_dim=F_TINY, hidden_dim=F_TINY, out_dim=HIDDEN, dropout=0.0)
    clf = jm.MEMHACLClassifier(in_dim=F_TINY, hidden_dim=HIDDEN, dropout=0.0)
    enc_vars = _perturbed_stats(enc.init(jax.random.key(0), *x), 1)
    h = enc.apply(enc_vars, *x)
    proj_vars = _perturbed_stats(proj.init(jax.random.key(1), h), 2)
    clf_vars = clf.init(jax.random.key(2), h)
    return (enc, enc_vars), (proj, proj_vars), (clf, clf_vars)


def _port_modules(jax_modules):
    (_, ev), (_, pv), (_, cv) = jax_modules
    enc = MEMHACLEncoder(F_TINY, HEADS)
    enc.load_state_dict(memhacl_encoder_state_dict_from_jax(ev), strict=True)
    proj = ProjectionHead(F_TINY, F_TINY, HIDDEN, dropout=0.0)
    proj.load_state_dict(projection_head_state_dict_from_jax(pv), strict=True)
    clf = MEMHACLClassifier(F_TINY, HIDDEN, dropout=0.0)
    clf.load_state_dict(classifier_state_dict_from_jax(cv), strict=True)
    return enc, proj, clf


# --------------------------------------------------------------------------
# data copies and losses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed,signal", [(16, 0, 1.0), (7, 3, 2.5)])
def test_synthetic_arrays_and_split_bit_equal(n, seed, signal):
    from multimodal_sentiment_aanalysis_tpu.data import memhacl as jd

    got = make_synthetic_emotion_arrays(n, seed, signal)
    want = jd.make_synthetic_emotion_arrays(n, seed, signal)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(random_split_indices(n, 0.8, seed), jd.random_split_indices(n, 0.8, seed)):
        np.testing.assert_array_equal(g, w)


def test_load_emotion_npy_matches_jax(tmp_path):
    from multimodal_sentiment_aanalysis_tpu.data import memhacl as jd

    rng = np.random.default_rng(0)
    paths = []
    for name, a in (("eeg", rng.normal(size=(5, 32, 585))), ("eye", rng.normal(size=(5, 38))),
                    ("phy", rng.normal(size=(5, 230))), ("labels", rng.integers(0, 2, (5, 2)))):
        np.save(tmp_path / f"{name}.npy", a)
        paths.append(str(tmp_path / f"{name}.npy"))
    got, want = load_emotion_npy(*paths), jd.load_emotion_npy(*paths)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.save(tmp_path / "labels.npy", np.zeros((5, 3), np.int64))
    with pytest.raises(ValueError, match="labels"):
        load_emotion_npy(*paths)


@pytest.mark.parametrize("win_len,overlap", [(50, 0.0), (64, 0.5), (30, 0.25)])
def test_sliding_window_and_align_bit_equal(win_len, overlap):
    from multimodal_sentiment_aanalysis_tpu.data import augment as ja

    rng = np.random.default_rng(1)
    trial = rng.normal(size=(300, 4)).astype(np.float32)
    for g, w in zip(sliding_window(trial, 2, win_len, overlap),
                    ja.sliding_window(trial, 2, win_len, overlap)):
        np.testing.assert_array_equal(g, w)
    eye = rng.normal(size=(77, 3))
    for g, w in zip(align_modalities(trial, eye, 256, 60), ja.align_modalities(trial, eye, 256, 60)):
        np.testing.assert_array_equal(g, w)


def test_gaussian_views_noise():
    """Noise 0 gives the batch back exactly; the noise has the stated scale
    per modality; the generator alone decides it; two views differ."""
    x = tuple(map(torch.from_numpy, _inputs(64, 2)))
    same = gaussian_views(torch.Generator().manual_seed(0), *x, 0.0, 0.0, 0.0)
    assert all(torch.equal(a, b) for a, b in zip(same, x))
    views = gaussian_views(torch.Generator().manual_seed(0), *x)
    again = gaussian_views(torch.Generator().manual_seed(0), *x)
    assert all(torch.equal(a, b) for a, b in zip(views, again))
    for view, xi, scale in zip(views, x, (0.01, 0.05, 0.05)):
        noise = (view - xi) / scale
        assert abs(noise.mean().item()) < 0.05 and abs(noise.std().item() - 1.0) < 0.05
    v1, v2 = two_views(torch.Generator().manual_seed(0), *x)
    assert not torch.equal(v1[0], v2[0])


@pytest.mark.parametrize("b,temperature", [(8, 0.5), (5, 0.1)])
def test_ntxent_indexed_and_cross_entropy_match_jax(b, temperature):
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.ops import losses as jl

    rng = np.random.default_rng(b)
    z1, z2 = (rng.normal(size=(b, 16)).astype(np.float32) for _ in range(2))
    want, want_g = jax.value_and_grad(jl.ntxent_indexed)(jnp.asarray(z1), jnp.asarray(z2),
                                                        temperature)
    t1 = torch.tensor(z1, requires_grad=True)
    got = ntxent_indexed(t1, torch.from_numpy(z2), temperature)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    logits, labels = rng.normal(size=(b, 3)).astype(np.float32), rng.integers(0, 3, b)
    np.testing.assert_allclose(
        cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


def test_jax_import_round_trip_exact(jax_modules):
    from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
        memhacl_encoder_variables_from_torch_state_dict,
        simclr_classifier_variables_from_torch_state_dict,
        simclr_projection_variables_from_torch_state_dict,
    )

    enc, proj, clf = _port_modules(jax_modules)
    (_, ev), (_, pv), (_, cv) = jax_modules
    for back, module, want in (
            (memhacl_encoder_variables_from_torch_state_dict, enc, ev),
            (simclr_projection_variables_from_torch_state_dict, proj, pv),
            (simclr_classifier_variables_from_torch_state_dict, clf, cv)):
        got = _tree(back(module.state_dict()))
        ref = _tree(dict(want))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_modules_match_flax(jax_modules, train):
    """Encoder -> projector and encoder -> classifier, eval and train mode;
    in train mode the BN running stats after the forward too."""
    import jax.numpy as jnp

    (jenc, ev), (jproj, pv), (jclf, cv) = jax_modules
    enc, proj, clf = _port_modules(jax_modules)
    x = _inputs(B, 3)
    jx = tuple(map(jnp.asarray, x))
    if train:
        h_ref, mut = jenc.apply(ev, *jx, train=True, mutable=["batch_stats"])
        z_ref, mut_p = jproj.apply(pv, h_ref, train=True, mutable=["batch_stats"])
    else:
        h_ref = jenc.apply(ev, *jx)
        z_ref = jproj.apply(pv, h_ref)
    a_ref, v_ref = jclf.apply(cv, h_ref)
    for m in (enc, proj, clf):
        m.train(train)
    h = enc(*map(torch.from_numpy, x))
    z = proj(h)
    a, v = clf(h)
    for got, want in ((h, h_ref), (z, z_ref), (a, a_ref), (v, v_ref)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if train:
        from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
            memhacl_encoder_variables_from_torch_state_dict,
            simclr_projection_variables_from_torch_state_dict,
        )

        for back, module, want in (
                (memhacl_encoder_variables_from_torch_state_dict, enc, mut["batch_stats"]),
                (simclr_projection_variables_from_torch_state_dict, proj, mut_p["batch_stats"])):
            got, ref = _tree(back(module.state_dict())["batch_stats"]), _tree(want)
            assert got.keys() == ref.keys()
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)


# --------------------------------------------------------------------------
# the fused head
# --------------------------------------------------------------------------


def test_fused_head_plain_matches_pallas_and_flax():
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import fused_mha_fusion_head as jax_head
    from multimodal_sentiment_aanalysis_tpu.models import MEMHACLClassifier as FlaxClassifier
    from multimodal_sentiment_aanalysis_tpu.models.layers import MultiheadAttention as FlaxMHA

    f, heads, b = 64, 8, 37
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(b, f)).astype(np.float32) for _ in range(3)]
    jx = list(map(jnp.asarray, xs))
    mha = FlaxMHA(f, heads)
    feats = jnp.stack(jx, axis=1)
    mha_params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=np.shape(a)).astype(np.float32) * 0.05,
        mha.init(jax.random.key(0), feats, feats, feats)["params"])
    h_ref = mha.apply({"params": mha_params}, feats, feats, feats).mean(axis=1)
    clf = FlaxClassifier(in_dim=f, hidden_dim=32)
    clf_vars = clf.init(jax.random.key(1), h_ref)
    want_modules = clf.apply(clf_vars, h_ref)
    want_pallas = jax_head(*jx, mha_params, clf_vars["params"], num_heads=heads, block_b=16,
                           interpret=True)

    port_mha = _mha_from(mha_params, f, heads)
    port_clf = MEMHACLClassifier(f, 32)
    port_clf.load_state_dict(classifier_state_dict_from_jax(clf_vars))
    port_clf.eval()
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = fusion_head.fusion_head_plain(*map(torch.from_numpy, xs),
                                            *fusion_head.head_weights(port_mha, port_clf),
                                            num_heads=heads)
        via_wrapper = fusion_head.fused_mha_fusion_head(*map(torch.from_numpy, xs), port_mha,
                                                        port_clf, heads)
    assert kernels.launch_counts()["fusion_head"] == 0
    for want in (want_pallas, want_modules):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    for g, w in zip(via_wrapper, got):
        assert torch.equal(g, w)


def _mha_from(params, e, heads):
    from multimodal_sentiment_aanalysis_tpu_torch.models import MultiheadAttention

    m = MultiheadAttention(e, heads)
    m.load_state_dict({"in_proj_weight": torch.from_numpy(np.asarray(params["in_proj_weight"])),
                       "in_proj_bias": torch.from_numpy(np.asarray(params["in_proj_bias"])),
                       "out_proj.weight": torch.from_numpy(np.asarray(params["out_proj_weight"])),
                       "out_proj.bias": torch.from_numpy(np.asarray(params["out_proj_bias"]))})
    return m


def test_fused_head_is_forward_only():
    enc, clf = MEMHACLEncoder(F_TINY, HEADS), MEMHACLClassifier(F_TINY, HIDDEN)
    x = torch.randn(3, F_TINY)
    with pytest.raises(RuntimeError, match="forward only"):
        fusion_head.fused_mha_fusion_head(x, x, x, enc.multihead_attn, clf, HEADS)
    with pytest.raises(ValueError, match="no fusion-head kernel"):
        with torch.no_grad():
            m = x.to("meta")
            fusion_head.fusion_head(m, m, m, *(w.to("meta") for w in fusion_head.head_weights(
                enc.multihead_attn, clf)), num_heads=HEADS)


def test_memhacl_logits_module_path_on_cpu(jax_modules):
    """The CPU validation forward is the module path in eval mode, equal to
    the fused head's plain version within rounding, and launches nothing."""
    enc, _, clf = _port_modules(jax_modules)
    x = tuple(map(torch.from_numpy, _inputs(5, 4)))
    kernels.reset_launch_counts()
    got = memhacl_logits(enc, clf, *x)
    assert not enc.training and not clf.training
    with torch.no_grad():
        want = clf(enc(*x))
        fused = fusion_head.fusion_head_plain(
            *enc.embed(*x), *fusion_head.head_weights(enc.multihead_attn, clf), num_heads=HEADS)
    for g, w, f in zip(got, want, fused):
        assert torch.equal(g, w)
        torch.testing.assert_close(f, w, rtol=1e-5, atol=1e-6)
    assert all(n == 0 for n in kernels.launch_counts().values())


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_arrays():
    arrays = make_synthetic_emotion_arrays(n=N_ENGINE, seed=1, planted_signal=2.0)
    arrays["eeg"] = arrays["eeg"][:, :, :T_TINY]
    return arrays


def test_pretrain_and_finetune_match_jax(jax_modules, small_arrays):
    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
    from multimodal_sentiment_aanalysis_tpu.train.memhacl import (
        memhacl_finetune as jax_finetune,
    )
    from multimodal_sentiment_aanalysis_tpu.train.memhacl import (
        memhacl_pretrain as jax_pretrain,
    )

    (jenc, ev), (jproj, pv), (jclf, cv) = jax_modules
    tr, va = random_split_indices(len(small_arrays["eeg"]), 0.8, seed=0)
    jfull = JaxDataset(small_arrays)
    j_enc, _, j_losses = jax_pretrain(jenc, jproj, jfull, num_epochs=2, lr=PRETRAIN_LR,
                                      batch_size=B_ENGINE, noise=(0.0, 0.0, 0.0), seed=0,
                                      verbose=False, init_variables=(ev, pv))
    _, _, j_metrics = jax_finetune(jenc, j_enc, jclf, jfull.subset(tr), jfull.subset(va),
                                   num_epochs=2, batch_size=B_ENGINE, seed=0, verbose=False,
                                   init_classifier_vars=cv)

    enc, proj, clf = _port_modules(jax_modules)
    full = DeviceDataset(small_arrays, "cpu")
    _, _, losses = memhacl_pretrain(enc, proj, full, num_epochs=2, lr=PRETRAIN_LR,
                                    batch_size=B_ENGINE, noise=(0.0, 0.0, 0.0), seed=0,
                                    verbose=False)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    # the finetune from the JAX pretrain's output, so each engine is held alone
    _, _, metrics = memhacl_finetune(enc, memhacl_encoder_state_dict_from_jax(j_enc), clf,
                                     full.subset(tr), full.subset(va), num_epochs=2,
                                     batch_size=B_ENGINE, seed=0, verbose=False)
    np.testing.assert_allclose(metrics["loss_history"], j_metrics["loss_history"], rtol=1e-4)
    assert metrics["a_acc"] == j_metrics["a_acc"] and metrics["v_acc"] == j_metrics["v_acc"]


def test_pretrain_matches_jax_in_float64_at_default_lr(jax_modules, small_arrays):
    """The second witness for the lr 1e-4 choice above: in float64 both
    engines run the default lr 1e-3 on batches of 8 (where float32 parts by
    more than 1e-4 in two epochs) and agree within 1e-6, so the float32 gap
    is rounding amplified by Adam, not a difference of semantics."""
    import jax

    from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
    from multimodal_sentiment_aanalysis_tpu.train.memhacl import (
        memhacl_pretrain as jax_pretrain,
    )

    (jenc, ev), (jproj, pv), _ = jax_modules
    arrays = {k: a.astype(np.float64) if a.dtype == np.float32 else a
              for k, a in small_arrays.items()}
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    with jax.enable_x64(True):
        _, _, want = jax_pretrain(jenc, jproj, JaxDataset(arrays), num_epochs=2, batch_size=B,
                                  noise=(0.0, 0.0, 0.0), seed=0, verbose=False,
                                  init_variables=(f64(ev), f64(pv)))
    enc, proj, _ = _port_modules(jax_modules)
    _, _, got = memhacl_pretrain(enc.double(), proj.double(), DeviceDataset(arrays, "cpu"),
                                 num_epochs=2, batch_size=B, noise=(0.0, 0.0, 0.0), seed=0,
                                 verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_two_views_share_projector_dropout(small_arrays):
    """Noise 0, projector dropout 0.5: both views' projections are
    bit-equal, since one dropout stream serves both (JAX passes one key),
    while another stream gives other masks."""
    enc, proj = MEMHACLEncoder(F_TINY, HEADS), ProjectionHead(F_TINY, F_TINY, HIDDEN)
    enc.train()
    proj.train()
    batch = DeviceDataset(small_arrays, "cpu").gather(np.arange(B))
    stats = copy.deepcopy((enc.state_dict(), proj.state_dict()))
    z1, z2 = pretrain_views(enc, proj, batch, (0.0, 0.0, 0.0), torch.Generator().manual_seed(0))
    assert torch.equal(z1, z2)
    enc.load_state_dict(stats[0])
    proj.load_state_dict(stats[1])
    other, _ = pretrain_views(enc, proj, batch, (0.0, 0.0, 0.0),
                              torch.Generator().manual_seed(1))
    assert not torch.equal(other, z1)


def test_engines_refuse_modules_off_the_data_device(small_arrays):
    full = DeviceDataset(small_arrays, "meta")
    with pytest.raises(ValueError, match="device"):
        memhacl_pretrain(MEMHACLEncoder(F_TINY, HEADS), ProjectionHead(F_TINY, F_TINY, HIDDEN),
                         full, num_epochs=1, verbose=False)


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


# (B, F, heads, hidden): the reference batch, ragged batches, narrow widths
HEAD_SHAPES = {"ref": (32, 256, 8, 128), "ragged": (37, 256, 8, 128),
               "tiny": (3, 64, 8, 32), "b5": (5, 64, 4, 32), "b37": (37, 128, 8, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(HEAD_SHAPES))
def test_fusion_head_kernel_matches_plain(cuda, shape):
    b, f, heads, hidden = HEAD_SHAPES[shape]
    g = torch.Generator().manual_seed(9)
    mha = _mha_from({
        "in_proj_weight": torch.randn(3 * f, f, generator=g).numpy() / f ** 0.5,
        "in_proj_bias": torch.randn(3 * f, generator=g).numpy() * 0.1,
        "out_proj_weight": torch.randn(f, f, generator=g).numpy() / f ** 0.5,
        "out_proj_bias": torch.randn(f, generator=g).numpy() * 0.1}, f, heads).to(cuda)
    clf = MEMHACLClassifier(f, hidden, generator=g).to(cuda)
    x = [torch.randn(b, f, generator=g).to(cuda) for _ in range(3)]
    before = fusion_head.KERNEL.launches
    with torch.no_grad():
        got = fusion_head.fused_mha_fusion_head(*x, mha, clf, heads)
        want = fusion_head.fusion_head_plain(*x, *fusion_head.head_weights(mha, clf),
                                             num_heads=heads)
    assert fusion_head.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    for gt, w in zip(got, want):
        torch.testing.assert_close(gt, w, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_memhacl_engines_on_card_match_cpu(cuda, small_arrays):
    """Noise 0, dropout 0: pretrain and finetune losses and accuracies on the
    card against the CPU; the validation ran through the fused head."""
    results = []
    for dev in (cuda, torch.device("cpu")):
        enc = MEMHACLEncoder(F_TINY, HEADS, device=dev, generator=torch.Generator().manual_seed(0))
        proj = ProjectionHead(F_TINY, F_TINY, HIDDEN, dropout=0.0, device=dev,
                              generator=torch.Generator().manual_seed(1))
        clf = MEMHACLClassifier(F_TINY, HIDDEN, dropout=0.0, device=dev,
                                generator=torch.Generator().manual_seed(2))
        full = DeviceDataset(small_arrays, dev)
        tr, va = random_split_indices(len(full), 0.8, seed=0)
        before = fusion_head.KERNEL.launches
        _, _, losses = memhacl_pretrain(enc, proj, full, num_epochs=2, lr=PRETRAIN_LR,
                                        batch_size=B_ENGINE, noise=(0.0, 0.0, 0.0),
                                        verbose=False)
        _, _, m = memhacl_finetune(enc, None, clf, full.subset(tr), full.subset(va),
                                   num_epochs=2, batch_size=B_ENGINE, verbose=False)
        results.append((losses, m, fusion_head.KERNEL.launches - before))
    (card_l, card_m, card_launches), (cpu_l, cpu_m, cpu_launches) = results
    np.testing.assert_allclose(card_l, cpu_l, rtol=1e-3)
    np.testing.assert_allclose(card_m["loss_history"], cpu_m["loss_history"], rtol=1e-3)
    assert (card_m["a_acc"], card_m["v_acc"]) == (cpu_m["a_acc"], cpu_m["v_acc"])
    assert card_launches == 2 and cpu_launches == 0  # 7 validation rows: one batch an epoch

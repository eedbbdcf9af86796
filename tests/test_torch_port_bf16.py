"""bf16: the port's mixed-precision LOSO training and bf16 serving.

On the CPU, against the JAX package on the same numpy inputs (JAX on the
CPU, its Pallas kernels in interpret mode). Tolerances, with their reasons
(one bf16 ulp is at most 2^-7 of the value):

- the kernels' plain versions at bf16 against the JAX kernels at bf16. Both
  read the same bf16 operands, compute in fp32 and round the stored outputs
  once, so a value may differ by the one ulp that an fp32 rounding
  difference tips: BiLSTM ``h_seq`` (row 1) and the layer's weight
  gradients through the Function (rows 9 and 11), the stem tail's pooled
  output in train and eval mode (row 2) and its gradients (row 12), and
  the InfoNCE gradients (row 13) within rtol 2^-7. The layer's ``dx`` gets
  2^-8 of its largest entry on top: JAX rounds each direction's half to
  bf16 before summing them, the port rounds the fp32 sum once. The stem
  tail takes fp32 statistics here, as the JAX package's own bf16 kernel
  test feeds them (bf16 statistics reach both kernels through different
  fp32 formulas, and a pool window whose entries tie within that rounding
  routes its gradient elsewhere). The InfoNCE loss is fp32 in both: 1e-5;
- ``StackedAdamW``: at ``moment_dtype=float32`` bit-identical to the fp32
  optimizer; at bf16 against JAX ``adamw_lowp`` over 5 steps, the carried
  bf16 moments equal and the parameters within 1e-7 (the same fp32 moment
  arithmetic; XLA and torch may round the update's last bit differently);
- the bf16 ``VectorizedLOSOTrainer`` against the JAX bf16 trainer from its
  stacked init over 2 epochs: per-subject losses within 2e-3 relative,
  about half a bf16 ulp. The packages round at different places: on the
  CPU the JAX stem normalises in bf16 where the port's stem-tail plain
  version computes in fp32 (the kernels' contract), and bf16 products are
  summed in other orders; Adam carries those differences on. Accuracies
  within one row (a logit within rounding of a tie can flip);
- bf16 ``build_serving_forward`` against JAX bf16 serving: rtol and atol
  2e-2 and argmax agreement of at least 90%. The two packages' bf16
  serving differ by 1.7e-3 to 5.0e-3 in max |logit| (3.0e-3 on this
  test's inputs, logits up to 0.15): bf16 rounds at other places in each.
  The bar sits ~7x above that; JAX's own bar for its bf16 serving against
  fp32 (``tests/test_serving.py``) is 0.1.

The ``gpu``-marked tests hold each bf16 kernel form against its plain
version on the card, run a small bf16 LOSO trainer and bf16 serving there
and count their launches. They skip without a card and import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_bf16.py``.
"""

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.kernels import _build, contrastive, conv_stem_train, lstm
from multimodal_sentiment_aanalysis_tpu_torch.train import StackedAdamW
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BF16 = torch.bfloat16
ULP = 2.0 ** -7  # one bf16 ulp, relative to the value


def _bf(a) -> torch.Tensor:
    """A numpy array as a bf16 tensor."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)


def _close(got, want, rtol=ULP, atol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _jbf(a):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


# --------------------------------------------------------------------------
# CPU: the kernels' plain versions at bf16 against the JAX kernels
# --------------------------------------------------------------------------

B_L, T_L, I_L, H_L = 5, 7, 12, 16  # ragged B and T, as in the fp32 tests


def _lstm_case(seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)
    fwd, bwd = ([mk(4 * H_L, I_L), mk(4 * H_L, H_L), mk(4 * H_L), mk(4 * H_L)] for _ in range(2))
    x = rng.normal(size=(B_L, T_L, I_L)).astype(np.float32)
    w = rng.normal(size=(B_L, T_L, 2 * H_L)).astype(np.float32)
    return x, fwd, bwd, w


def test_bilstm_bf16_forward_and_gradients_match_jax():
    """Row 1's plain version, and rows 9 + 11 through the layer Function's
    gradient, against the JAX kernel layer at bf16 (v6 forward, v9
    backward)."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, w = _lstm_case(0)
    jargs = (_jbf(x), tuple(map(_jbf, fwd)), tuple(map(_jbf, bwd)))
    layer = lambda x, f, b: jl.fused_bilstm_layer(x, f, b, interpret=True, use_xproj=True)
    h_ref = layer(*jargs)
    g_ref = jax.grad(lambda *a: jnp.sum(layer(*a).astype(jnp.float32) * w), argnums=(0, 1, 2))(
        *jargs)

    tx = _bf(x).requires_grad_()
    tf, tb = ([_bf(a).requires_grad_() for a in p] for p in (fwd, bwd))
    h = lstm.fused_bilstm_layer(tx, tuple(tf), tuple(tb))
    assert h.dtype == BF16 and h_ref.dtype == jnp.bfloat16
    _close(h, h_ref)
    _close(lstm.fused_bilstm_layer_plain(_bf(x), tuple(map(_bf, fwd)), tuple(map(_bf, bwd))),
           h_ref)
    (h.float() * torch.from_numpy(w)).sum().backward()
    got = [tx.grad, *(a.grad for a in tf), *(a.grad for a in tb)]
    want = jax.tree.leaves(g_ref)
    assert all(g.dtype == BF16 for g in got)
    _close(got[0], want[0], atol=2.0 ** -8 * np.abs(_np(want[0])).max())
    for g, r in zip(got[1:], want[1:]):
        _close(g, r)


def _stem_case(seed, b, t, c):
    rng = np.random.default_rng(seed)
    conv = rng.normal(size=(b, t, c)).astype(np.float32)
    gamma = (rng.normal(size=c) * 0.3 + 1).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    return conv, gamma, beta


STEM_SHAPES = {"stage1": (8, 64, 64, 4), "stage2": (8, 32, 128, 2), "ragged": (8, 37, 64, 4)}


@pytest.mark.parametrize("shape", sorted(STEM_SHAPES))
def test_stem_tail_bf16_matches_jax(shape):
    """Row 2 in train mode (batch statistics) with its gradient (row 12),
    and in eval mode (running statistics), against the JAX
    ``fused_stage_train`` at bf16; ``dconv``/``dgamma``/``dbeta`` come back
    in bf16 as in ``_fst_bwd``."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import conv_stem_train as jcst

    b, t, c, pool = STEM_SHAPES[shape]
    conv, gamma, beta = _stem_case(3, b, t, c)
    w = np.random.default_rng(4).normal(size=(b, t // pool, c)).astype(np.float32)
    seeds = jnp.zeros((8, 128), jnp.int32)

    def jax_stage(conv, gamma, beta):
        c32 = conv.astype(jnp.float32)
        mean = c32.mean((0, 1))
        var = jnp.square(c32).mean((0, 1)) - jnp.square(mean)
        return jcst.fused_stage_train(conv, gamma, beta, jax.lax.stop_gradient(mean),
                                      jax.lax.stop_gradient(var), seeds, 0.0, pool, 1e-5, True)

    jargs = tuple(map(_jbf, (conv, gamma, beta)))
    out_ref = jax_stage(*jargs)
    g_ref = jax.grad(lambda *a: jnp.sum(jax_stage(*a).astype(jnp.float32) * w),
                     argnums=(0, 1, 2))(*jargs)
    tc, tg, tb = (_bf(a).requires_grad_() for a in (conv, gamma, beta))
    with torch.no_grad():
        c32 = tc.float()
        mean = c32.mean((0, 1))
        var = (c32 * c32).mean((0, 1)) - mean * mean
    out = conv_stem_train.fused_stage_train(tc, tg, tb, mean, var, 0.0, pool)
    assert out.dtype == BF16
    _close(out, out_ref, atol=1e-6)
    (out.float() * torch.from_numpy(w)).sum().backward()
    for g, r in zip((tc.grad, tg.grad, tb.grad), g_ref):
        assert g.dtype == BF16
        _close(g, r, atol=1e-6)

    rng = np.random.default_rng(5)
    running = (rng.normal(size=c) * 0.2).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(
        np.float32)
    eval_ref = jcst.fused_stage_train(*jargs, *map(jnp.asarray, running), seeds, 0.0, pool,
                                      1e-5, True)
    with torch.no_grad():
        got = conv_stem_train.fused_stage_train(tc, tg, tb, *map(torch.from_numpy, running),
                                                0.0, pool)
    _close(got, eval_ref, atol=1e-6)


INFONCE_CASES = {
    "singleton_label": (np.array([0, 1, 1, 2, 0, 1, 0, 0, 1, 1, 0, 1, 2, 0, 1, 1]), 16),
    "padded_mask": (np.array([0, 1, 1, 0, 2, 2, 1, 0, 1, 2, 0, 0, 1, 2, 2, 1]), 11),
}


@pytest.mark.parametrize("case", sorted(INFONCE_CASES))
def test_infonce_bf16_matches_jax(case):
    """Row 13 on the same L2-normalised bf16 features: the plain forward
    and the Function's closed-form backward against the JAX kernel and
    ``_core_bwd``; the loss and the temperature's gradient stay fp32, the
    features' gradients come back in bf16."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import contrastive as jc

    labels, n_valid = INFONCE_CASES[case]
    valid = (np.arange(16) < n_valid).astype(np.float32)
    rng = np.random.default_rng(10)
    f1, f2 = (rng.normal(size=(16, 32)).astype(np.float32) for _ in range(2))
    n1, n2 = (f / np.linalg.norm(f, axis=1, keepdims=True) for f in (f1, f2))
    core = lambda a, b, t: jc._infonce_core(a, b, jnp.asarray(labels), jnp.asarray(valid), t)
    ref, g_ref = jax.value_and_grad(core, argnums=(0, 1, 2))(_jbf(n1), _jbf(n2), jnp.float32(0.1))

    t1, t2 = _bf(n1).requires_grad_(), _bf(n2).requires_grad_()
    temp = torch.tensor(0.1, requires_grad=True)
    lab, val = torch.from_numpy(labels), torch.from_numpy(valid)
    loss = contrastive._InfoNCE.apply(t1[None], t2[None], lab, val, temp)
    plain = contrastive.infonce_plain(_bf(n1)[None], _bf(n2)[None], lab[None], val[None],
                                      torch.tensor([0.1]))
    assert loss.dtype == plain.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain.item(), float(ref), rtol=0, atol=1e-5)
    loss.sum().backward()
    assert t1.grad.dtype == t2.grad.dtype == BF16
    for g, r in zip((t1.grad, t2.grad), g_ref[:2]):
        _close(g, r, atol=1e-6)
    np.testing.assert_allclose(temp.grad.item(), float(g_ref[2]), rtol=1e-5)


def test_kernel_checks_take_bf16_only_where_a_form_exists():
    """fp32 and bf16 pass the check of a kernel with a bf16 form; fp16, or
    bf16 at a kernel without one (conv stem, fused head, flash), raise
    ``TypeError``."""
    cpu = torch.device("cpu")
    for dtype in (torch.float32, BF16):
        _build.check_cuda("x", torch.zeros(2, dtype=dtype), cpu, dtypes=_build.F32_BF16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.check_cuda("x", torch.zeros(2, dtype=torch.float16), cpu, dtypes=_build.F32_BF16)
    with pytest.raises(TypeError, match="takes float32$"):
        _build.check_cuda("x", torch.zeros(2, dtype=BF16), cpu)


# --------------------------------------------------------------------------
# CPU: low-precision AdamW moments against adamw_lowp
# --------------------------------------------------------------------------


def _adam_case(steps):
    rng = np.random.default_rng(6)
    params = rng.normal(size=(3, 40)).astype(np.float32)
    grads = [rng.normal(size=(3, 40)).astype(np.float32) for _ in range(steps)]
    return params, grads


def _run_stacked(params, grads, **kw):
    p = torch.from_numpy(params.copy())
    opt = StackedAdamW(p, 1e-3, 0.01, **kw)
    ok = torch.ones(p.shape[0], dtype=torch.bool)
    for g in grads:
        opt.step(p, torch.from_numpy(g), ok)
    return p, opt


def test_stacked_adamw_fp32_moments_are_bit_identical():
    params, grads = _adam_case(5)
    p_ref, opt_ref = _run_stacked(params, grads)
    p, opt = _run_stacked(params, grads, moment_dtype=torch.float32)
    assert opt.mu.dtype == torch.float32
    assert torch.equal(p, p_ref) and torch.equal(opt.mu, opt_ref.mu)
    assert torch.equal(opt.nu, opt_ref.nu)


def test_stacked_adamw_bf16_moments_match_adamw_lowp():
    import jax
    import jax.numpy as jnp
    import optax

    from multimodal_sentiment_aanalysis_tpu.train.state import adamw_lowp

    params, grads = _adam_case(5)
    p, opt = _run_stacked(params, grads, moment_dtype=BF16)
    assert p.dtype == torch.float32 and opt.mu.dtype == opt.nu.dtype == BF16

    tx = adamw_lowp(1e-3, weight_decay=0.01, moment_dtype=jnp.bfloat16)
    jp = jnp.asarray(params)
    state = jax.vmap(tx.init)(jp)
    for g in grads:
        updates, state = jax.vmap(tx.update)(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
    adam = state[0]
    np.testing.assert_array_equal(_np(opt.mu), np.asarray(adam.mu, np.float32))
    np.testing.assert_array_equal(_np(opt.nu), np.asarray(adam.nu, np.float32))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-7)


# --------------------------------------------------------------------------
# CPU: the bf16 LOSO trainer against the JAX bf16 trainer
# --------------------------------------------------------------------------

EPOCHS = 2


@pytest.fixture(scope="module")
def bf16_runs():
    """Two ``train_epoch`` of the JAX and the port bf16 trainers from the
    JAX trainer's stacked init (the fp32 parity test's four subjects,
    feat_dim 16, dropout 0)."""
    from test_torch_port_vloso import _pair, _tiny_arrays

    jt, pt, _, _ = _pair(_tiny_arrays(), compute_dtype="bfloat16", moment_dtype="bfloat16")
    history = [(jt.train_epoch(), pt.train_epoch()) for _ in range(EPOCHS)]
    return jt, pt, history


def test_bf16_trainer_losses_match_jax(bf16_runs):
    jt, pt, history = bf16_runs
    rows = pt.train_idx.shape[1]
    for j, p in history:
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=2e-3, atol=0)
        for k in ("a_acc", "v_acc"):
            np.testing.assert_allclose(p[k], j[k], rtol=0, atol=1.0 / rows + 1e-6)


def test_bf16_trainer_state_dtypes(bf16_runs):
    """fp32 master parameters and BatchNorm running stats, bf16 moments, as
    in the JAX trainer's state."""
    jt, pt, _ = bf16_runs
    assert pt.params.dtype == pt.stats.dtype == torch.float32
    assert pt.opt.mu.dtype == pt.opt.nu.dtype == BF16
    assert {str(leaf.dtype) for leaf in _leaves(jt.opt_state[0].mu)} == {"bfloat16"}
    assert {str(leaf.dtype) for leaf in _leaves(jt.batch_stats)} == {"float32"}
    assert bool(torch.isfinite(pt.params).all())


def _leaves(tree):
    import jax

    return jax.tree.leaves(tree)


def test_bf16_forward_takes_the_jax_models_dtypes():
    """With bf16 parameters and inputs the EEG encoder runs in bf16, the
    eye/PPS subnetworks turn fp32 at their fp32 positional encoding, and
    the logits and InfoNCE terms come out fp32: the dtypes JAX's
    ``model.apply`` gives the same cast in train mode (traced with
    ``jax.eval_shape``)."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu import models as jmodels
    from multimodal_sentiment_aanalysis_tpu.train.state import cast_floating
    from multimodal_sentiment_aanalysis_tpu_torch.models import MultimodalTransformerModel

    rng = np.random.default_rng(7)
    x = (rng.normal(size=(6, 32, 16)), rng.normal(size=(6, 38)), rng.normal(size=(6, 230)))
    labels = np.array([0, 1, 0, 2, 1, 0])
    jm = jmodels.MultimodalTransformerModel(feat_dim=16, eeg_time=16, dropout=0.0)
    jx = tuple(map(_jbf, x))
    jlabels = (jnp.asarray(labels),) * 2 + (jnp.ones(6),)

    def jax_dtypes(v):
        bf16 = {"params": cast_floating(v["params"], jnp.bfloat16),
                "batch_stats": v["batch_stats"]}
        outs, _ = jm.apply(bf16, *jx, labels=jlabels, train=True, mutable=["batch_stats"])
        feats, _ = jm.apply(bf16, *jx, train=True, mutable=["batch_stats"], method=jm.encode)
        return outs, feats

    v = jax.eval_shape(jm.init, jax.random.key(0), *(jnp.zeros(a.shape) for a in x))
    outs, feats = jax.eval_shape(jax_dtypes, v)

    port = MultimodalTransformerModel(feat_dim=16, eeg_time=16, dropout=0.0)
    params = {n: p.detach().to(BF16) for n, p in port.named_parameters()}
    tx = tuple(map(_bf, x))
    got = torch.func.functional_call(port, params, tx,
                                     {"labels": (torch.from_numpy(labels),) * 2 + (torch.ones(6),)})
    got_feats = tuple(torch.func.functional_call(getattr(port, name), _sub(params, name), (t,))
                      for name, t in zip(("eeg_net", "eye_net", "pps_net"), tx))
    name = lambda dt: str(dt).removeprefix("torch.")
    assert [name(t.dtype) for t in got] == [name(o.dtype) for o in outs]
    assert [name(t.dtype) for t in got_feats] == [name(f.dtype) for f in feats]
    assert [name(f.dtype) for f in feats] == ["bfloat16", "float32", "float32"]


def _sub(params: dict, prefix: str) -> dict:
    return {n[len(prefix) + 1:]: p for n, p in params.items() if n.startswith(prefix + ".")}


# --------------------------------------------------------------------------
# CPU: bf16 serving against JAX bf16 serving
# --------------------------------------------------------------------------


def test_bf16_serving_matches_jax_bf16_serving():
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.eval.serving import (
        build_serving_forward as jax_serving,
    )
    from multimodal_sentiment_aanalysis_tpu_torch.eval import build_serving_forward
    from multimodal_sentiment_aanalysis_tpu_torch.models import (
        MultimodalTransformerModel,
        state_dict_from_jax_variables,
    )
    from test_torch_port_models import inputs, jax_variables

    feat_dim, eeg_time, b = 32, 64, 16
    v = jax_variables(feat_dim, eeg_time, seed=11)
    x = inputs(b, eeg_time, seed=12)
    ref = jax_serving(jax.tree.map(jnp.asarray, v), feat_dim, use_pallas=False,
                      compute_dtype=jnp.bfloat16)(*x)
    port = MultimodalTransformerModel(feat_dim=feat_dim, eeg_time=eeg_time).eval()
    port.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    got = build_serving_forward(port, feat_dim, compute_dtype=BF16)(*map(torch.from_numpy, x))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (b, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-2, atol=2e-2)
        assert (g.numpy().argmax(-1) == np.asarray(r).argmax(-1)).mean() >= 0.9


# --------------------------------------------------------------------------
# card: the bf16 kernel forms against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _launches(*kernels):
    return tuple(k.launches for k in kernels)


# one model at the flagship layer, the LOSO step's 24, and a ragged shape
LSTM_CARD = {"layer": (1, 64, 73, 256, 128), "loso_layer": (24, 64, 73, 256, 128),
             "ragged": (3, 5, 7, 12, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(LSTM_CARD))
def test_bilstm_bf16_kernels_match_plain(cuda, shape):
    """The three BiLSTM kernels' bf16 forms: one launch each (fp32 forms
    untouched), ``h_seq`` in bf16 within one ulp of the plain version
    (fp32 sums in another order can tip a rounding); the fp32 checkpoints,
    dx halves and dW_cat within 1e-4 of each tensor's largest entry: the
    same fp32 sums in another order, carried through 73 dependent steps,
    at weights of the flagship's init scale, whose gradients are larger
    than the fp32 tests' saturated gates give."""
    s, b, t, i, h = LSTM_CARD[shape]
    gen = torch.Generator(device=cuda).manual_seed(30)
    rnd = lambda *shape, scale=1.0: (torch.randn(shape, device=cuda, generator=gen)
                                     * scale).to(BF16)
    x, dh = rnd(s, b, t, i), rnd(s, b, t, 2 * h)
    w = (rnd(s, 2, 4 * h, i, scale=0.1), rnd(s, 2, 4 * h, h, scale=0.1), rnd(s, 2, 4 * h, scale=0.1))
    bf16 = (lstm.KERNELS[BF16], lstm.CBND_KERNELS[BF16], lstm.SEGBWD_KERNELS[BF16])
    fp32 = (lstm.KERNEL, lstm.CBND_KERNEL, lstm.SEGBWD_KERNEL)
    with torch.no_grad():
        before, before32 = _launches(*bf16), _launches(*fp32)
        h_seq = lstm.bilstm_fwd(x, *w)
        c_bnd = lstm.bilstm_cbnd(x, h_seq, *w)
        dx_pk, dw_cat = lstm.bilstm_segbwd(dh, x, h_seq, c_bnd, *w)
        assert _launches(*bf16) == tuple(n + 1 for n in before)
        assert _launches(*fp32) == before32
        h_ref = lstm.bilstm_fwd_plain(x, *w)
        c_ref = lstm.bilstm_cbnd_plain(x, h_seq, *w)
        dx_ref, dw_ref = lstm.bilstm_segbwd_plain(dh, x, h_seq, c_bnd, *w)
    torch.cuda.synchronize()
    assert h_seq.dtype == BF16 and c_bnd.dtype == dx_pk.dtype == dw_cat.dtype == torch.float32
    torch.testing.assert_close(h_seq.float(), h_ref.float(), rtol=ULP, atol=1e-4)
    for got, want in ((c_bnd, c_ref), (dx_pk, dx_ref), (dw_cat, dw_ref)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


STEM_CARD = {"stage1": (1, 64, 585, 64, 4), "loso_stage2": (24, 64, 146, 256, 2),
             "ragged": (3, 3, 11, 5, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.0, 0.4])
@pytest.mark.parametrize("shape", sorted(STEM_CARD))
def test_stem_tail_bf16_kernels_match_plain(cuda, shape, p):
    """Rows 2 and 12 in bf16: the pooled output within one ulp of the plain
    version at p=0, the backward's fp32 ``dy`` and partials as in the fp32
    tests, fed the kernel's own code; bf16 statistics enter in fp32."""
    s, b, t, c, pool = STEM_CARD[shape]
    gen = torch.Generator(device=cuda).manual_seed(31)
    conv = torch.randn(s, b, t, c, device=cuda, generator=gen).to(BF16)
    gamma = (1 + 0.3 * torch.randn(s, c, device=cuda, generator=gen)).to(BF16)
    beta = (0.1 * torch.randn(s, c, device=cuda, generator=gen)).to(BF16)
    mean = conv.mean((1, 2))
    var = (conv * conv).mean((1, 2)) - mean * mean
    kernels = (conv_stem_train.KERNELS[BF16], conv_stem_train.BWD_KERNELS[BF16])
    with torch.no_grad():
        before = _launches(*kernels)
        out, code = conv_stem_train.stem_tail_fwd(conv, gamma, beta, mean, var, p, pool,
                                                  generator=gen)
        assert out.dtype == BF16
        if p == 0.0:
            ref, ref_code = conv_stem_train.fused_stage_train_plain(
                conv, gamma, beta, mean, var, pool, 1e-5, with_code=True)
            torch.testing.assert_close(out.float(), ref.float(), rtol=ULP, atol=1e-5)
            assert (code != ref_code).double().mean().item() <= 1e-3
        inv = torch.rsqrt(var + 1e-5)
        scale, shift = gamma * inv, beta - mean * gamma * inv
        dpool = torch.randn(out.shape, device=cuda, generator=gen).to(BF16)
        got = conv_stem_train.stem_tail_bwd(conv, dpool, code, scale, shift, mean, inv, p, pool)
        assert _launches(*kernels) == (before[0] + 1, before[1] + 1)
        want = conv_stem_train.stem_tail_bwd_plain(conv, dpool, code, scale, shift, mean, inv,
                                                   p, pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.sum(-2), w.sum(-2), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("p_b_d", [(72, 64, 256), (3, 37, 19)])
def test_infonce_bf16_kernel_and_gradients(cuda, p_b_d):
    """Row 13 in bf16 at the LOSO step's P = 3 S = 72 and a ragged shape:
    one launch through the loss's entry point, fp32 losses within 1e-4 of
    the plain version; the Function's closed-form gradients of normalised
    bf16 features within one ulp of autograd through the plain version
    (both fp32, rounded once to bf16; the L2 normalisation's own bf16
    backward, shared by both paths, is left out: its cancellation would
    turn a one-ulp difference into an absolute one)."""
    p, b, d = p_b_d
    gen = torch.Generator(device=cuda).manual_seed(32)
    feats = torch.randn(p, b, d, device=cuda, generator=gen).to(BF16)
    labels = torch.randint(0, 3, (b,), device=cuda, generator=gen)
    mask = torch.ones(b, device=cuda)
    mask[-3:] = 0.0
    temp = torch.tensor(0.1, device=cuda)
    before = contrastive.KERNELS[BF16].launches
    loss = contrastive.fused_supervised_infonce_multi(feats, feats, labels, temp, mask)
    assert contrastive.KERNELS[BF16].launches == before + 1 and loss.dtype == torch.float32
    n = torch.nn.functional.normalize(feats, dim=2, eps=1e-12)
    n1, n2 = n.clone().requires_grad_(), n.clone().requires_grad_()
    got = torch.autograd.grad(contrastive._InfoNCE.apply(n1, n2, labels, mask, temp).sum(),
                              (n1, n2))
    r1, r2 = n.clone().requires_grad_(), n.clone().requires_grad_()
    ref = contrastive.infonce_plain(r1, r2, labels.expand(p, b), mask.expand(p, b),
                                    temp.expand(p))
    want = torch.autograd.grad(ref.sum(), (r1, r2))
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, ref.detach(), rtol=0, atol=1e-4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == BF16
        torch.testing.assert_close(g.float(), w.float(), rtol=ULP,
                                   atol=1e-5 * w.abs().max().item())


@pytest.mark.gpu
def test_fp16_and_kernels_without_bf16_forms_raise(cuda):
    x = torch.zeros(1, 8, 3, 16, device=cuda, dtype=torch.float16)
    w = (torch.zeros(1, 2, 64, 16, device=cuda, dtype=torch.float16),
         torch.zeros(1, 2, 64, 16, device=cuda, dtype=torch.float16),
         torch.zeros(1, 2, 64, device=cuda, dtype=torch.float16))
    with pytest.raises(TypeError):
        lstm.bilstm_fwd(x, *w)
    with pytest.raises(TypeError):  # row 4: fp32 and bf16 forms only
        lstm.bilstm_fwd_xp(torch.zeros(1, 8, 3, 128, device=cuda, dtype=torch.float16), w[1])
    from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem

    xs = torch.zeros(2, 16, 4, device=cuda, dtype=BF16)
    with pytest.raises(TypeError):
        conv_stem.fused_conv_bn_gelu_pool(xs, torch.zeros(8, 4, 3, device=cuda, dtype=BF16),
                                          torch.ones(8, device=cuda, dtype=BF16),
                                          torch.zeros(8, device=cuda, dtype=BF16), 1, 2)


@pytest.mark.gpu
def test_bf16_loso_trainer_and_serving_on_card(cuda):
    """A small bf16 LOSO trainer (3 subjects, feat_dim 32) on the card:
    per step the bf16 forms of the BiLSTM and stem-tail kernels and the fp32
    InfoNCE form (its features are fp32, as in JAX), as many launches as an
    fp32 step; finite losses within 5e-2 relative of the CPU bf16 trainer
    (the CPU recurrence carries bf16 state, the card's kernels fp32); the
    fused epochs without a host sync. Then bf16 serving: two launches of
    the bf16 BiLSTM forward per batch, logits fp32 and within JAX's bf16 bar
    of fp32 serving."""
    from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset
    from multimodal_sentiment_aanalysis_tpu_torch.eval import build_serving_forward
    from multimodal_sentiment_aanalysis_tpu_torch.kernels import launch_counts, reset_launch_counts
    from multimodal_sentiment_aanalysis_tpu_torch.models import MultimodalTransformerModel
    from multimodal_sentiment_aanalysis_tpu_torch.train import VectorizedLOSOTrainer

    rng = np.random.default_rng(33)
    n = 3 * 8
    arrays = {"eeg": rng.normal(size=(n, 32, 64)).astype(np.float32),
              "eye": rng.normal(size=(n, 38)).astype(np.float32),
              "pps": rng.normal(size=(n, 230)).astype(np.float32),
              "arousal": rng.integers(0, 3, n), "valence": rng.integers(0, 3, n)}

    def make(device):
        model = MultimodalTransformerModel(feat_dim=32, eeg_time=64, dropout=0.0, device=device)
        return VectorizedLOSOTrainer(model, DeviceDataset(arrays, device), 3, 8, batch_size=8,
                                     seed=0, early_stop=True, compute_dtype="bfloat16",
                                     moment_dtype="bfloat16")

    card, cpu = make(cuda), make("cpu")
    reset_launch_counts()
    got, want = card.train_epoch(), cpu.train_epoch()
    steps = 2  # 16 train rows per subject, batch 8
    # rows 1, 9 and 11 launch their GEMM, recurrence, scan and sweep kernels
    # inside; the v9 layer backward computes the gates once for rows 9 and 11;
    # the scan has one form (its input is fp32)
    per_step = dict(bilstm_fwd_bf16=2, bilstm_cbnd_bf16=2, bilstm_segbwd_bf16=2, stem_tail_bf16=2,
                    stem_tail_bwd_bf16=2, infonce=1, bilstm_gemm_bf16=8, bilstm_rec_bf16=2,
                    bilstm_sweep_bf16=2, bilstm_cscan=2)
    assert launch_counts() == {k: steps * per_step.get(k, 0) for k in launch_counts()}
    assert np.isfinite(got["loss"]).all()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=5e-2)
    assert card.opt.mu.dtype == BF16 and card.params.dtype == torch.float32
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = card.fused_epochs_on_device(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (2, 3, 9) and bool(torch.isfinite(out).all())

    model = MultimodalTransformerModel(feat_dim=32, eeg_time=64, device=cuda).eval()
    x = tuple(torch.from_numpy(arrays[k][:16]).to(cuda) for k in ("eeg", "eye", "pps"))
    reset_launch_counts()
    a16, v16 = build_serving_forward(model, 32, compute_dtype=BF16)(*x)
    assert launch_counts()["bilstm_fwd_bf16"] == 2 and launch_counts()["bilstm_fwd"] == 0
    a32, v32 = build_serving_forward(model, 32)(*x)
    torch.cuda.synchronize()
    for lo, hi in ((a16, a32), (v16, v32)):
        assert lo.dtype == torch.float32
        torch.testing.assert_close(lo, hi, rtol=0.1, atol=0.1)
        assert (lo.argmax(-1) == hi.argmax(-1)).double().mean().item() >= 0.9

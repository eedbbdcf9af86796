"""The port's training kernels with the model axis S inside the launch.

On the CPU, each kernel's S-axis plain version (S models in one call) is
held against the JAX function over the same S models (``jax.vmap``, or the
Pallas kernel's own leading model axis, in interpret mode) and against S
separate one-model calls; and each kernel's ``autograd.Function`` is held
under ``torch.func.vmap(grad_and_value)`` against per-model autograd, with
its ``vmap`` rule entered once for all S models. Tolerances, fp32:

- against JAX: rtol 1e-5 with an atol of 2e-5 for entries near 0 (BiLSTM
  c checkpoints and reverse sweep, as in the one-model tests: summation
  order over a few steps), 1e-5 for the stem tail and InfoNCE values;
- against S one-model calls of the port itself: 1e-6 (the same arithmetic
  in the same order);
- ``vmap(grad)`` gradients against per-model autograd: 1e-5 (BiLSTM,
  InfoNCE), 1e-5 relative to the largest entry (stem tail).

The ``gpu``-marked tests hold each S-axis CUDA kernel against its plain
version on the card, at a ragged S and B and at the LOSO trainer's S=24,
B=64 layer shapes. They skip without a card and import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_vloso_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from multimodal_sentiment_aanalysis_tpu_torch.kernels import contrastive, conv_stem_train, lstm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

S, B, T, I, H = 3, 5, 7, 12, 16  # ragged B and T, as in the one-model tests


def _lstm_models(seed, s, b, t, i, h):
    """``s`` models' ``x (S, B, T, I)``, torch-layout ``fwd``/``bwd`` tuples
    of ``(S, ...)`` arrays and ``dh (S, B, T, 2H)``."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: (0.3 * rng.normal(size=(s, *shape))).astype(np.float32)
    fwd, bwd = ([mk(4 * h, i), mk(4 * h, h), mk(4 * h), mk(4 * h)] for _ in range(2))
    x = rng.normal(size=(s, b, t, i)).astype(np.float32)
    dh = rng.normal(size=(s, b, t, 2 * h)).astype(np.float32)
    return x, fwd, bwd, dh


def _stacked(fwd, bwd):
    """Port S-axis weights ``(w_ih (S, 2, 4H, I), w_hh, bias)`` from
    ``(S, ...)`` torch-layout tuples."""
    f, b = (tuple(map(torch.from_numpy, p)) for p in (fwd, bwd))
    return (torch.stack([f[0], b[0]], 1), torch.stack([f[1], b[1]], 1),
            torch.stack([f[2] + f[3], b[2] + b[3]], 1))


def _stem_models(seed, s, b, t, c):
    rng = np.random.default_rng(seed)
    conv = rng.normal(size=(s, b, t, c)).astype(np.float32)
    gamma = (rng.normal(size=(s, c)) * 0.3 + 1).astype(np.float32)
    beta = (rng.normal(size=(s, c)) * 0.1).astype(np.float32)
    return conv, gamma, beta


def _stats(conv: torch.Tensor):
    """Per-model batch statistics over (B, T), as ``models/eeg.py`` takes them."""
    mean = conv.mean((-3, -2))
    return mean, (conv * conv).mean((-3, -2)) - mean * mean


def _infonce_models(seed, s, g, b, d):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(s, g, b, d)).astype(np.float32)
    labels = rng.integers(0, 3, (s, b))
    labels[:, 0] = 7  # a label that occurs once: its row has no positive
    valid = np.ones((s, b), np.float32)
    valid[1, -3:] = 0.0  # one model's batch is wrap-padded
    temp = np.array([0.1, 0.07, 0.2], np.float32)[:s]
    return feats, labels, valid, temp


def _close_to_jax(got, ref, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=atol)


# --------------------------------------------------------------------------
# CPU: S-axis plain versions against JAX and against S one-model calls
# --------------------------------------------------------------------------


def test_bilstm_fwd_plain_models_match_jax_vmap():
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, _ = _lstm_models(0, S, B, T, I, H)
    ref = jax.vmap(lambda x, f, b: jl.fused_bilstm_layer(x, f, b, interpret=True,
                                                         use_xproj=True))(
        jnp.asarray(x), tuple(map(jnp.asarray, fwd)), tuple(map(jnp.asarray, bwd)))
    got = lstm.bilstm_fwd_plain(torch.from_numpy(x), *_stacked(fwd, bwd))
    assert got.shape == (S, B, T, 2 * H)
    _close_to_jax(got, ref)
    w = _stacked(fwd, bwd)
    for s in range(S):
        one = lstm.bilstm_fwd(torch.from_numpy(x[s]), *(t[s] for t in w))
        torch.testing.assert_close(got[s], one, rtol=0, atol=1e-6)


def _jax_models_operands(x, fwd, bwd):
    """The JAX kernels' ``(S, T, B, ·)`` operands of S models, and their
    ``h_seq``."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    h = jax.vmap(lambda x, f, b: jl.fused_bilstm_layer(x, f, b, interpret=True,
                                                       use_xproj=True))(
        jnp.asarray(x), tuple(map(jnp.asarray, fwd)), tuple(map(jnp.asarray, bwd)))
    t = lambda a: jnp.swapaxes(jnp.asarray(a), -1, -2)
    w_ih = jnp.stack([t(fwd[0]), t(bwd[0])], 1)
    w_hh = jnp.stack([t(fwd[1]), t(bwd[1])], 1)
    b = jnp.stack([fwd[2] + fwd[3], bwd[2] + bwd[3]], 1)[:, :, None, :]
    return np.array(h), jnp.swapaxes(jnp.asarray(x), 1, 2), jnp.swapaxes(h, 1, 2), w_ih, w_hh, b


def _port_cbnd(c_jax, h):
    """JAX ``(S, NSEG, B, 2H)`` checkpoints -> the port's ``(S, 2, NSEG, B, H)``."""
    c = np.asarray(c_jax)
    return torch.from_numpy(np.stack([c[..., :h], c[..., h:]], 1).copy())


@pytest.mark.parametrize("k", [2, lstm.SEG_K])
def test_bilstm_backward_plain_models_match_jax(k):
    """c checkpoints and the reverse sweep of S models in one call against
    the JAX kernels' own model axis (interpret mode), and against S
    one-model calls."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, dh = _lstm_models(1, S, B, T, I, H)
    h, xt, hs, w_ih, w_hh, b = _jax_models_operands(x, fwd, bwd)
    c_jax = jl._cbnd_call(xt, hs, w_ih, w_hh, b, k, True)
    dx_ref, dw_ref = (np.asarray(a) for a in jl._segbwd_call(
        np.swapaxes(dh, 1, 2), xt, hs, c_jax, w_ih, w_hh, b, k, True))
    w = _stacked(fwd, bwd)
    tx, th, tdh = map(torch.from_numpy, (x, h, dh))
    c_bnd = lstm.bilstm_cbnd_plain(tx, th, *w, k)
    ref_c = _port_cbnd(c_jax, H)
    nseg = -(-T // k)
    assert c_bnd.shape == (S, 2, nseg, B, H)
    # the slots a block reads: entries of blocks 1.. (d=0) and ..NSEG-2 (d=1)
    _close_to_jax(c_bnd[:, 0, : nseg - 1], ref_c[:, 0, : nseg - 1], atol=2e-5)
    _close_to_jax(c_bnd[:, 1, 1:], ref_c[:, 1, 1:], atol=2e-5)
    dx_pk, dw_cat = lstm.bilstm_segbwd_plain(tdh, tx, th, _port_cbnd(c_jax, H), *w, k)
    for d in (0, 1):
        _close_to_jax(dx_pk[:, d], np.swapaxes(dx_ref[..., d * I:(d + 1) * I], 1, 2),
                      atol=2e-5)
    _close_to_jax(dw_cat, dw_ref[:, :, : I + H + 1], atol=2e-5)
    for s in range(S):
        ws = tuple(t[s] for t in w)
        torch.testing.assert_close(c_bnd[s], lstm.bilstm_cbnd(tx[s], th[s], *ws, k),
                                   rtol=0, atol=1e-6)
        one = lstm.bilstm_segbwd(tdh[s], tx[s], th[s], c_bnd[s], *ws, k)
        many = lstm.bilstm_segbwd(tdh, tx, th, c_bnd, *w, k)
        for a, m in zip(one, many):
            torch.testing.assert_close(m[s], a, rtol=0, atol=1e-6)


# the one-model tests' shapes (the JAX kernel's lane layout wants C of 64 or
# 128 and B a multiple of 8), two models each
STEM_MODELS = {"stage1": (2, 8, 64, 64, 4), "stage2": (2, 8, 32, 128, 2),
               "ragged": (2, 8, 37, 64, 4)}


@pytest.mark.parametrize("shape", sorted(STEM_MODELS))
def test_stem_tail_plain_models_match_jax_vmap(shape):
    """p=0 pooled values and the backward of S models in one call: against
    ``jax.vmap`` of the JAX ``fused_stage_train`` and its gradient, and
    against S one-model calls."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import conv_stem_train as jcst

    s_n, b, t, c, pool = STEM_MODELS[shape]
    conv, gamma, beta = _stem_models(2, s_n, b, t, c)
    w = np.random.default_rng(3).normal(size=(s_n, b, t // pool, c)).astype(np.float32)
    seeds = jnp.zeros((8, 128), jnp.int32)

    def jax_stage(conv, gamma, beta):
        mean = conv.mean((0, 1))
        var = (conv ** 2).mean((0, 1)) - mean ** 2
        return jcst.fused_stage_train(conv, gamma, beta, jax.lax.stop_gradient(mean),
                                      jax.lax.stop_gradient(var), seeds, 0.0, pool, 1e-5, True)

    args = tuple(map(jnp.asarray, (conv, gamma, beta)))
    ref = jax.vmap(jax_stage)(*args)
    ref_g = jax.vmap(jax.grad(lambda *a, w: jnp.sum(jax_stage(*a) * w), argnums=(0, 1, 2)))(
        *args, w=jnp.asarray(w))

    tc, tg, tb = map(torch.from_numpy, (conv, gamma, beta))
    mean, var = _stats(tc)
    out, code = conv_stem_train.fused_stage_train_plain(tc, tg, tb, mean, var, pool,
                                                        with_code=True)
    _close_to_jax(out, ref)
    inv = torch.rsqrt(var + 1e-5)
    scale, shift = tg * inv, tb - mean * tg * inv
    dy, dg, db = conv_stem_train.stem_tail_bwd_plain(tc, torch.from_numpy(w), code, scale,
                                                     shift, mean, inv, 0.0, pool)
    # the BN combine the autograd Function applies, per model
    n = b * t
    dy = torch.nn.functional.pad(dy, (0, 0, 0, t - dy.shape[2]))
    dgamma, dbeta = dg.sum(1), db.sum(1)
    xhat = (tc - mean[:, None, None]) * inv[:, None, None]
    dconv = (inv * tg)[:, None, None] * (dy - dbeta[:, None, None] / n
                                         - xhat * (dgamma / n)[:, None, None])
    for got, r in zip((dconv, dgamma, dbeta), ref_g):
        r = np.asarray(r)
        assert np.max(np.abs(got.numpy() - r)) <= 1e-5 * np.max(np.abs(r))
    for m in range(s_n):
        one, one_code = conv_stem_train.fused_stage_train_plain(
            tc[m], tg[m], tb[m], mean[m], var[m], pool, with_code=True)
        torch.testing.assert_close(out[m], one, rtol=0, atol=1e-6)
        assert torch.equal(code[m], one_code)


def test_stem_tail_dropout_draws_one_mask_per_model():
    """p > 0 over S models: each model's keep mask is its own slice of one
    ``torch.rand`` draw of the whole ``(S, B, T, C)`` from the generator, and
    the plain version fed that mask agrees."""
    conv, gamma, beta = map(torch.from_numpy, _stem_models(4, S, 2, 12, 3))
    mean, var = _stats(conv)
    out, code = conv_stem_train.stem_tail_fwd(conv, gamma, beta, mean, var, 0.5, 3,
                                              generator=torch.Generator().manual_seed(5))
    keep = torch.rand(conv.shape, generator=torch.Generator().manual_seed(5)) >= 0.5
    ref, ref_code = conv_stem_train.fused_stage_train_plain(conv, gamma, beta, mean, var, 3,
                                                            1e-5, 0.5, keep, with_code=True)
    assert torch.equal(out, ref) and torch.equal(code, ref_code)
    assert not torch.equal(keep[0], keep[1])


def test_infonce_plain_models_match_jax_vmap():
    """P = 3 S problems with per-model labels, masks and temperatures in one
    call, against ``jax.vmap`` of the JAX kernel per loss and S one-model
    calls."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels.contrastive import fused_supervised_infonce

    feats, labels, valid, temp = _infonce_models(6, S, 3, 10, 16)
    one_model = lambda f, l, v, t: jnp.stack(
        [fused_supervised_infonce(f[g], f[g], l, t, v) for g in range(3)])
    ref = jax.vmap(one_model)(*map(jnp.asarray, (feats, labels, valid, temp)))
    n = torch.nn.functional.normalize(torch.from_numpy(feats), dim=-1, eps=1e-12)
    per = lambda a: torch.from_numpy(np.repeat(a, 3, 0))
    got = contrastive.infonce_plain(n.reshape(S * 3, 10, 16), n.reshape(S * 3, 10, 16),
                                    per(labels), per(valid), per(temp))
    _close_to_jax(got.reshape(S, 3), ref)
    for s in range(S):
        one = contrastive.infonce(n[s], n[s], per(labels[s:s + 1]), per(valid[s:s + 1]),
                                  per(temp[s:s + 1]))
        torch.testing.assert_close(got[3 * s:3 * s + 3], one, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# CPU: each Function under torch.func.vmap(grad_and_value)
# --------------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    """Record the shapes of every call to ``module.name``."""
    calls, fn = [], getattr(module, name)

    def spy(*args, **kw):
        calls.append(tuple(a.shape for a in args if isinstance(a, torch.Tensor)))
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_bilstm_function_under_vmap_grad(monkeypatch):
    """x and every weight's gradient of S models through one
    ``vmap(grad_and_value)`` equal S per-model autograd runs; the forward
    and both backward kernels' paths are entered once, with all S models."""
    x, fwd, bwd, _ = _lstm_models(7, S, B, T, I, H)
    tx = torch.from_numpy(x)
    tf, tb = (tuple(map(torch.from_numpy, p)) for p in (fwd, bwd))
    loss = lambda x, f, b: torch.sin(lstm.fused_bilstm_layer(x, f, b)).sum()
    calls = {n: _spy(monkeypatch, lstm, n)
             for n in ("bilstm_fwd_plain", "bilstm_cbnd_plain", "bilstm_segbwd_plain")}
    grads, values = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(tx, tf, tb)
    assert all(len(c) == 1 and all(shape[0] == S for shape in c[0]) for c in calls.values())
    for s in range(S):
        leaves = [tx[s].clone().requires_grad_(),
                  *(t[s].clone().requires_grad_() for t in (*tf, *tb))]
        v = loss(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]))
        v.backward()
        torch.testing.assert_close(values[s], v.detach(), rtol=0, atol=1e-5)
        got = [grads[0][s], *(g[s] for g in grads[1]), *(g[s] for g in grads[2])]
        for g, leaf in zip(got, leaves):
            torch.testing.assert_close(g, leaf.grad, rtol=0, atol=1e-5)


def test_stem_tail_function_under_vmap_grad(monkeypatch):
    """Under ``torch.func.grad_and_value`` the stem tail writes its code
    (``with_code`` is true, as under autograd), and the S models' gradients
    from one ``vmap`` equal per-model autograd. Where no gradient can flow
    and no transform is active, the forward runs without the Function and
    writes no code."""
    conv, gamma, beta = map(torch.from_numpy, _stem_models(8, S, 4, 40, 8))
    w = torch.from_numpy(np.random.default_rng(9).normal(size=(S, 4, 10, 8)).astype(np.float32))
    with_code = []
    apply = conv_stem_train._StemTail.apply

    def spy(*args):
        with_code.append(args[-1])
        return apply(*args)

    monkeypatch.setattr(conv_stem_train._StemTail, "apply", spy)
    calls = _spy(monkeypatch, conv_stem_train, "stem_tail_bwd_plain")
    fwd = conv_stem_train.stem_tail_fwd
    fwd_code = []

    def spy_fwd(*args, **kwargs):
        fwd_code.append(kwargs["with_code"] if "with_code" in kwargs else args[9])
        return fwd(*args, **kwargs)

    monkeypatch.setattr(conv_stem_train, "stem_tail_fwd", spy_fwd)

    def loss(conv, gamma, beta, w):
        with torch.no_grad():
            mean, var = _stats(conv)
        return (conv_stem_train.fused_stage_train(conv, gamma, beta, mean, var, 0.0, 4)
                * w).sum()

    grads, _ = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(conv, gamma, beta, w)
    assert with_code == [True]
    assert calls == [((S, 4, 40, 8), (S, 4, 10, 8), (S, 4, 10, 8)) + ((S, 8),) * 4]
    with torch.no_grad():
        conv_stem_train.fused_stage_train(conv, gamma, beta, *_stats(conv), 0.0, 4)
    assert with_code == [True] and fwd_code == [True, False]  # no gradient can flow: no code
    for s in range(S):
        leaves = [t[s].clone().requires_grad_() for t in (conv, gamma, beta)]
        loss(*leaves, w[s]).backward()
        for g, leaf in zip(grads, leaves):
            ref = leaf.grad
            assert (g[s] - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_infonce_function_under_vmap_grad(monkeypatch):
    """Each model's features and its own temperature: one ``vmap`` of the
    G=3 losses gives the per-model values and gradients (dtemp per model),
    with one kernel call of P = 3 S problems."""
    feats, labels, valid, temp = map(torch.from_numpy, _infonce_models(10, S, 3, 12, 8))
    calls = _spy(monkeypatch, contrastive, "infonce_plain")
    weights = torch.tensor([1.0, 2.0, 3.0])
    loss = lambda f, t, l, v: (contrastive.fused_supervised_infonce_multi(f, f, l, t, v)
                               * weights).sum()
    grads, values = vmap(grad_and_value(loss, argnums=(0, 1)))(feats, temp, labels, valid)
    assert calls == [((3 * S, 12, 8), (3 * S, 12, 8), (3 * S, 12), (3 * S, 12), (3 * S,))]
    for s in range(S):
        f, t = feats[s].clone().requires_grad_(), temp[s].clone().requires_grad_()
        v = loss(f, t, labels[s], valid[s])
        v.backward()
        torch.testing.assert_close(values[s], v.detach(), rtol=0, atol=1e-5)
        torch.testing.assert_close(grads[0][s], f.grad, rtol=0, atol=1e-5)
        torch.testing.assert_close(grads[1][s], t.grad, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# card: S-axis CUDA kernels against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# a ragged S and B, and the LOSO trainer's 24 models at the flagship layer
LSTM_MODELS = {"ragged": (3, 5, 7, 12, 64), "loso_layer": (24, 64, 73, 256, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(LSTM_MODELS))
def test_bilstm_model_axis_kernels_match_plain(cuda, shape):
    x, fwd, bwd, dh = _lstm_models(20, *LSTM_MODELS[shape])
    w = tuple(t.to(cuda) for t in _stacked(fwd, bwd))
    x, dh = torch.from_numpy(x).to(cuda), torch.from_numpy(dh).to(cuda)
    launches = lambda: (lstm.KERNEL.launches, lstm.CBND_KERNEL.launches,
                        lstm.SEGBWD_KERNEL.launches)
    with torch.no_grad():
        before = launches()
        h = lstm.bilstm_fwd(x, *w)
        c_bnd = lstm.bilstm_cbnd(x, h, *w)
        dx_pk, dw_cat = lstm.bilstm_segbwd(dh, x, h, c_bnd, *w)
        assert launches() == tuple(n + 1 for n in before)  # one launch for all S models
        h_ref = lstm.bilstm_fwd_plain(x, *w)
        c_ref = lstm.bilstm_cbnd_plain(x, h, *w)
        dx_ref, dw_ref = lstm.bilstm_segbwd_plain(dh, x, h, c_bnd, *w)
    torch.cuda.synchronize()
    torch.testing.assert_close(h, h_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(c_bnd, c_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(dx_pk, dx_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(dw_cat, dw_ref, rtol=1e-4, atol=1e-4 * dw_ref.abs().max().item())


STEM_CARD_MODELS = {"ragged": (3, 3, 11, 5, 3), "loso_stage1": (24, 64, 585, 64, 4),
                    "loso_stage2": (24, 64, 146, 256, 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.0, 0.4])
@pytest.mark.parametrize("shape", sorted(STEM_CARD_MODELS))
def test_stem_tail_model_axis_kernels_match_plain(cuda, shape, p):
    """Forward at p=0 against the plain version; the backward against its
    plain version fed the kernel's own code; at p > 0 every model keeps its
    own share 1 - p of elements (within 5 sigma, at pool 1), with masks
    that differ between models."""
    s_n, b, t, c, pool = STEM_CARD_MODELS[shape]
    conv, gamma, beta = (torch.from_numpy(a).to(cuda) for a in _stem_models(21, s_n, b, t, c))
    mean, var = _stats(conv)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        before = (conv_stem_train.KERNEL.launches, conv_stem_train.BWD_KERNEL.launches)
        out, code = conv_stem_train.stem_tail_fwd(conv, gamma, beta, mean, var, p, pool,
                                                  generator=gen)
        if p == 0.0:
            ref, ref_code = conv_stem_train.fused_stage_train_plain(
                conv, gamma, beta, mean, var, pool, 1e-5, with_code=True)
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
            assert (code != ref_code).double().mean().item() <= 1e-4
        else:
            # pool 1: each element is its own window, so the code's keep bit
            # is the element's: every model keeps its own share 1 - p
            _, code1 = conv_stem_train.stem_tail_fwd(conv, gamma, beta, mean, var, p, 1,
                                                     generator=gen)
            kept = code1 >= 1
            share = kept.double().mean((1, 2, 3))
            sigma = math.sqrt(p * (1 - p) / kept[0].numel())
            assert ((share - (1 - p)).abs() <= 5 * sigma).all()
            assert not torch.equal(kept[0], kept[1])
        inv = torch.rsqrt(var + 1e-5)
        scale, shift = gamma * inv, beta - mean * gamma * inv
        dpool = torch.randn(out.shape, device=cuda, generator=gen)
        got = conv_stem_train.stem_tail_bwd(conv, dpool, code, scale, shift, mean, inv, p, pool)
        assert (conv_stem_train.KERNEL.launches, conv_stem_train.BWD_KERNEL.launches) == (
            before[0] + 1 + (p > 0.0), before[1] + 1)
        want = conv_stem_train.stem_tail_bwd_plain(conv, dpool, code, scale, shift, mean, inv,
                                                   p, pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.sum(1), w.sum(1), rtol=1e-4, atol=1e-3)


INFONCE_CARD_MODELS = {"ragged": (3, 3, 37, 19), "loso_step": (24, 3, 64, 256)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(INFONCE_CARD_MODELS))
def test_infonce_model_axis_kernel_and_gradients(cuda, shape):
    """One launch of P = 3 S problems under ``vmap(grad_and_value)``, against
    the plain version's values and gradients."""
    s_n, g, b, d = INFONCE_CARD_MODELS[shape]
    rng = np.random.default_rng(22)
    feats = torch.from_numpy(rng.normal(size=(s_n, g, b, d)).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 3, (s_n, b))).to(cuda)
    labels[:, 0] = 7
    valid = torch.ones(s_n, b, device=cuda)
    valid[0, -3:] = 0.0
    temp = torch.from_numpy(rng.uniform(0.05, 0.2, s_n).astype(np.float32)).to(cuda)
    loss = lambda f, t, l, v: contrastive.fused_supervised_infonce_multi(f, f, l, t, v).sum()
    before = contrastive.KERNEL.launches
    grads, values = vmap(grad_and_value(loss, argnums=(0, 1)))(feats, temp, labels, valid)
    assert contrastive.KERNEL.launches == before + 1

    def plain(f, t):
        n = torch.nn.functional.normalize(f, dim=-1, eps=1e-12).reshape(s_n * g, b, d)
        per = lambda a: a[:, None].expand(s_n, g, *a.shape[1:]).reshape(s_n * g, *a.shape[1:])
        return contrastive.infonce_plain(n, n, per(labels), per(valid), per(t)).reshape(s_n, g)

    f, t = feats.clone().requires_grad_(), temp.clone().requires_grad_()
    ref = plain(f, t).sum(1)
    ref_g = torch.autograd.grad(ref.sum(), (f, t))
    torch.cuda.synchronize()
    torch.testing.assert_close(values, ref.detach(), rtol=0, atol=1e-4)
    for a, r in zip(grads, ref_g):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_loso_trainer_on_card_one_launch_per_call_without_host_sync(cuda):
    """A small LOSO trainer (3 subjects, feat_dim 32) on the card: every
    kernel call of a step is one launch for all models, the first epoch's
    per-subject losses match the same trainer on the CPU at dropout 0
    (rtol 1e-4: sums in other orders), and the fused epochs with the
    early-stop lanes run under ``set_sync_debug_mode("error")``."""
    from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset
    from multimodal_sentiment_aanalysis_tpu_torch.kernels import launch_counts, reset_launch_counts
    from multimodal_sentiment_aanalysis_tpu_torch.models import MultimodalTransformerModel
    from multimodal_sentiment_aanalysis_tpu_torch.train import VectorizedLOSOTrainer

    rng = np.random.default_rng(23)
    n = 3 * 8
    arrays = {"eeg": rng.normal(size=(n, 32, 64)).astype(np.float32),
              "eye": rng.normal(size=(n, 38)).astype(np.float32),
              "pps": rng.normal(size=(n, 230)).astype(np.float32),
              "arousal": rng.integers(0, 3, n), "valence": rng.integers(0, 3, n)}

    def make(device):
        model = MultimodalTransformerModel(feat_dim=32, eeg_time=64, dropout=0.0, device=device)
        return VectorizedLOSOTrainer(model, DeviceDataset(arrays, device), 3, 8, batch_size=8,
                                     seed=0, early_stop=True)

    card, cpu = make(cuda), make("cpu")
    reset_launch_counts()
    got, want = card.train_epoch(), cpu.train_epoch()
    steps = 2  # 16 train rows per subject, batch 8
    # rows 1, 9 and 11 launch their GEMM, recurrence, scan and sweep kernels
    # inside; the v9 layer backward computes the gates once for rows 9 and 11
    per_step = dict(bilstm_fwd=2, bilstm_cbnd=2, bilstm_segbwd=2, stem_tail=2, stem_tail_bwd=2,
                    infonce=1, bilstm_gemm=8, bilstm_rec=2, bilstm_sweep=2, bilstm_cscan=2)
    assert launch_counts() == {k: steps * per_step.get(k, 0) for k in launch_counts()}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = card.fused_epochs_on_device(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (2, 3, 9) and bool(torch.isfinite(out).all())

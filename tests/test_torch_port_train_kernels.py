"""The port's training kernels: BiLSTM backward, stem-tail train forward and
backward, supervised InfoNCE.

On the CPU, each module's plain version (and its ``autograd.Function`` on
CPU tensors, which runs the plain versions) is held against the JAX
package's Pallas kernels in interpret mode and against its jnp paths, on the
same numpy inputs. Tolerances, fp32 throughout:

- BiLSTM c checkpoints and reverse sweep 2e-5 absolute (summation order
  over a few steps); layer gradients 1e-4 absolute (7 steps of chained
  products, sums over B*T rows);
- stem tail values 1e-5 absolute (the Pallas kernel's polynomial erf is
  within 1.5e-7 of erf), gradients 1e-4 relative to the largest entry
  (sums over B*T rows);
- InfoNCE values 1e-5, gradients 1e-4 absolute (1/temperature = 10 scales
  the similarity rounding).

The ``gpu``-marked tests hold each CUDA kernel against its plain version on
the card at the training path's shapes, and each autograd path against the
plain path's gradients there. They skip without a card and import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_train_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_sentiment_aanalysis_tpu_torch.kernels import contrastive, conv_stem_train, lstm
from multimodal_sentiment_aanalysis_tpu_torch.ops import rnn
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# --------------------------------------------------------------------------
# inputs (numpy, from a seed)
# --------------------------------------------------------------------------


def _lstm_case(seed, b, t, i, h):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)
    fwd, bwd = ([mk(4 * h, i), mk(4 * h, h), mk(4 * h), mk(4 * h)] for _ in range(2))
    x = rng.normal(size=(b, t, i)).astype(np.float32)
    dh = rng.normal(size=(b, t, 2 * h)).astype(np.float32)
    return x, fwd, bwd, dh


def _stem_case(seed, b, t, c):
    rng = np.random.default_rng(seed)
    conv = rng.normal(size=(b, t, c)).astype(np.float32)
    gamma = (rng.normal(size=c) * 0.3 + 1).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    return conv, gamma, beta


def _batch_stats(conv: torch.Tensor):
    """``models/eeg.py``'s batch statistics, without gradient."""
    with torch.no_grad():
        mean = conv.mean((0, 1))
        return mean, (conv * conv).mean((0, 1)) - mean * mean


def _t(a, device="cpu", grad=False):
    return torch.tensor(np.asarray(a), device=device, requires_grad=grad)


# --------------------------------------------------------------------------
# CPU: BiLSTM backward against the JAX package
# --------------------------------------------------------------------------

B_L, T_L, I_L, H_L = 5, 7, 12, 16  # ragged B, T that neither K=2 nor K=4 divides


def _jax_layer_operands(x, fwd, bwd):
    """The JAX kernels' (S=1, T, B, ·) operands."""
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    h = jl.fused_bilstm_layer(jnp.asarray(x), tuple(map(jnp.asarray, fwd)),
                              tuple(map(jnp.asarray, bwd)), interpret=True, use_xproj=True)
    xt = jnp.swapaxes(jnp.asarray(x), 0, 1)[None]
    w_ih = jnp.stack([fwd[0].T, bwd[0].T])[None]
    w_hh = jnp.stack([fwd[1].T, bwd[1].T])[None]
    b = jnp.stack([fwd[2] + fwd[3], bwd[2] + bwd[3]])[:, None, :][None]
    return np.array(h), xt, jnp.swapaxes(h, 0, 1)[None], w_ih, w_hh, b


def _port_cbnd(c_jax, h):
    """JAX (1, NSEG, B, 2H) checkpoints -> the port's (2, NSEG, B, H)."""
    c = np.asarray(c_jax)[0]
    return torch.from_numpy(np.stack([c[..., :h], c[..., h:]]).copy())


@pytest.mark.parametrize("k", [2, 4])
def test_bilstm_cbnd_plain_matches_jax(k):
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, _ = _lstm_case(0, B_L, T_L, I_L, H_L)
    h, xt, hs, w_ih, w_hh, b = _jax_layer_operands(x, fwd, bwd)
    ref = _port_cbnd(jl._cbnd_call(xt, hs, w_ih, w_hh, b, k, True), H_L)
    w = lstm.stack_params(tuple(map(torch.from_numpy, fwd)), tuple(map(torch.from_numpy, bwd)))
    got = lstm.bilstm_cbnd_plain(torch.from_numpy(x), torch.from_numpy(h), *w, k)
    nseg = -(-T_L // k)
    assert got.shape == (2, nseg, B_L, H_L)
    # the slots a block reads: entries of blocks 1.. (d=0) and ..NSEG-2 (d=1)
    torch.testing.assert_close(got[0, : nseg - 1], ref[0, : nseg - 1], rtol=0, atol=2e-5)
    torch.testing.assert_close(got[1, 1:], ref[1, 1:], rtol=0, atol=2e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_bilstm_segbwd_plain_matches_jax(k):
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, dh = _lstm_case(1, B_L, T_L, I_L, H_L)
    h, xt, hs, w_ih, w_hh, b = _jax_layer_operands(x, fwd, bwd)
    c_jax = jl._cbnd_call(xt, hs, w_ih, w_hh, b, k, True)
    dh_t = np.swapaxes(dh, 0, 1)[None]
    dx_ref, dw_ref = (np.asarray(a)[0] for a in
                      jl._segbwd_call(dh_t, xt, hs, c_jax, w_ih, w_hh, b, k, True))
    w = lstm.stack_params(tuple(map(torch.from_numpy, fwd)), tuple(map(torch.from_numpy, bwd)))
    dx_pk, dw_cat = lstm.bilstm_segbwd_plain(torch.from_numpy(dh), torch.from_numpy(x),
                                             torch.from_numpy(h), _port_cbnd(c_jax, H_L), *w, k)
    for d in (0, 1):
        np.testing.assert_allclose(dx_pk[d].numpy(),
                                   np.swapaxes(dx_ref[..., d * I_L:(d + 1) * I_L], 0, 1),
                                   rtol=0, atol=2e-5)
    np.testing.assert_allclose(dw_cat.numpy(), dw_ref[:, : I_L + H_L + 1], rtol=0, atol=2e-5)


LAYER_PATHS = {"kernels.lstm.fused_bilstm_layer": lstm.fused_bilstm_layer,
               "ops.rnn.bilstm_layer": rnn.bilstm_layer}


@pytest.mark.parametrize("path", sorted(LAYER_PATHS))
def test_bilstm_layer_grad_matches_jax(path):
    """dx, dW_ih, dW_hh, db of both directions against ``jax.grad`` of the
    JAX kernel layer (interpret mode, v9 backward)."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, _ = _lstm_case(2, B_L, T_L, I_L, H_L)
    ref = jax.grad(lambda x, f, b: jnp.sum(jnp.sin(jl.fused_bilstm_layer(
        x, f, b, interpret=True, use_xproj=True))), argnums=(0, 1, 2))(
        jnp.asarray(x), tuple(map(jnp.asarray, fwd)), tuple(map(jnp.asarray, bwd)))
    tx = _t(x, grad=True)
    tf, tb = ([_t(a, grad=True) for a in p] for p in (fwd, bwd))
    torch.sin(LAYER_PATHS[path](tx, tuple(tf), tuple(tb))).sum().backward()
    got = [tx.grad, *(a.grad for a in tf), *(a.grad for a in tb)]
    for g, r in zip(got, jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)


# --------------------------------------------------------------------------
# CPU: stem tail against the JAX package
# --------------------------------------------------------------------------

# both call shapes scaled down (pool 4 at C=64, pool 2 at C=128) and a
# ragged T whose tail rows the pool drops; B a multiple of the JAX block
STEM_SHAPES = {"stage1": (8, 64, 64, 4), "stage2": (8, 32, 128, 2), "ragged": (8, 37, 64, 4)}


def _rel_close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-9)
    assert err < tol, err


@pytest.mark.parametrize("shape", sorted(STEM_SHAPES))
def test_stem_tail_train_matches_jax_kernel(shape):
    """p=0: values and d(conv, gamma, beta) of the port's autograd path
    against ``jax.grad`` through the JAX ``fused_stage_train`` (interpret)."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import conv_stem_train as jcst

    b, t, c, pool = STEM_SHAPES[shape]
    conv, gamma, beta = _stem_case(3, b, t, c)
    w = np.random.default_rng(4).normal(size=(b, t // pool, c)).astype(np.float32)
    seeds = jnp.zeros((8, 128), jnp.int32)

    def jax_stage(conv, gamma, beta):
        mean = conv.mean((0, 1))
        var = (conv ** 2).mean((0, 1)) - mean ** 2
        return jcst.fused_stage_train(conv, gamma, beta, jax.lax.stop_gradient(mean),
                                      jax.lax.stop_gradient(var), seeds, 0.0, pool, 1e-5, True)

    ref_out = jax_stage(*map(jnp.asarray, (conv, gamma, beta)))
    ref_g = jax.grad(lambda *a: jnp.sum(jax_stage(*a) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, (conv, gamma, beta)))
    tc, tg, tb = (_t(a, grad=True) for a in (conv, gamma, beta))
    out = conv_stem_train.fused_stage_train(tc, tg, tb, *_batch_stats(tc), 0.0, pool)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)
    for g, r in zip((tc.grad, tg.grad, tb.grad), ref_g):
        _rel_close(g.numpy(), r, 1e-4)


def test_stem_tail_dropout_matches_jnp_with_same_mask():
    """p=0.4: the port's autograd path draws its keep mask with
    ``torch.rand`` from the generator; the same draws as a numpy mask in the
    JAX jnp stage give the same values and gradients. The plain version fed
    that mask explicitly agrees too."""
    import jax
    import jax.numpy as jnp

    b, t, c, pool, p = 4, 37, 64, 4, 0.4
    conv, gamma, beta = _stem_case(5, b, t, c)
    keep = (torch.rand((b, t, c), generator=torch.Generator().manual_seed(6)) >= p).numpy()
    w = np.random.default_rng(7).normal(size=(b, t // pool, c)).astype(np.float32)

    def jnp_stage(conv, gamma, beta):  # models/eeg.py jnp path, mask given
        mean = conv.mean((0, 1))
        var = (conv ** 2).mean((0, 1)) - mean ** 2
        y = (conv - mean) * jax.lax.rsqrt(var + 1e-5) * gamma + beta
        a = jnp.where(keep, jax.nn.gelu(y, approximate=False) / (1.0 - p), 0.0)
        return a[:, : (t // pool) * pool].reshape(b, t // pool, pool, c).max(2)

    ref_out = jnp_stage(*map(jnp.asarray, (conv, gamma, beta)))
    ref_g = jax.grad(lambda *a: jnp.sum(jnp_stage(*a) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, (conv, gamma, beta)))
    tc, tg, tb = (_t(a, grad=True) for a in (conv, gamma, beta))
    out = conv_stem_train.fused_stage_train(tc, tg, tb, *_batch_stats(tc), p, pool,
                                            generator=torch.Generator().manual_seed(6))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)
    for g, r in zip((tc.grad, tg.grad, tb.grad), ref_g):
        _rel_close(g.numpy(), r, 1e-4)
    plain = conv_stem_train.fused_stage_train_plain(
        tc.detach(), tg.detach(), tb.detach(), *_batch_stats(tc), pool, 1e-5, p,
        torch.from_numpy(keep))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)


def test_stem_tail_code_packs_winner_and_keep_bit():
    """The forward's code is winner index + pool * keep bit, as the JAX
    kernel packs it; at p=0 the keep bit is always set."""
    conv, gamma, beta = map(torch.from_numpy, _stem_case(8, 2, 12, 3))
    mean, var = _batch_stats(conv)
    keep = torch.rand(conv.shape, generator=torch.Generator().manual_seed(9)) >= 0.5
    for p, k in ((0.0, None), (0.5, keep)):
        out, code = conv_stem_train.fused_stage_train_plain(conv, gamma, beta, mean, var, 3,
                                                            1e-5, p, k, with_code=True)
        a = F.gelu((conv - mean) * torch.rsqrt(var + 1e-5) * gamma + beta)
        kept = torch.ones_like(conv, dtype=torch.bool) if k is None else k
        a = torch.where(kept, a / (1 - p), 0.0).reshape(2, 4, 3, 3)
        win = code % 3
        assert torch.equal(a.gather(2, win[:, :, None].long()).squeeze(2), out)
        assert torch.equal(code >= 3, kept.reshape(2, 4, 3, 3).gather(
            2, win[:, :, None].long()).squeeze(2))


# --------------------------------------------------------------------------
# CPU: InfoNCE against the JAX package
# --------------------------------------------------------------------------

INFONCE_CASES = {
    # label 2 occurs once: its row has no positive, so the r_i term is live
    "singleton_label": (np.array([0, 1, 1, 2, 0, 1, 0, 0, 1, 1]), None),
    "padded_mask": (np.array([0, 1, 1, 0, 2, 2, 1, 0, 1, 2]),
                    np.array([1, 1, 1, 1, 1, 1, 1, 0, 0, 0], np.float32)),
}


@pytest.mark.parametrize("case", sorted(INFONCE_CASES))
def test_infonce_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels.contrastive import fused_supervised_infonce

    labels, mask = INFONCE_CASES[case]
    rng = np.random.default_rng(10)
    f1, f2 = (rng.normal(size=(10, 16)).astype(np.float32) for _ in range(2))
    jmask = None if mask is None else jnp.asarray(mask)
    ref, ref_g = jax.value_and_grad(
        lambda a, b, t: fused_supervised_infonce(a, b, jnp.asarray(labels), t, jmask),
        argnums=(0, 1, 2))(jnp.asarray(f1), jnp.asarray(f2), jnp.float32(0.1))
    t1, t2 = _t(f1, grad=True), _t(f2, grad=True)
    temp = torch.tensor(0.1, requires_grad=True)
    loss = contrastive.fused_supervised_infonce(
        t1, t2, torch.from_numpy(labels), temp, None if mask is None else torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=0, atol=1e-5)
    for g, r in zip((t1.grad, t2.grad, temp.grad), ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def test_infonce_multi_is_three_single_calls():
    """G=3 in one call == three G=1 calls, values and gradients (the
    three per-modality losses of a train step)."""
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(3, 12, 8)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 3, 12))
    mask = torch.tensor([1.0] * 9 + [0.0] * 3)
    a = _t(feats, grad=True)
    ta = torch.tensor(0.07, requires_grad=True)
    multi = contrastive.fused_supervised_infonce_multi(a, a, labels, ta, mask)
    (multi * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    b = _t(feats, grad=True)
    tb = torch.tensor(0.07, requires_grad=True)
    singles = torch.stack([contrastive.fused_supervised_infonce(b[g], b[g], labels, tb, mask)
                           for g in range(3)])
    (singles * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    torch.testing.assert_close(multi, singles, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(ta.grad, tb.grad, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# card: CUDA kernels against their plain versions; autograd on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# the training path's layer shapes (B=64, T=73 at full width) and a ragged one
LSTM_SHAPES = {"layer": (64, 73, 256, 128), "ragged": (5, 7, 12, 64)}


def _card_layer(cuda, shape, seed):
    x, fwd, bwd, dh = _lstm_case(seed, *LSTM_SHAPES[shape])
    fwd, bwd = (tuple(_t(a, cuda) for a in p) for p in (fwd, bwd))
    return _t(x, cuda), fwd, bwd, _t(dh, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, lstm.SEG_K])
@pytest.mark.parametrize("shape", sorted(LSTM_SHAPES))
def test_bilstm_bwd_kernels_match_plain(cuda, shape, k):
    x, fwd, bwd, dh = _card_layer(cuda, shape, 20)
    w = lstm.stack_params(fwd, bwd)
    with torch.no_grad():
        h = lstm.fused_bilstm_layer(x, fwd, bwd)
        before = (lstm.CBND_KERNEL.launches, lstm.SEGBWD_KERNEL.launches)
        c_bnd = lstm.bilstm_cbnd(x, h, *w, k)
        dx_pk, dw_cat = lstm.bilstm_segbwd(dh, x, h, c_bnd, *w, k)
        assert (lstm.CBND_KERNEL.launches, lstm.SEGBWD_KERNEL.launches) == (
            before[0] + 1, before[1] + 1)
        c_ref = lstm.bilstm_cbnd_plain(x, h, *w, k)
        dx_ref, dw_ref = lstm.bilstm_segbwd_plain(dh, x, h, c_bnd, *w, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(c_bnd, c_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(dx_pk, dx_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(dw_cat, dw_ref, rtol=1e-4, atol=1e-4 * dw_ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(LSTM_SHAPES))
def test_bilstm_gradients_on_card(cuda, shape):
    """The kernel path records gradients on the card and they match the
    plain path's (a CUDA tensor once returned a result without grad_fn)."""
    x, fwd, bwd, dh = _card_layer(cuda, shape, 21)
    leaves = [x, *fwd, *bwd]
    for t in leaves:
        t.requires_grad_()
    out = lstm.fused_bilstm_layer(x, fwd, bwd)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * dh).sum(), leaves)
    ref = torch.autograd.grad((lstm.fused_bilstm_layer_plain(x, fwd, bwd) * dh).sum(), leaves)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())


STEM_CARD_SHAPES = {"stage1": (64, 585, 64, 4), "stage2": (64, 146, 256, 2),
                    "ragged": (3, 11, 5, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.0, 0.4])
@pytest.mark.parametrize("shape", sorted(STEM_CARD_SHAPES))
def test_stem_tail_train_kernels_match_plain(cuda, shape, p):
    """Forward at p=0 against the plain version (values and code); the
    backward against its plain version fed the kernel's own code."""
    b, t, c, pool = STEM_CARD_SHAPES[shape]
    conv, gamma, beta = (_t(a, cuda) for a in _stem_case(22, b, t, c))
    mean, var = _batch_stats(conv)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        out, code = conv_stem_train.stem_tail_fwd(conv, gamma, beta, mean, var, p, pool,
                                                  generator=gen)
        if p == 0.0:
            ref, ref_code = conv_stem_train.fused_stage_train_plain(
                conv, gamma, beta, mean, var, pool, 1e-5, with_code=True)
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
            # the winner can differ only where two window entries tie within rounding
            assert (code != ref_code).double().mean().item() <= 1e-4
        inv = torch.rsqrt(var + 1e-5)
        scale, shift = gamma * inv, beta - mean * gamma * inv
        dpool = torch.randn(out.shape, device=cuda, generator=gen)
        got = conv_stem_train.stem_tail_bwd(conv, dpool, code, scale, shift, mean, inv, p, pool)
        want = conv_stem_train.stem_tail_bwd_plain(conv, dpool, code, scale, shift, mean, inv,
                                                   p, pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.sum(0), w.sum(0), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_stem_tail_dropout_keep_rate(cuda):
    """pool=1 on a stage-1-sized tensor: each output is exactly 0 or
    GELU(y) / (1 - p), and the keep share is 1 - p within 5 sigma."""
    p = 0.4
    conv, gamma, beta = (_t(a, cuda) for a in _stem_case(23, 64, 585, 64))
    mean, var = _batch_stats(conv)
    with torch.no_grad():
        out = conv_stem_train.fused_stage_train(conv, gamma, beta, mean, var, p, 1,
                                                generator=torch.Generator(device=cuda).manual_seed(1))
        full = conv_stem_train.fused_stage_train(conv, gamma, beta, mean, var, 0.0, 1) * (
            1.0 / (1.0 - p))  # the kernel's own scaling: one multiply by fp32 1/(1-p)
    kept = out != 0
    assert torch.equal(out[kept], full[kept])
    share, n = kept.double().mean().item(), out.numel()
    assert abs(share - (1 - p)) < 5 * math.sqrt(p * (1 - p) / n), share


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["stage1", "stage2"])
def test_stem_tail_gradients_on_card(cuda, shape):
    b, t, c, pool = STEM_CARD_SHAPES[shape]
    leaves = [_t(a, cuda, grad=True) for a in _stem_case(24, b, t, c)]
    conv, gamma, beta = leaves
    mean, var = _batch_stats(conv)
    w = torch.randn(b, t // pool, c, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    out = conv_stem_train.fused_stage_train(conv, gamma, beta, mean, var, 0.0, pool)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * w).sum(), leaves)
    y = (conv - conv.mean((0, 1))) * torch.rsqrt(
        (conv * conv).mean((0, 1)) - conv.mean((0, 1)) ** 2 + 1e-5) * gamma + beta
    ref = torch.autograd.grad((conv_stem_train.gelu_max_pool(y, pool) * w).sum(), leaves)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())


INFONCE_CARD = {"train_step": (3, 64, 256), "b512": (1, 512, 256), "ragged": (2, 37, 19)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(INFONCE_CARD))
def test_infonce_kernel_and_gradients_on_card(cuda, shape):
    g, b, d = INFONCE_CARD[shape]
    rng = np.random.default_rng(25)
    feats = _t(rng.normal(size=(g, b, d)).astype(np.float32), cuda, grad=True)
    labels = _t(rng.integers(0, 3, b), cuda)
    labels[0] = 7  # a label that occurs once
    mask = _t((np.arange(b) < b - 3).astype(np.float32), cuda)
    temp = torch.tensor(0.1, device=cuda, requires_grad=True)
    before = contrastive.KERNEL.launches
    loss = contrastive.fused_supervised_infonce_multi(feats, feats, labels, temp, mask)
    assert contrastive.KERNEL.launches == before + 1 and loss.grad_fn is not None
    got = torch.autograd.grad(loss.sum(), (feats, temp))
    n = F.normalize(feats, dim=2, eps=1e-12)
    ref_loss = contrastive.infonce_plain(n, n, labels, mask, temp)
    ref = torch.autograd.grad(ref_loss.sum(), (feats, temp))
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, ref_loss, rtol=0, atol=1e-5)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)

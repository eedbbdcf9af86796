"""Row 9, the BiLSTM's c checkpoints, as the gates GEMM and the c scan
(``lstm.bilstm_cscan``), and the v9 layer backward that computes the gate
activations once for rows 9 and 11 (``lstm.bilstm_v9_bwd``).

On the CPU, on seeded numpy inputs at S=2 models, B=5 (a ragged batch
tile), T=7 (a partial last segment for every K > 1), I=12, H=8:

- the scan's plain version over the plain gate activations against the JAX
  ``_cbnd_call`` (Pallas, interpret mode) under ``jax.vmap`` over the
  models, on the slots a block reads, at K = 1 to 4, fp32 and bf16: atol
  2e-5, as ``tests/test_torch_port_train_kernels.py`` (the same fp32
  arithmetic summed in other orders; c is fp32 in both dtypes);
- the composed v9 backward pieces (gates, scan, sweep, dx, dW_cat, all
  plain) against ``jax.vjp`` of the JAX layer (fp32, 2e-5 of each
  gradient's largest entry) and against ``bilstm_segbwd_plain`` (1e-5, as
  ``tests/test_torch_port_lstm_gemm.py``);
- the v9 backward Function under ``torch.func.vmap(grad_and_value)``: one
  S-wide call, gradients equal to per-model autograd (1e-5);
- the scan's refusals.

The ``gpu``-marked tests hold the scan kernel against its plain version
(rtol 0, atol 1e-6: both round f c and i g, then their sum), ``bilstm_cbnd``
against its plain version at S=1 and S=24 in fp32 and bf16 (1e-4), the v9
layer's gradients on the card against the CPU plain route, and count one v9
layer backward's launches. They skip without a card and import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_lstm_cscan.py``.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from multimodal_sentiment_aanalysis_tpu_torch import kernels
from multimodal_sentiment_aanalysis_tpu_torch.kernels import lstm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BF16 = torch.bfloat16
S, B, T, I, H = 2, 5, 7, 12, 8
DTYPES = {"fp32": torch.float32, "bf16": BF16}


def _case(seed, s=S, b=B, t=T, i=I, h=H, scale=0.3):
    """x, stacked weights (w_ih, w_hh, bias) and an output gradient, as numpy
    fp32; each direction has weights of its own."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape, sc=1.0: (sc * rng.normal(size=shape)).astype(np.float32)
    return (mk(s, b, t, i), mk(s, 2, 4 * h, i, sc=scale), mk(s, 2, 4 * h, h, sc=scale),
            mk(s, 2, 4 * h, sc=scale), mk(s, b, t, 2 * h))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _np(t):
    return t.detach().float().cpu().numpy()


def _read_slots(c, nseg):
    """The checkpoint slots some block reads: entries of blocks 1.. (d=0)
    and ..NSEG-2 (d=1)."""
    return c[:, 0, : nseg - 1], c[:, 1, 1:]


@contextlib.contextmanager
def _jax_v9():
    """The JAX package's default (v9) BiLSTM switches, restored on exit."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    old = jl._CBND_K, jl.enable_segbwd(True), jl.enable_bwdc(True)
    jl._CBND_K = 0
    try:
        yield jl
    finally:
        jl._CBND_K = old[0]
        jl.enable_segbwd(old[1])
        jl.enable_bwdc(old[2])


# --------------------------------------------------------------------------
# CPU: the scan and the composed backward against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cscan_plain_matches_jax(dtype, k):
    """The scan over the plain gate activations against ``_cbnd_call``
    under ``jax.vmap`` over the S models, from the same x and h_seq."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    dt = DTYPES[dtype]
    arrays = [_np(torch.from_numpy(a).to(dt)) for a in _case(0)[:4]]  # as dt rounds them
    x, *w = _torch(arrays, dt)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    got = lstm.bilstm_cscan_plain(act, k)
    nseg = -(-T // k)
    assert got.shape == (S, 2, nseg, B, H) and got.dtype == torch.float32

    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if dt == BF16 else jnp.asarray
    operands = (cast(np.swapaxes(arrays[0], 1, 2)), cast(np.swapaxes(_np(h_seq), 1, 2)),
                cast(np.swapaxes(arrays[1], -1, -2)), cast(np.swapaxes(arrays[2], -1, -2)),
                cast(arrays[3][:, :, None, :]))
    one = lambda *a: jl._cbnd_call(*(t[None] for t in a), k, True)[0]  # (NSEG, B, 2H)
    c_jax = np.asarray(jax.vmap(one)(*operands))
    ref = torch.from_numpy(np.stack([c_jax[..., :H], c_jax[..., H:]], 1).copy())
    for g, r in zip(_read_slots(got, nseg), _read_slots(ref, nseg)):
        torch.testing.assert_close(g, r, rtol=0, atol=2e-5)


def test_cscan_slots_and_model_axis():
    """Every slot follows ``bilstm_cbnd``'s rule: where K does not divide T,
    direction 0's last slot (read by no block) is zero; one model's scan is
    its slice of the S-model scan; the wrapper on a CPU tensor is the plain
    version and launches nothing."""
    x, *w, _ = _torch(_case(1), torch.float32)
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=lstm.bilstm_fwd_plain(x, *w))
    before = lstm.CSCAN_KERNEL.launches
    for k in (2, 3, 7):
        c = lstm.bilstm_cscan(act, k)
        assert torch.equal(c, lstm.bilstm_cscan_plain(act, k))
        assert bool((c[:, 0, -1] == 0).all()) == (T % k != 0)
        assert bool((c != 0).any(-1).any(-1)[:, 1].all())  # every d=1 slot holds a c
        for s in range(S):
            torch.testing.assert_close(lstm.bilstm_cscan(act[s], k), c[s], rtol=0, atol=0)
    assert lstm.CSCAN_KERNEL.launches == before


def _v9_pieces(dh, x, h_seq, w, k):
    """The v9 layer backward as its plain pieces: the gate activations once,
    the c scan over them, the sweep, dx and dW_cat."""
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    c_bnd = lstm.bilstm_cscan_plain(act, k)
    dg = lstm.bilstm_sweep_plain(act, dh, c_bnd, w[1], k)
    return (lstm.bilstm_gemm_plain("dx", x, *w, h_seq=h_seq, dg=dg),
            lstm.bilstm_gemm_plain("dw", x, *w, h_seq=h_seq, dg=dg))


@pytest.mark.parametrize("k", [3, lstm.SEG_K])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_v9_backward_pieces_match_segbwd_plain(dtype, k):
    """The composed pieces against the rows' plain versions
    (``bilstm_cbnd_plain`` then ``bilstm_segbwd_plain``) and against
    ``bilstm_v9_bwd`` on CPU tensors, which runs those."""
    dt = DTYPES[dtype]
    x, w_ih, w_hh, bias, dh = _torch(_case(2), dt)
    w = (w_ih, w_hh, bias)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    dx_pk, dw_cat = _v9_pieces(dh, x, h_seq, w, k)
    ref = lstm.bilstm_segbwd_plain(dh, x, h_seq, lstm.bilstm_cbnd_plain(x, h_seq, *w, k), *w, k)
    for got, want in zip((dx_pk, dw_cat), ref):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(want.abs().max().item(), 1))
    for got, want in zip(lstm.bilstm_v9_bwd(dh, x, h_seq, *w, k), ref):
        assert torch.equal(got, want)


def test_v9_backward_pieces_match_jax_layer_gradients():
    """dx, dW_ih, dW_hh and the bias gradient of each model from the composed
    pieces against ``jax.vjp`` of the JAX layer (its v9 schedule,
    interpret mode, the projection in its kernel) with the same output
    gradient."""
    import jax
    import jax.numpy as jnp

    x, w_ih, w_hh, bias, dh = _case(3)
    tw = _torch((w_ih, w_hh, bias), torch.float32)
    tx, tdh = _torch((x, dh), torch.float32)
    dx_pk, dw_cat = _v9_pieces(tdh, tx, lstm.bilstm_fwd_plain(tx, *tw), tw, lstm.SEG_K)
    with _jax_v9() as jl:
        for s in range(S):
            # torch-layout tuples: the bias split as b_ih = bias, b_hh = 0
            fwd, bwd = ((w_ih[s, d], w_hh[s, d], bias[s, d], np.zeros_like(bias[s, d]))
                        for d in (0, 1))
            args = jnp.asarray(x[s]), tuple(map(jnp.asarray, fwd)), tuple(map(jnp.asarray, bwd))
            _, vjp = jax.vjp(lambda *a: jl.fused_bilstm_layer(*a, interpret=True, use_xproj=True),
                              *args)
            jdx, jfwd, jbwd = vjp(jnp.asarray(dh[s]))
            got = [dx_pk[s, 0] + dx_pk[s, 1]]
            want = [jdx]
            for d, jd in enumerate((jfwd, jbwd)):
                got += [dw_cat[s, d, :I].T, dw_cat[s, d, I:I + H].T, dw_cat[s, d, I + H],
                        dw_cat[s, d, I + H]]
                want += list(jd)
            for g, r in zip(got, want):
                r = np.asarray(r, np.float32)
                np.testing.assert_allclose(_np(g), r, rtol=0,
                                           atol=2e-5 * max(np.abs(r).max(), 1.0))


def test_v9_backward_function_under_vmap_grad(monkeypatch):
    """x and every weight's gradient of S models through one
    ``vmap(grad_and_value)`` of the v9 layer equal S per-model autograd
    runs; the layer backward's Function runs rows 9 and 11's plain versions
    once each, with all S models; and its ``vmap`` rule, called directly,
    gives what ``bilstm_v9_bwd`` gives on the stacked tensors."""
    x, w_ih, w_hh, bias, dh = _torch(_case(4), torch.float32)
    fwd = (w_ih[:, 0], w_hh[:, 0], bias[:, 0], torch.zeros_like(bias[:, 0]))
    bwd = (w_ih[:, 1], w_hh[:, 1], bias[:, 1], torch.zeros_like(bias[:, 1]))
    calls = {}
    for name in ("bilstm_cbnd_plain", "bilstm_segbwd_plain"):
        fn, seen = getattr(lstm, name), []
        calls[name] = seen

        def spy(*args, fn=fn, seen=seen, **kw):
            seen.append(tuple(a.shape for a in args if isinstance(a, torch.Tensor)))
            return fn(*args, **kw)

        monkeypatch.setattr(lstm, name, spy)
    loss = lambda x, f, b: (lstm.fused_bilstm_layer(x, f, b, schedule="v9") * dh[0]).sum()
    grads, values = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(x, fwd, bwd)
    for seen in calls.values():
        assert len(seen) == 1 and all(shape[0] == S for shape in seen[0])
    for s in range(S):
        leaves = [x[s].clone().requires_grad_(),
                  *(t[s].clone().requires_grad_() for t in (*fwd, *bwd))]
        v = loss(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]))
        v.backward()
        torch.testing.assert_close(values[s], v.detach(), rtol=0, atol=1e-5)
        got = [grads[0][s], *(g[s] for g in grads[1]), *(g[s] for g in grads[2])]
        for g, leaf in zip(got, leaves):
            torch.testing.assert_close(g, leaf.grad, rtol=0, atol=1e-5)

    w = (w_ih, w_hh, bias)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    rule = vmap(lambda *a: lstm._V9Bwd.apply(*a, lstm.SEG_K), in_dims=(0, 0, 0, 0, 0, None))
    got = rule(dh, x, h_seq, w_ih, w_hh, bias[0])  # an unbatched bias, expanded to S models
    want = lstm.bilstm_v9_bwd(dh, x, h_seq, w_ih, w_hh, bias[:1].expand(S, -1, -1))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_cscan_refusals():
    """A non-fp32 ``act`` is a ``TypeError``; another shape or K < 1 a
    ``ValueError``, on the CPU as on the card."""
    act = torch.zeros(S, B, T, 8 * H)
    for bad in (act.to(BF16), act.double()):
        with pytest.raises(TypeError):
            lstm.bilstm_cscan(bad)
    for bad in (act[..., :-1], act[0, 0], act[None], act[:, :0]):
        with pytest.raises(ValueError):
            lstm.bilstm_cscan(bad)
    for k in (0, -1):
        with pytest.raises(ValueError):
            lstm.bilstm_cscan(act, k)


# --------------------------------------------------------------------------
# card: the kernels against their plain versions, and the launches
# --------------------------------------------------------------------------

SHAPES = {"small": (S, B, T, I, H), "layer": (1, 64, 73, 256, 128),
          "loso_layer": (24, 64, 73, 256, 128)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _card_case(cuda, shape, dtype, seed):
    s, b, t, i, h = SHAPES[shape]
    x, w_ih, w_hh, bias, dh = _torch(_case(seed, s, b, t, i, h, scale=0.1), DTYPES[dtype], cuda)
    return x, (w_ih, w_hh, bias), dh


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, lstm.SEG_K])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cscan_kernel_matches_plain(cuda, shape, k):
    x, w, _ = _card_case(cuda, shape, "fp32", 40)
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=lstm.bilstm_fwd_plain(x, *w))
    before = lstm.CSCAN_KERNEL.launches
    got = lstm.bilstm_cscan(act, k)
    assert lstm.CSCAN_KERNEL.launches == before + 1
    want = lstm.bilstm_cscan_plain(act, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", ["layer", "loso_layer"])
def test_cbnd_matches_plain(cuda, shape, dtype):
    """Row 9 on the card is the gates GEMM and the scan, within 1e-4 of
    its plain version; the call counts as row 9 alone (rows 6 and 10,
    which launch the same two pieces, count nothing)."""
    dt = DTYPES[dtype]
    x, w, _ = _card_case(cuda, shape, dtype, 41)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    counts = lambda: (lstm.CBND_KERNELS[dt].launches, lstm.GEMM_KERNELS[dt].launches,
                      lstm.CSCAN_KERNEL.launches, lstm.CSEQ_KERNEL.launches,
                      lstm.CBNDK_KERNEL.launches)
    before = counts()
    got = lstm.bilstm_cbnd(x, h_seq, *w)
    assert counts() == tuple(n + e for n, e in zip(before, (1, 1, 1, 0, 0)))
    want = lstm.bilstm_cbnd_plain(x, h_seq, *w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "layer"])
def test_v9_layer_gradients_on_card(cuda, shape):
    """Every gradient of the v9 layer on the card against the CPU plain
    route, at the bar of ``test_bilstm_gradients_on_card``."""
    x, w, dh = _card_case(cuda, shape, "fp32", 42)
    fwd = (w[0][:, 0], w[1][:, 0], w[2][:, 0], torch.zeros_like(w[2][:, 0]))
    bwd = (w[0][:, 1], w[1][:, 1], w[2][:, 1], torch.zeros_like(w[2][:, 1]))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t[0].to(dev).requires_grad_() for t in (x, *fwd, *bwd)]
        out = lstm.fused_bilstm_layer(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]))
        grads.append(torch.autograd.grad((out * dh[0].to(dev)).sum(), leaves))
    torch.cuda.synchronize()
    for g, r in zip(*grads):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-4 * r.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_v9_layer_backward_launches(cuda, dtype):
    """One v9 layer backward of S models under ``vmap(grad)``: three GEMM
    launches, one scan, one sweep, one call of rows 9 and 11 each, and no
    call of rows 6 and 10 (the same pieces under the v8, v6 and v9.1
    schedules)."""
    dt = DTYPES[dtype]
    x, w, dh = _card_case(cuda, "small", dtype, 43)
    fwd = (w[0][:, 0], w[1][:, 0], w[2][:, 0], torch.zeros_like(w[2][:, 0]))
    bwd = (w[0][:, 1], w[1][:, 1], w[2][:, 1], torch.zeros_like(w[2][:, 1]))
    loss = lambda x, f, b, g: (lstm.fused_bilstm_layer(x, f, b).float() * g).sum()
    kernels.reset_launch_counts()
    with torch.no_grad():
        lstm.bilstm_fwd(x, *w)  # the forward's share of the counts
    forward = kernels.launch_counts()
    kernels.reset_launch_counts()
    vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(x, fwd, bwd, dh.float())
    torch.cuda.synchronize()
    got = {n: c - forward[n] for n, c in kernels.launch_counts().items() if c - forward[n]}
    sfx = "_bf16" if dt == BF16 else ""
    assert got == {f"bilstm_cbnd{sfx}": 1, f"bilstm_segbwd{sfx}": 1, f"bilstm_gemm{sfx}": 3,
                   "bilstm_cscan": 1, f"bilstm_sweep{sfx}": 1}

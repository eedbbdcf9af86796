"""Rows 5 and 6 of the kernel table as the v9 rows' pieces at K = 1.

Row 5, the v5 reverse sweep (``lstm.bilstm_bwd_xp``, the JAX package's
``_bwd_kernel``), is on a CUDA tensor the GEMM's ``"gates_xp"`` product
(the gate activations of ``xp + h_prev W_hh^T`` for every (b, t)) then
``bilstm_sweep`` at K = 1 over the v5 forward's full ``c_seq``. Row 6, the
full c of v8 and v6 (``lstm.bilstm_cseq``, ``_cseq_kernel``), is the
``"gates"`` product then ``bilstm_cscan`` at K = 1. The v8 and v6 layer
backwards (``lstm.bilstm_v8_bwd``, ``lstm.bilstm_v6_bwd``) compute the gate
activations once for row 6's scan and the sweep of row 8 or row 7.

On the CPU, fp32, on seeded numpy inputs at two shapes (``ragged``: S=3,
B=5, T=11, I=12, H=64; ``small``: S=2, B=8, T=9, I=16, H=8), these
compositions of the plain pieces are held against

- ``"gates_xp"``: the gate activations built by ``lstm._gates`` from ``xp``
  (an identity input product) and the stored ``h_prev`` (1e-6: the same
  products), and the ``"gates"`` product of the ``x`` whose projection is
  ``xp`` (1e-5: the same sums in another order);
- row 5: ``bilstm_bwd_xp_plain``, which recomputes each step's gates
  inside its walk (1e-5 of max |ref|), and JAX ``_bwd_call`` in interpret
  mode on the same operands (1e-4, the reverse sweeps' bar in
  ``tests/test_torch_port_lstm_schedules.py``);
- row 6: ``bilstm_cscan_plain(gates, 1)`` against JAX ``_cseq_call``
  (1e-5, a forward-order sweep);
- the shared-gates v8 and v6 backwards against row 6 then row 8 or row 7
  called separately (1e-5 of max |ref|), and against ``jax.vjp`` of the
  JAX layer with its switch set and restored, the port's layer gradients
  taken from them as the layer's backward takes them (1e-4);
- v5, v6 and v8 under ``torch.func.vmap(grad_and_value)`` against
  per-model autograd of the v9 layer (1e-5), each backward row entered
  once with all S models;
- row 5's validation before any launch, and its hidden limit, which is now
  the sweep's cluster plan (as rows 7 and 8's is).

The ``gpu``-marked tests hold rows 5 and 6 and the two layer backwards
against their plain versions on the card, count their launches, and run row
5 at H = 256, which its per-block walk refused. They skip without a card and
import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_lstm_rows56.py``.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from multimodal_sentiment_aanalysis_tpu_torch import kernels
from multimodal_sentiment_aanalysis_tpu_torch.kernels import lstm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SHAPES = {"ragged": (3, 5, 11, 12, 64), "small": (2, 8, 9, 16, 8)}


def _arrays(seed, s, b, t, i, h, scale=0.3):
    """x, stacked weights (w_ih, w_hh, bias) and an output gradient, as numpy
    fp32; each direction has weights of its own."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape, sc=1.0: (sc * rng.normal(size=shape)).astype(np.float32)
    return (mk(s, b, t, i), mk(s, 2, 4 * h, i, sc=scale), mk(s, 2, 4 * h, h, sc=scale),
            mk(s, 2, 4 * h, sc=scale), mk(s, b, t, 2 * h))


def _operands(seed, s, b, t, i, h, device="cpu", scale=0.3):
    """``(dh, x, h_seq, w)`` of S models, ``w = (w_ih, w_hh, bias)``, and
    the v5 forward's ``(xp, h_seq_xp, c_seq)``: the projection, then the
    recurrence over it storing c (the plain versions)."""
    x, w_ih, w_hh, bias, dh = (torch.from_numpy(a).to(device)
                               for a in _arrays(seed, s, b, t, i, h, scale))
    w = (w_ih, w_hh, bias)
    with torch.no_grad():
        h_seq = lstm.bilstm_fwd_plain(x, *w)
        xp = lstm._projection(x, w_ih, bias)
        h_xp, c_xp = lstm.bilstm_fwd_xp_plain(xp, w_hh)
    return dh, x, h_seq, w, (xp, h_xp, c_xp)


def _close_rel(got, want, rel):
    torch.testing.assert_close(got, want, rtol=0, atol=rel * max(want.abs().max().item(), 1.0))


def _close_np(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


def _tb(a):
    """The port's ``(S, B, T, ·)`` as the JAX kernels' ``(S, T, B, ·)``."""
    import jax.numpy as jnp

    return jnp.asarray(np.swapaxes(np.asarray(a), 1, 2))


def _wt(w):
    """Stacked weights ``(S, 2, 4H, K)`` as the JAX kernels' ``(S, 2, K, 4H)``."""
    import jax.numpy as jnp

    return jnp.asarray(np.swapaxes(w.numpy(), -1, -2))


def _packed_c(c_seq):
    """The port's ``c_seq (S, 2, T, B, H)`` packed ``[fwd | bwd]`` along the
    last axis, ``(S, T, B, 2H)``, as the JAX kernels store it."""
    import jax.numpy as jnp

    return jnp.asarray(np.concatenate([c_seq[:, 0].numpy(), c_seq[:, 1].numpy()], -1))


@contextlib.contextmanager
def _jax_schedule(schedule):
    """The JAX package's switches for ``schedule`` (v8 or v6), restored on
    exit."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    old = jl.enable_segbwd(schedule != "v8"), jl.enable_bwdc(schedule != "v6")
    try:
        yield
    finally:
        jl.enable_segbwd(old[0])
        jl.enable_bwdc(old[1])


# --------------------------------------------------------------------------
# CPU: the "gates_xp" product
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gates_xp_plain_matches_gates(shape):
    """The ``"gates_xp"`` plain product is ``_gates`` over ``xp`` (an identity
    input product, no bias) and the stored ``h_prev`` of each direction, and
    the ``"gates"`` product of the ``x`` whose projection ``xp`` is; on CPU
    tensors ``bilstm_gemm`` is the plain version and reads no ``x``,
    ``w_ih`` or ``bias``."""
    _, x, h_seq, w, (xp, _, _) = _operands(10, *SHAPES[shape])
    w_hh = w[1]
    s, _, _, _, h = SHAPES[shape]
    got = lstm.bilstm_gemm_plain("gates_xp", None, None, w_hh, None, h_seq=h_seq, xp=xp)
    assert got.shape == xp.shape and got.dtype == torch.float32
    eye, zero = torch.eye(4 * h).expand(s, -1, -1), torch.zeros(s, 4 * h)
    want = torch.cat([torch.cat(lstm._gates(xp[..., 4 * d * h:4 * (d + 1) * h],
                                            lstm._h_prev(h_seq, d, h), eye, w_hh[:, d], zero),
                                -1) for d in (0, 1)], -1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    _close_rel(got, lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq), 1e-5)
    assert torch.equal(lstm.bilstm_gemm("gates_xp", None, None, w_hh, None, h_seq=h_seq, xp=xp),
                       got)
    one = lstm.bilstm_gemm_plain("gates_xp", None, None, w_hh[0], None, h_seq=h_seq[0], xp=xp[0])
    torch.testing.assert_close(one, got[0], rtol=0, atol=0)


# --------------------------------------------------------------------------
# CPU: row 5 and row 6 as their pieces, against the plain rows and JAX
# --------------------------------------------------------------------------


def _row5_pieces(dh, xp, h_seq, c_seq, w_hh):
    """Row 5 as its plain pieces: the gates from xp, the sweep at K=1."""
    act = lstm.bilstm_gemm_plain("gates_xp", None, None, w_hh, None, h_seq=h_seq, xp=xp)
    return lstm.bilstm_sweep_plain(act, dh, c_seq, w_hh, 1)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_row5_pieces_match_plain_and_jax(shape):
    """The gates from ``xp`` then the sweep at K=1 over the v5 forward's
    ``c_seq`` against ``bilstm_bwd_xp_plain`` and the Pallas ``_bwd_call``
    (interpret mode); ``bilstm_bwd_xp`` on CPU tensors is the plain
    version."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    dh, _, _, w, (xp, h_seq, c_seq) = _operands(11, *SHAPES[shape])
    s, b, t, _, h = SHAPES[shape]
    got = _row5_pieces(dh, xp, h_seq, c_seq, w[1])
    assert got.shape == (s, b, t, 8 * h)
    ref = lstm.bilstm_bwd_xp_plain(dh, xp, h_seq, c_seq, w[1])
    _close_rel(got, ref, 1e-5)
    assert torch.equal(lstm.bilstm_bwd_xp(dh, xp, h_seq, c_seq, w[1]), ref)
    jax_ref = jl._bwd_call(_tb(dh), _tb(xp), _tb(h_seq), _packed_c(c_seq), _wt(w[1]), True)
    _close_np(got, np.swapaxes(np.asarray(jax_ref), 1, 2), 1e-4)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_row6_scan_matches_jax_cseq(shape):
    """``bilstm_cscan_plain`` at K=1 over the plain gate activations is
    ``bilstm_cseq_plain`` and JAX ``_cseq_call``'s c, slot for slot;
    ``bilstm_cseq`` on CPU tensors is the plain version."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    _, x, h_seq, w, _ = _operands(12, *SHAPES[shape])
    s, b, t, _, h = SHAPES[shape]
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    got = lstm.bilstm_cscan_plain(act, 1)
    assert got.shape == (s, 2, t, b, h)
    assert torch.equal(got, lstm.bilstm_cseq_plain(x, h_seq, *w))
    assert torch.equal(lstm.bilstm_cseq(x, h_seq, *w), got)
    w_ih, w_hh, bias = w
    c_jax = np.asarray(jl._cseq_call(_tb(x), _tb(h_seq), _wt(w_ih), _wt(w_hh),
                                     bias.numpy()[:, :, None, :], True))
    _close_np(got, np.stack([c_jax[..., :h], c_jax[..., h:]], 1), 1e-5)


# --------------------------------------------------------------------------
# CPU: the v8 and v6 layer backwards on one gate GEMM
# --------------------------------------------------------------------------


def _shared_pieces(schedule, dh, x, h_seq, w):
    """The v8 (``(dx_pk, dW_cat)``) or v6 (``dxp``) layer backward as the
    card composes it, in plain pieces: the gate activations once, the c
    scan over them at K=1, the sweep at K=1 over that c, and for v8 the dx
    and dW_cat products."""
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    dg = lstm.bilstm_sweep_plain(act, dh, lstm.bilstm_cscan_plain(act, 1), w[1], 1)
    if schedule == "v6":
        return dg
    return (lstm.bilstm_gemm_plain("dx", x, *w, h_seq=h_seq, dg=dg),
            lstm.bilstm_gemm_plain("dw", x, *w, h_seq=h_seq, dg=dg))


def _separate_rows(schedule, dh, x, h_seq, w):
    """Row 6, then row 8 (v8) or row 7 (v6) over its c, as plain versions."""
    c_seq = lstm.bilstm_cseq_plain(x, h_seq, *w)
    row = lstm.bilstm_bwdc_plain if schedule == "v8" else lstm.bilstm_bwd_split_plain
    return row(dh, x, h_seq, c_seq, *w)


def _layer_grads(schedule, out, x, h_seq, w):
    """dx, then per direction dW_ih, dW_hh and db, from the v8 ``(dx_pk,
    dW_cat)`` or the v6 ``dxp`` of one model, as the layer's backward takes
    them."""
    w_ih = w[0]
    i, h = x.shape[-1], w[1].shape[-1]
    if schedule == "v6":
        dg = out.unflatten(-1, (2, -1))
        return (torch.einsum("btdg,dgi->bti", dg, w_ih), torch.einsum("btdg,bti->dgi", dg, x),
                lstm._dw_hh_packed(h_seq, out), dg.sum((0, 1)))
    dx_pk, dw_cat = out
    return (dx_pk[0] + dx_pk[1], dw_cat[:, :i].transpose(1, 2), dw_cat[:, i:i + h].transpose(1, 2),
            dw_cat[:, i + h])


@pytest.mark.parametrize("schedule", ["v8", "v6"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shared_gates_backward_matches_rows_and_jax(shape, schedule):
    """The layer backward on one gate GEMM, composed from the plain pieces,
    against row 6 then row 8 or row 7 called separately, and, for the first
    model, against ``jax.vjp`` of the JAX layer under the schedule's
    switch; the port's function on CPU tensors is row 6 then row 8 or 7."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    dh, x, h_seq, w, _ = _operands(13, *SHAPES[shape])
    got = _shared_pieces(schedule, dh, x, h_seq, w)
    ref = _separate_rows(schedule, dh, x, h_seq, w)
    fn = lstm.bilstm_v8_bwd if schedule == "v8" else lstm.bilstm_v6_bwd
    port = fn(dh, x, h_seq, *w)
    for g, r, p in zip(*(((a,) if isinstance(a, torch.Tensor) else a) for a in (got, ref, port))):
        _close_rel(g, r, 1e-5)
        assert torch.equal(p, r)

    one = lambda a: a[0] if isinstance(a, torch.Tensor) else tuple(t[0] for t in a)
    grads = _layer_grads(schedule, one(got), x[0], h_seq[0], one(w))
    w_ih, w_hh, bias = (t[0].numpy() for t in w)
    zero = np.zeros_like(bias[0])
    dirs = [tuple(jnp.asarray(a) for a in (w_ih[d], w_hh[d], bias[d], zero)) for d in (0, 1)]
    with _jax_schedule(schedule):
        layer = lambda *a: jl.fused_bilstm_layer(*a, interpret=True, use_xproj=True)
        _, vjp = jax.vjp(layer, jnp.asarray(x[0].numpy()), *dirs)
        dx, dfwd, dbwd = vjp(jnp.asarray(dh[0].numpy()))
    _close_np(grads[0], dx, 1e-4)
    for d, dd in enumerate((dfwd, dbwd)):
        _close_np(grads[1][d], dd[0], 1e-4)
        _close_np(grads[2][d], dd[1], 1e-4)
        _close_np(grads[3][d], dd[2], 1e-4)
        _close_np(grads[3][d], dd[3], 1e-4)


def _spy(monkeypatch, name):
    calls, fn = [], getattr(lstm, name)

    def spy(*args, **kw):
        calls.append(tuple(a.shape for a in args if isinstance(a, torch.Tensor)))
        return fn(*args, **kw)

    monkeypatch.setattr(lstm, name, spy)
    return calls


# the plain versions of each schedule's backward rows
BACKWARD_ROWS = {"v8": ("bilstm_cseq_plain", "bilstm_bwdc_plain"),
                 "v6": ("bilstm_cseq_plain", "bilstm_bwd_split_plain"),
                 "v5": ("bilstm_bwd_xp_plain",)}


@pytest.mark.parametrize("schedule", sorted(BACKWARD_ROWS))
def test_rows56_schedules_under_vmap_grad(monkeypatch, schedule):
    """x and every weight's gradient of S models through one
    ``vmap(grad_and_value)`` of the layer under ``schedule`` equal per-model
    autograd of the v9 layer; the layer backward enters each of its rows'
    plain versions once, with all S models."""
    dh, x, _, w, _ = _operands(14, *SHAPES["small"])
    s = x.shape[0]
    fwd = (w[0][:, 0], w[1][:, 0], w[2][:, 0], torch.zeros_like(w[2][:, 0]))
    bwd = (w[0][:, 1], w[1][:, 1], w[2][:, 1], torch.zeros_like(w[2][:, 1]))
    loss = lambda x, f, b, sch: (torch.sin(lstm.fused_bilstm_layer(x, f, b, schedule=sch))
                                 * dh[0]).sum()
    calls = {n: _spy(monkeypatch, n) for n in BACKWARD_ROWS[schedule]}
    grads, values = vmap(grad_and_value(lambda *a: loss(*a, schedule), argnums=(0, 1, 2)))(
        x, fwd, bwd)
    for n, c in calls.items():
        assert len(c) == 1 and all(shape[0] == s for shape in c[0]), n
    for m in range(s):
        leaves = [x[m].clone().requires_grad_(),
                  *(t[m].clone().requires_grad_() for t in (*fwd, *bwd))]
        v = loss(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]), "v9")
        v.backward()
        torch.testing.assert_close(values[m], v.detach(), rtol=0, atol=1e-5)
        got = [grads[0][m], *(g[m] for g in grads[1]), *(g[m] for g in grads[2])]
        for g, leaf in zip(got, leaves):
            torch.testing.assert_close(g, leaf.grad, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# CPU: row 5's validation, its hidden limit, and no launch for CPU tensors
# --------------------------------------------------------------------------


def _bwd_xp_refusals():
    """(operands, error) that row 5 refuses before any launch."""
    dh, _, _, w, (xp, h_seq, c_seq) = _operands(15, *SHAPES["small"])
    bf = lambda t: t.to(torch.bfloat16)
    w_hh = w[1]
    h = w_hh.shape[-1]
    return {
        "bf16 w_hh": ((dh, xp, h_seq, c_seq, bf(w_hh)), TypeError),
        "bf16 dh_seq": ((bf(dh), xp, h_seq, c_seq, w_hh), TypeError),
        "c_seq slots": ((dh, xp, h_seq, c_seq[:, :, :-1].contiguous(), w_hh), ValueError),
        "c_seq batch-first": ((dh, xp, h_seq, c_seq.transpose(2, 3).contiguous(), w_hh),
                              ValueError),
        "xp width": ((dh, xp[..., :-8].contiguous(), h_seq, c_seq, w_hh), ValueError),
        "hidden size not a 4-vector": (
            (dh[..., :2 * (h - 2)].contiguous(), xp[..., :8 * (h - 2)].contiguous(),
             h_seq[..., :2 * (h - 2)].contiguous(), c_seq[..., :h - 2].contiguous(),
             w_hh[:, :, :4 * (h - 2), :h - 2].contiguous()), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bwd_xp_refusals()))
def test_bwd_xp_refusals(case):
    """Row 5 validates its operands before the first launch: ``xp``,
    ``w_hh`` and ``dh_seq`` of one dtype (a bf16 ``w_hh`` or ``dh_seq`` beside
    fp32 ``xp`` is refused), the full fp32 ``c_seq (S, 2, T, B, H)``, ``xp``
    of 8H columns, a hidden size the GEMM reads as 4-vectors."""
    args, error = _bwd_xp_refusals()[case]
    with pytest.raises(error):
        lstm._check_bwd_xp(*args)


@pytest.mark.parametrize("h, refused", [(128, False), (256, False), (384, True)])
def test_bwd_xp_hidden_limit_is_the_sweep_plan(monkeypatch, h, refused):
    """Row 5 takes the hidden sizes the cluster sweep plans for (``W_hh``
    resident across at most 8 CTAs on the H100's 132 SMs), as rows 7 and 8
    do, past the H <= 128 of its per-block walk: H=256 passes validation in
    fp32 at B=64, H=384 is refused before any launch."""
    monkeypatch.setattr(lstm, "_sm_count", lambda index: lstm.H100_SMS)
    s, b, t = 2, 64, 2
    z = lambda *shape: torch.zeros(shape)
    args = (z(s, b, t, 2 * h), z(s, b, t, 8 * h), z(s, b, t, 2 * h), z(s, 2, t, b, h),
            z(s, 2, 4 * h, h))
    if refused:
        with pytest.raises(ValueError, match="no cluster"):
            lstm._check_bwd_xp(*args)
    else:
        lstm._check_bwd_xp(*args)


def test_cpu_rows56_launch_nothing():
    """On CPU tensors rows 5 and 6 and the shared-gates backwards take the
    plain versions: no count moves."""
    dh, x, h_seq, w, (xp, h_xp, c_xp) = _operands(16, *SHAPES["small"])
    kernels.reset_launch_counts()
    lstm.bilstm_bwd_xp(dh, xp, h_xp, c_xp, w[1])
    lstm.bilstm_cseq(x, h_seq, *w)
    lstm.bilstm_v8_bwd(dh, x, h_seq, *w)
    lstm.bilstm_v6_bwd(dh, x, h_seq, *w)
    lstm.bilstm_gemm("gates_xp", None, None, w[1], None, h_seq=h_xp, xp=xp)
    assert not any(kernels.launch_counts().values())


# --------------------------------------------------------------------------
# card: rows 5 and 6 and the layer backwards against their plain versions
# --------------------------------------------------------------------------

# (S, B, T, I, H): ragged; the LOSO layer at full width over two models;
# row 5 at H = 256, which its per-block walk refused (H <= 128)
CARD_SHAPES = {"ragged": (3, 5, 11, 12, 64), "layer": (2, 64, 73, 256, 128),
               "h256": (2, 16, 9, 32, 256)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _card_operands(cuda, shape, seed):
    return _operands(seed, *CARD_SHAPES[shape], device=cuda, scale=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_bwd_xp_kernel_matches_plain(cuda, shape):
    """Row 5 on the card, one S-wide call: one ``"gates_xp"`` GEMM and one
    sweep at K=1, one call of the row; dxp within 1e-4 of the plain version
    (at H = 256 too)."""
    dh, _, _, w, (xp, h_seq, c_seq) = _card_operands(cuda, shape, 70)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = lstm.bilstm_bwd_xp(dh, xp, h_seq, c_seq, w[1])
        torch.cuda.synchronize()
        assert {n: c for n, c in kernels.launch_counts().items() if c} == {
            "bilstm_bwd_xp": 1, "bilstm_gemm": 1, "bilstm_sweep": 1}
        want = lstm.bilstm_bwd_xp_plain(dh, xp, h_seq, c_seq, w[1])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ragged", "layer"])
def test_cseq_kernel_matches_plain(cuda, shape):
    """Row 6 on the card: one ``"gates"`` GEMM and one c scan at K=1, one
    call of the row; c_seq within 1e-4 of the plain version."""
    _, x, h_seq, w, _ = _card_operands(cuda, shape, 71)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = lstm.bilstm_cseq(x, h_seq, *w)
        torch.cuda.synchronize()
        assert {n: c for n, c in kernels.launch_counts().items() if c} == {
            "bilstm_cseq": 1, "bilstm_gemm": 1, "bilstm_cscan": 1}
        want = lstm.bilstm_cseq_plain(x, h_seq, *w)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["v8", "v6"])
@pytest.mark.parametrize("shape", ["ragged", "layer"])
def test_shared_gates_backward_matches_rows_on_card(cuda, shape, schedule):
    """The v8 and v6 layer backwards on the card against row 6 then row 8 or
    row 7 in plain versions: dxp and dx within 1e-4, dW_cat within 1e-4 of
    its largest entry (it sums B*T rows); one gate GEMM for both rows."""
    dh, x, h_seq, w, _ = _card_operands(cuda, shape, 72)
    fn = lstm.bilstm_v8_bwd if schedule == "v8" else lstm.bilstm_v6_bwd
    row = "bilstm_bwdc" if schedule == "v8" else "bilstm_bwd_split"
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = fn(dh, x, h_seq, *w)
        torch.cuda.synchronize()
        assert {n: c for n, c in kernels.launch_counts().items() if c} == {
            "bilstm_cseq": 1, row: 1, "bilstm_gemm": 3 if schedule == "v8" else 1,
            "bilstm_cscan": 1, "bilstm_sweep": 1}
        want = _separate_rows(schedule, dh, x, h_seq, w)
    got, want = ((a,) if isinstance(a, torch.Tensor) else a for a in (got, want))
    for k, (g, r) in enumerate(zip(got, want)):
        if k == 1:  # dW_cat
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=1e-4)

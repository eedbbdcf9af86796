"""Rows 8 and 7, the v8 and v6 reverse sweeps (``lstm.bilstm_bwdc``,
``lstm.bilstm_bwd_split``), as row 11's pieces at K = 1 over the full c.

Row 6's ``c_seq (S, 2, T, B, H)`` is the checkpoints of ``bilstm_cbnd`` at
K = 1 (slot t is c at actual time t in both directions), so on a CUDA
tensor row 8 is the gates GEMM, ``bilstm_sweep(k=1)`` over ``c_seq``, then
the dx and dW_cat GEMMs, and row 7 the gates GEMM and that sweep.

On the CPU, fp32, on seeded numpy inputs at two shapes (``ragged``: S=3,
B=5, T=11, I=12, H=64; ``small``: S=2, B=8, T=9, I=16, H=8):

- the composed plain pieces against ``bilstm_bwdc_plain`` (1e-5 of max
  |ref|: the same products summed in another order) and against JAX
  ``_bwd_bwdc_call`` in interpret mode on the same operands (dx 1e-4,
  dW_cat 1e-3 absolute: dW_cat sums B*T rows);
- gates then sweep against ``bilstm_bwd_split_plain`` (1e-5 of max |ref|)
  and JAX ``_bwd_xproj_call`` (1e-4);
- ``c_seq`` as the K = 1 checkpoints: ``bilstm_cseq_plain`` equal to
  ``bilstm_cbnd_plain(k=1)``, the forward recurrence's c and JAX
  ``_cseq_call`` slot for slot (1e-5), and the sweep over either c equal
  (direction 1 enters segment m from slot m + 1, c at actual time m + 1);
- the v8 and v6 layer under ``torch.func.vmap(grad_and_value)`` against
  per-model autograd of the v9 layer (1e-5), and the ``vmap`` rule of each
  one's layer backward (``bilstm_v8_bwd``, ``bilstm_v6_bwd``: rows 6 and 8,
  or 6 and 7, on one gate GEMM);
- the refusals that come before any launch.

The ``gpu``-marked tests count each row's launches (row 8: 3 GEMMs and 1
sweep; row 7: 1 GEMM and 1 sweep; row 6: 1 GEMM and 1 c scan; row 5: 1
GEMM and 1 sweep; nothing else) and each layer backward's (the gate GEMM
once), and hold rows 8 and 7 against their plain versions at
``CARD_SHAPES``. They skip without a card and import no
JAX: ``python -m pytest --noconftest -m gpu tests/test_torch_port_lstm_fullc.py``.
"""

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


def _operands(seed, shape, device="cpu"):
    """``(dh, x, h_seq, c_seq, w_ih, w_hh, bias)`` of S models: the plain
    forward's ``h_seq`` and row 6's plain ``c_seq``."""
    x, w_ih, w_hh, bias, dh = (torch.from_numpy(a).to(device)
                               for a in _arrays(seed, *SHAPES[shape]))
    w = (w_ih, w_hh, bias)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    return dh, x, h_seq, lstm.bilstm_cseq_plain(x, h_seq, *w), *w


def _to_jax(dh, x, h_seq, c_seq, w_ih, w_hh, bias):
    """The same operands in the JAX kernels' ``(S, T, B, ·)`` layouts, the
    weights transposed, c packed ``[fwd | bwd]`` along its last axis."""
    import jax.numpy as jnp

    n = lambda t: t.detach().numpy()
    tb = lambda t: jnp.asarray(np.swapaxes(n(t), 1, 2))
    return (tb(dh), tb(x), tb(h_seq), jnp.asarray(np.concatenate([n(c_seq[:, 0]), n(c_seq[:, 1])],
                                                                 -1)),
            jnp.asarray(np.swapaxes(n(w_ih), -1, -2)), jnp.asarray(np.swapaxes(n(w_hh), -1, -2)),
            jnp.asarray(n(bias)[:, :, None, :]))


def _pieces(dh, x, h_seq, c_seq, w_ih, w_hh, bias, row):
    """Row 8 (``row="bwdc"``: dx_pk, dW_cat) or row 7 (``"split"``: dxp) as
    its plain pieces: the gate activations, the sweep at K=1 over c_seq,
    then for row 8 the dx and dW_cat products."""
    w = (w_ih, w_hh, bias)
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    dg = lstm.bilstm_sweep_plain(act, dh, c_seq, w_hh, 1)
    if row == "split":
        return dg
    return (lstm.bilstm_gemm_plain("dx", x, *w, h_seq=h_seq, dg=dg),
            lstm.bilstm_gemm_plain("dw", x, *w, h_seq=h_seq, dg=dg))


def _close_rel(got, want, rel):
    torch.testing.assert_close(got, want, rtol=0, atol=rel * max(want.abs().max().item(), 1.0))


def _close_np(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


# --------------------------------------------------------------------------
# CPU: the composed pieces against the rows' plain versions and JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bwdc_pieces_match_plain_and_jax(shape):
    """Row 8: gates, sweep at K=1, dx, dW_cat against ``bilstm_bwdc_plain``
    and the Pallas ``_bwd_bwdc_call`` (interpret mode) on the same
    operands; ``bilstm_bwdc`` on CPU tensors is the plain version."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    ops = _operands(0, shape)
    s, b, t, i, h = SHAPES[shape]
    dx_pk, dw_cat = _pieces(*ops, row="bwdc")
    assert dx_pk.shape == (s, 2, b, t, i) and dw_cat.shape == (s, 2, i + h + 1, 4 * h)
    ref = lstm.bilstm_bwdc_plain(*ops)
    for got, want in zip((dx_pk, dw_cat), ref):
        _close_rel(got, want, 1e-5)
    for got, want in zip(lstm.bilstm_bwdc(*ops), ref):
        assert torch.equal(got, want)

    dx_ref, dw_ref = (np.asarray(a) for a in jl._bwd_bwdc_call(*_to_jax(*ops), True))
    for d in (0, 1):
        _close_np(dx_pk[:, d], np.swapaxes(dx_ref[..., d * i:(d + 1) * i], 1, 2), 1e-4)
    _close_np(dw_cat, dw_ref[:, :, :i + h + 1], 1e-3)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bwd_split_pieces_match_plain_and_jax(shape):
    """Row 7: gates then the sweep at K=1 against ``bilstm_bwd_split_plain``
    (each step's gates from ``x W_ih^T + b + h_prev W_hh^T``) and the Pallas
    ``_bwd_xproj_call`` (interpret mode)."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    ops = _operands(1, shape)
    s, b, t, _, h = SHAPES[shape]
    dxp = _pieces(*ops, row="split")
    assert dxp.shape == (s, b, t, 8 * h)
    ref = lstm.bilstm_bwd_split_plain(*ops)
    _close_rel(dxp, ref, 1e-5)
    assert torch.equal(lstm.bilstm_bwd_split(*ops), ref)
    _close_np(dxp, np.swapaxes(np.asarray(jl._bwd_xproj_call(*_to_jax(*ops), True)), 1, 2), 1e-4)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cseq_is_the_k1_checkpoints(shape):
    """Row 6's ``c_seq`` is ``bilstm_cbnd_plain`` at K=1 (every slot a
    boundary in both directions), the forward recurrence's c in actual time
    and JAX ``_cseq_call``'s, slot for slot; the sweep at K=1 over the
    forward's c equals the sweep over ``c_seq`` and row 7's plain version,
    which reads c_prev of direction 1 at actual time a + 1 explicitly."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    dh, x, h_seq, c_seq, w_ih, w_hh, bias = _operands(2, shape)
    s, b, t, _, h = SHAPES[shape]
    assert c_seq.shape == (s, 2, t, b, h)
    assert torch.equal(c_seq, lstm.bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias, 1))
    _, c_fwd = lstm._recurrence_plain(lstm._projection(x, w_ih, bias), w_hh)
    torch.testing.assert_close(c_seq, c_fwd, rtol=0, atol=1e-5)
    _, jx, jh, _, *jw = _to_jax(dh, x, h_seq, c_seq, w_ih, w_hh, bias)
    c_jax = np.asarray(jl._cseq_call(jx, jh, *jw, True))
    _close_np(c_seq, np.stack([c_jax[..., :h], c_jax[..., h:]], 1), 1e-5)

    act = lstm.bilstm_gemm_plain("gates", x, w_ih, w_hh, bias, h_seq=h_seq)
    dg = lstm.bilstm_sweep_plain(act, dh, c_seq, w_hh, 1)
    _close_rel(lstm.bilstm_sweep_plain(act, dh, c_fwd, w_hh, 1), dg, 1e-5)
    _close_rel(lstm.bilstm_bwd_split_plain(dh, x, h_seq, c_fwd, w_ih, w_hh, bias), dg, 1e-5)


# --------------------------------------------------------------------------
# CPU: the v8 and v6 layer under vmap, the rows' vmap rules, the refusals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["v8", "v6"])
def test_full_c_layer_under_vmap_grad(schedule):
    """x and every weight's gradient of S models through one
    ``vmap(grad_and_value)`` of the layer under ``schedule`` equal per-model
    autograd of the v9 layer (the same function); the ``vmap`` rule of the
    layer backward's Function, called directly with an unbatched bias,
    gives what its wrapper gives on the stacked tensors."""
    s = SHAPES["small"][0]
    dh, x, h_seq, c_seq, w_ih, w_hh, bias = _operands(3, "small")
    fwd = (w_ih[:, 0], w_hh[:, 0], bias[:, 0], torch.zeros_like(bias[:, 0]))
    bwd = (w_ih[:, 1], w_hh[:, 1], bias[:, 1], torch.zeros_like(bias[:, 1]))
    loss = lambda x, f, b, sch: (lstm.fused_bilstm_layer(x, f, b, schedule=sch) * dh[0]).sum()
    grads, values = vmap(grad_and_value(lambda *a: loss(*a, schedule), argnums=(0, 1, 2)))(
        x, fwd, bwd)
    for m in range(s):
        leaves = [x[m].clone().requires_grad_(),
                  *(t[m].clone().requires_grad_() for t in (*fwd, *bwd))]
        v = loss(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]), "v9")
        v.backward()
        torch.testing.assert_close(values[m], v.detach(), rtol=0, atol=1e-5)
        got = [grads[0][m], *(g[m] for g in grads[1]), *(g[m] for g in grads[2])]
        for g, leaf in zip(got, leaves):
            torch.testing.assert_close(g, leaf.grad, rtol=0, atol=1e-5)

    fn, wrapper = ((lstm._V8Bwd, lstm.bilstm_v8_bwd) if schedule == "v8"
                   else (lstm._V6Bwd, lstm.bilstm_v6_bwd))
    rule = vmap(fn.apply, in_dims=(0,) * 5 + (None,))
    got = rule(dh, x, h_seq, w_ih, w_hh, bias[0])
    want = wrapper(dh, x, h_seq, w_ih, w_hh, bias[:1].expand(s, -1, -1))
    for g, r in zip(*(((a,) if isinstance(a, torch.Tensor) else a) for a in (got, want))):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def _refusal_cases():
    """(operands, error) that rows 7 and 8 refuse before any launch."""
    dh, x, h_seq, c_seq, w_ih, w_hh, bias = _operands(4, "small")
    bf = lambda *ts: [t.to(torch.bfloat16) for t in ts]
    return {
        "fp16 layer": ((*(t.half() for t in (dh, x, h_seq)), c_seq,
                        *(t.half() for t in (w_ih, w_hh, bias))), TypeError),
        "bf16 dh_seq": ((*bf(dh), x, h_seq, c_seq, w_ih, w_hh, bias), TypeError),
        "bf16 c_seq": ((dh, x, h_seq, *bf(c_seq), w_ih, w_hh, bias), TypeError),
        "c_seq slots": ((dh, x, h_seq, c_seq[:, :, :-1].contiguous(), w_ih, w_hh, bias),
                        ValueError),
        "c_seq batch-first": ((dh, x, h_seq, c_seq.transpose(2, 3).contiguous(), w_ih, w_hh,
                               bias), ValueError),
        "input width": ((dh, x[..., :-2].contiguous(), h_seq, c_seq,
                         w_ih[..., :-2].contiguous(), w_hh, bias), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_full_c_refusals(case):
    """Rows 7 and 8 validate their operands before the first launch: one
    dtype, fp32 or bf16, for the layer's operands and ``dh_seq``, an fp32
    ``c_seq`` of ``(S, 2, T, B, H)``, the GEMM's 4-vector widths."""
    args, error = _refusal_cases()[case]
    with pytest.raises(error):
        lstm._check_full_c(*args)


@pytest.mark.parametrize("h, refused", [(256, False), (384, True)])
def test_full_c_hidden_limit_is_the_sweep_plan(monkeypatch, h, refused):
    """Rows 7 and 8 take the hidden sizes the cluster sweep plans for (its
    ``W_hh`` resident across at most 8 CTAs, on the H100's 132 SMs), past
    the 4H <= 512 threads of a per-block walk: H=256 passes validation in
    fp32 at B=64, H=384 is refused before any launch."""
    monkeypatch.setattr(lstm, "_sm_count", lambda index: lstm.H100_SMS)
    s, b, t, i = 2, 64, 2, 4
    z = lambda *shape: torch.zeros(shape)
    args = (z(s, b, t, 2 * h), z(s, b, t, i), z(s, b, t, 2 * h), z(s, 2, t, b, h),
            z(s, 2, 4 * h, i), z(s, 2, 4 * h, h), z(s, 2, 4 * h))
    if refused:
        with pytest.raises(ValueError, match="no cluster"):
            lstm._check_full_c(*args)
    else:
        lstm._check_full_c(*args)


# --------------------------------------------------------------------------
# card: each row against its plain version, and its launches
# --------------------------------------------------------------------------

# (S, B, T, I, H): ragged, and the LOSO layer at full width over two models
CARD_SHAPES = {"ragged": (3, 5, 11, 12, 64), "layer": (2, 64, 73, 256, 128)}
ROWS = ("bilstm_bwdc", "bilstm_bwd_split")
# each row's call counter, its operands from _card_operands' and the pieces
# one call launches
ROW_LAUNCHES = {
    "bilstm_bwdc": (lstm.BWDC_KERNEL, lambda dh, x, h, c, *w: (dh, x, h, c, *w),
                    {"bilstm_gemm": 3, "bilstm_sweep": 1}),
    "bilstm_bwd_split": (lstm.BWD_SPLIT_KERNEL, lambda dh, x, h, c, *w: (dh, x, h, c, *w),
                         {"bilstm_gemm": 1, "bilstm_sweep": 1}),
    "bilstm_cseq": (lstm.CSEQ_KERNEL, lambda dh, x, h, c, *w: (x, h, *w),
                    {"bilstm_gemm": 1, "bilstm_cscan": 1}),
    "bilstm_bwd_xp": (lstm.BWD_XP_KERNEL,
                      lambda dh, x, h, c, *w: (dh, lstm._projection(x, w[0], w[2]), h, c, w[1]),
                      {"bilstm_gemm": 1, "bilstm_sweep": 1}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _card_operands(cuda, shape, seed):
    x, w_ih, w_hh, bias, dh = (torch.from_numpy(a).to(cuda)
                               for a in _arrays(seed, *CARD_SHAPES[shape], scale=0.1))
    with torch.no_grad():
        h_seq = lstm.bilstm_fwd_plain(x, w_ih, w_hh, bias)
        c_seq = lstm.bilstm_cseq_plain(x, h_seq, w_ih, w_hh, bias)
    return dh, x, h_seq, c_seq, w_ih, w_hh, bias


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ROWS))
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_full_c_row_matches_plain(cuda, shape, name):
    """One S-wide call against the plain version on the same card tensors:
    row 7's dxp and row 8's dx at 1e-4, dW_cat at 1e-4 of its largest entry
    (``tests/test_torch_port_lstm_schedules.py``'s bars)."""
    ops = _card_operands(cuda, shape, 60)
    with torch.no_grad():
        got, want = getattr(lstm, name)(*ops), getattr(lstm, name + "_plain")(*ops)
    torch.cuda.synchronize()
    got, want = ((g,) if isinstance(g, torch.Tensor) else g for g in (got, want))
    for k, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == r.shape
        if k == 1:  # dW_cat: sums over B*T rows
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ROW_LAUNCHES))
def test_full_c_row_launches(cuda, name):
    """One call of row 8 launches 3 GEMMs and 1 sweep, one of row 7 or row 5
    1 GEMM and 1 sweep, one of row 6 1 GEMM and 1 c scan, and counts one
    call of the row; nothing else launches."""
    counter, args, pieces = ROW_LAUNCHES[name]
    ops = args(*_card_operands(cuda, "ragged", 61))
    kernels.reset_launch_counts()
    with torch.no_grad():
        getattr(lstm, name)(*ops)
    torch.cuda.synchronize()
    assert counter.launches == 1
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {name: 1, **pieces}


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["v8", "v6"])
def test_full_c_layer_backward_launches(cuda, schedule):
    """One layer backward of S models under ``vmap(grad)``: one call of row 6
    and one of row 8 (v8) or row 7 (v6) on one gate GEMM: v8 the gates, the
    c scan, the sweep, dx and dW_cat; v6 the gates, the c scan and the
    sweep; no v9, v9.1 or v5 kernel."""
    dh, x, _, _, w_ih, w_hh, bias = _card_operands(cuda, "ragged", 62)
    fwd = (w_ih[:, 0], w_hh[:, 0], bias[:, 0], torch.zeros_like(bias[:, 0]))
    bwd = (w_ih[:, 1], w_hh[:, 1], bias[:, 1], torch.zeros_like(bias[:, 1]))
    loss = lambda x, f, b, g: (lstm.fused_bilstm_layer(x, f, b, schedule=schedule) * g).sum()
    kernels.reset_launch_counts()
    with torch.no_grad():
        lstm.bilstm_fwd(x, w_ih, w_hh, bias)  # the forward's share of the counts
    forward = kernels.launch_counts()
    kernels.reset_launch_counts()
    vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(x, fwd, bwd, dh)
    torch.cuda.synchronize()
    got = {n: c - forward[n] for n, c in kernels.launch_counts().items() if c - forward[n]}
    row, gemms = ("bilstm_bwdc", 3) if schedule == "v8" else ("bilstm_bwd_split", 1)
    assert got == {"bilstm_cseq": 1, row: 1, "bilstm_gemm": gemms, "bilstm_cscan": 1,
                   "bilstm_sweep": 1}

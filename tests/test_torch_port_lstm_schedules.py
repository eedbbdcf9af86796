"""The BiLSTM's five kernel schedules (``fused_bilstm_layer(schedule=)``)
and the six kernels that only the schedules other than v9 run.

On the CPU, each of the six kernels' plain versions, with the model axis S,
is held against the JAX package's Pallas call with its own model axis, in
interpret mode, on the same numpy inputs (layouts converted between the two
packages); the layer's output and every gradient under each schedule are
held against the JAX layer with the matching switch set (and restored);
and each schedule's ``autograd.Function`` runs under
``torch.func.vmap(grad_and_value)`` with one S-wide call of each of its
plain kernels. Tolerances, fp32:

- forward-order sweeps (the v5 forward, the full c and the time-blocked
  checkpoints) 1e-5 absolute: the same products summed in another order;
- reverse sweeps (dxp of v5 and v6; dx and dW_cat of v8) 1e-4 absolute:
  a few steps of chained products, and dW_cat sums over B*T rows;
- layer outputs and gradients against JAX 1e-4, ``vmap`` gradients against
  per-model autograd 1e-5 (as ``tests/test_torch_port_vloso_kernels.py``).

The ``gpu``-marked tests hold each kernel against its plain version on the
card with a model axis, at a ragged shape and at full width, and each
schedule's layer gradients on the card against the plain path's. They skip
without a card and import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_lstm_schedules.py``.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from multimodal_sentiment_aanalysis_tpu_torch.eval.serving import build_serving_forward
from multimodal_sentiment_aanalysis_tpu_torch.kernels import lstm
from multimodal_sentiment_aanalysis_tpu_torch.models import MultimodalTransformerModel
from multimodal_sentiment_aanalysis_tpu_torch.ops import rnn
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

S, B, T, I, H = 3, 5, 7, 12, 16  # ragged B and T, as in the S-axis tests
T_KC = 11  # a T that CBNDK_ROWS does not divide into whole blocks, over two blocks
H_WIDE = 192  # a hidden size row 10's old per-block walk refused (4H > 512 threads)


def _models(seed, s=S, b=B, t=T, i=I, h=H):
    """``s`` models' ``x (S, B, T, I)``, torch-layout ``fwd``/``bwd`` tuples
    of ``(S, ...)`` arrays and ``dh (S, B, T, 2H)``; the two directions'
    weights differ, so a flipped direction shows."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: (0.3 * rng.normal(size=(s, *shape))).astype(np.float32)
    fwd, bwd = ([mk(4 * h, i), mk(4 * h, h), mk(4 * h), mk(4 * h)] for _ in range(2))
    x = rng.normal(size=(s, b, t, i)).astype(np.float32)
    dh = rng.normal(size=(s, b, t, 2 * h)).astype(np.float32)
    return x, fwd, bwd, dh


def _one_model(seed, **shape):
    """:func:`_models` of one model, without the model axis."""
    x, fwd, bwd, dh = _models(seed, s=1, **shape)
    return x[0], [a[0] for a in fwd], [a[0] for a in bwd], dh[0]


def _stacked(fwd, bwd):
    """The port's S-axis ``(w_ih (S, 2, 4H, I), w_hh, bias)``."""
    f, b = (tuple(map(torch.from_numpy, p)) for p in (fwd, bwd))
    return (torch.stack([f[0], b[0]], 1), torch.stack([f[1], b[1]], 1),
            torch.stack([f[2] + f[3], b[2] + b[3]], 1))


def _split_dirs(a, h):
    """JAX packed ``(..., 2H)`` -> the port's direction axis at 1: ``(S, T,
    B, 2H)`` to ``(S, 2, T, B, H)``."""
    a = np.asarray(a)
    return torch.from_numpy(np.stack([a[..., :h], a[..., h:]], 1).copy())


def _swap(a):
    """``(S, T, B, ·)`` <-> ``(S, B, T, ·)``."""
    return torch.from_numpy(np.swapaxes(np.asarray(a), 1, 2).copy())


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX kernels' operands of S models (``(S, T, B, ·)`` layouts),
    their ``h_seq`` and full ``c_seq`` from the JAX kernels, at T and at
    T_KC, and at T_KC with H_WIDE (key ``"h192"``), with the port's operands
    of the same models."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    out = {}
    for key, t, hid in ((T, T, H), (T_KC, T_KC, H), ("h192", T_KC, H_WIDE)):
        x, fwd, bwd, dh = _models(10 + t, t=t, h=hid)
        h = jax.vmap(lambda x, f, b: jl.fused_bilstm_layer(x, f, b, interpret=True,
                                                           use_xproj=True))(
            jnp.asarray(x), tuple(map(jnp.asarray, fwd)), tuple(map(jnp.asarray, bwd)))
        tr = lambda a: jnp.swapaxes(jnp.asarray(a), -1, -2)
        w_ih = jnp.stack([tr(fwd[0]), tr(bwd[0])], 1)  # (S, 2, I, 4H)
        w_hh = jnp.stack([tr(fwd[1]), tr(bwd[1])], 1)  # (S, 2, H, 4H)
        b = jnp.stack([fwd[2] + fwd[3], bwd[2] + bwd[3]], 1)[:, :, None, :]
        xt, hs = jnp.swapaxes(jnp.asarray(x), 1, 2), jnp.swapaxes(h, 1, 2)
        # the packed v5 projection, both halves in actual time
        xp = jnp.concatenate([xt @ w_ih[:, d][:, None] + b[:, d][:, None] for d in (0, 1)], -1)
        c_seq = jl._cseq_call(xt, hs, w_ih, w_hh, b, True)
        out[key] = dict(
            jax=(xt, hs, w_ih, w_hh, b, xp, c_seq, jnp.swapaxes(jnp.asarray(dh), 1, 2)),
            port=(torch.from_numpy(x), torch.from_numpy(np.array(h)), _stacked(fwd, bwd),
                  _swap(xp), _split_dirs(c_seq, hid), torch.from_numpy(dh)))
    return out


@contextlib.contextmanager
def _jax_schedule(schedule):
    """The JAX package's switches for ``schedule``, restored on exit; yields
    its ``use_xproj``."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    old = jl._CBND_K, jl.enable_segbwd(schedule != "v8"), jl.enable_bwdc(schedule != "v6")
    jl._CBND_K = lstm.CBNDK_ROWS if schedule == "v9.1" else 0
    try:
        yield schedule != "v5"
    finally:
        jl._CBND_K = old[0]
        jl.enable_segbwd(old[1])
        jl.enable_bwdc(old[2])


# --------------------------------------------------------------------------
# CPU: each kernel's plain version against its Pallas call
# --------------------------------------------------------------------------


def _check_fwd_xp(jl, j, p):
    xt, hs, w_ih, w_hh, b, xp, c_seq, dh = j
    h_ref, c_ref = jl._fwd_call(xp, w_hh, True)
    h_seq, c = lstm.bilstm_fwd_xp_plain(p[3], p[2][1])
    assert h_seq.shape == (S, B, T, 2 * H) and c.shape == (S, 2, T, B, H)
    _close(h_seq, _swap(h_ref), 1e-5)
    _close(c, _split_dirs(c_ref, H), 1e-5)


def _check_bwd_xp(jl, j, p):
    xt, hs, w_ih, w_hh, b, xp, c_seq, dh = j
    ref = jl._bwd_call(dh, xp, hs, c_seq, w_hh, True)
    got = lstm.bilstm_bwd_xp_plain(p[5], p[3], p[1], p[4], p[2][1])
    assert got.shape == (S, B, T, 8 * H)
    _close(got, _swap(ref), 1e-4)


def _check_cseq(jl, j, p):
    got = lstm.bilstm_cseq_plain(p[0], p[1], *p[2])
    assert got.shape == (S, 2, T, B, H)
    _close(got, p[4], 1e-5)


def _check_bwd_split(jl, j, p):
    xt, hs, w_ih, w_hh, b, xp, c_seq, dh = j
    ref = jl._bwd_xproj_call(dh, xt, hs, c_seq, w_ih, w_hh, b, True)
    got = lstm.bilstm_bwd_split_plain(p[5], p[0], p[1], p[4], *p[2])
    _close(got, _swap(ref), 1e-4)


def _check_bwdc(jl, j, p):
    xt, hs, w_ih, w_hh, b, xp, c_seq, dh = j
    dx_ref, dw_ref = (np.asarray(a) for a in jl._bwd_bwdc_call(dh, xt, hs, c_seq, w_ih, w_hh, b,
                                                                True))
    dx_pk, dw_cat = lstm.bilstm_bwdc_plain(p[5], p[0], p[1], p[4], *p[2])
    assert dx_pk.shape == (S, 2, B, T, I) and dw_cat.shape == (S, 2, I + H + 1, 4 * H)
    for d in (0, 1):
        _close(dx_pk[:, d], _swap(dx_ref[..., d * I:(d + 1) * I]), 1e-4)
    _close(dw_cat, dw_ref[:, :, :I + H + 1], 1e-4)


def _check_cbndk(jl, j, p, k):
    xt, hs, w_ih, w_hh, b, xp, c_seq, dh = j
    h = p[2][1].shape[-1]
    old, jl._CBND_K = jl._CBND_K, lstm.CBNDK_ROWS
    try:
        ref = _split_dirs(jl._cbndk_call(xt, hs, w_ih, w_hh, b, k, True), h)
    finally:
        jl._CBND_K = old
    got = lstm.bilstm_cbndk_plain(p[0], p[1], *p[2], k)
    nseg = -(-p[0].shape[2] // k)
    assert got.shape == (S, 2, nseg, B, h)
    # the slots a block reads: entries of blocks 1.. (d=0) and ..NSEG-2 (d=1)
    _close(got[:, 0, :nseg - 1], ref[:, 0, :nseg - 1], 1e-5)
    _close(got[:, 1, 1:], ref[:, 1, 1:], 1e-5)
    torch.testing.assert_close(got, lstm.bilstm_cbnd_plain(p[0], p[1], *p[2], k), rtol=0,
                               atol=1e-6)


KERNEL_CASES = {
    "bilstm_fwd_xp": (T, _check_fwd_xp),
    "bilstm_bwd_xp": (T, _check_bwd_xp),
    "bilstm_cseq": (T, _check_cseq),
    "bilstm_bwd_split": (T, _check_bwd_split),
    "bilstm_bwdc": (T, _check_bwdc),
    "bilstm_cbndk K 2": (T_KC, lambda jl, j, p: _check_cbndk(jl, j, p, 2)),
    f"bilstm_cbndk K {lstm.SEG_K}": (T_KC, lambda jl, j, p: _check_cbndk(jl, j, p, lstm.SEG_K)),
    f"bilstm_cbndk K 2 H {H_WIDE}": ("h192", lambda jl, j, p: _check_cbndk(jl, j, p, 2)),
    f"bilstm_cbndk K {lstm.SEG_K} H {H_WIDE}": (
        "h192", lambda jl, j, p: _check_cbndk(jl, j, p, lstm.SEG_K)),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_schedule_kernel_plain_matches_jax(jax_case, case):
    """The plain version of S models against the Pallas kernel's own model
    axis (interpret mode); the cseq case's reference is the fixture's JAX
    ``_cseq_call``."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    t, check = KERNEL_CASES[case]
    check(jl, jax_case[t]["jax"], jax_case[t]["port"])


@pytest.mark.parametrize("case", ["one model", "vmap"])
def test_fwd_xp_plain_c_matches_jax_fwd_call(case):
    """Row 4's ``c_seq (S, 2, T, B, H)``, which the v5 forward stores from
    the cluster recurrence's registers: ``_recurrence_plain``'s c (the
    kernel's plain version) against JAX ``_fwd_call``'s packed ``c_seq`` at
    the v5 shapes, for one model without the model axis and for S models
    under ``jax.vmap`` (each a call of one model)."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, _ = _models(60)
    w_ih, w_hh, bias = _stacked(fwd, bwd)
    xp = lstm._projection(torch.from_numpy(x), w_ih, bias)  # (S, B, T, 8H)
    xp_j = jnp.asarray(np.swapaxes(xp.numpy(), 1, 2))      # (S, T, B, 8H)
    whh_j = jnp.asarray(np.swapaxes(w_hh.numpy(), -1, -2))  # (S, 2, H, 4H)
    if case == "one model":
        h_ref, c_ref = jl._fwd_call(xp_j[:1], whh_j[:1], True)
        h_seq, c = (a[None] for a in lstm.bilstm_fwd_xp_plain(xp[0], w_hh[0]))
    else:
        h_ref, c_ref = (a[:, 0] for a in jax.vmap(
            lambda a, w: jl._fwd_call(a[None], w[None], True))(xp_j, whh_j))
        h_seq, c = lstm.bilstm_fwd_xp_plain(xp, w_hh)
    s = 1 if case == "one model" else S
    assert c.shape == (s, 2, T, B, H) and c.dtype == torch.float32
    _close(c, _split_dirs(c_ref, H), 1e-5)
    _close(h_seq, _swap(h_ref), 1e-5)
    _close(c, lstm._recurrence_plain(xp[:s], w_hh[:s])[1], 0)


class _Recorder:
    """Stands in for a kernel: records the arguments of its launch."""

    def __init__(self):
        self.args = None

    def launch(self, device, *args):
        self.args = args


@pytest.mark.parametrize("s, want", [(1, (8, 16, 2)), (24, (2, 64, 8))])
def test_fwd_xp_takes_row_1_plan(monkeypatch, s, want):
    """Row 4 launches the cluster recurrence (``lstm._launch_rec``) on row
    1's fp32 plan at the flagship layer (B=64, H=128): 64 CTAs at S=1, 96
    at S=24, with the plan's own shared-memory count; the c store needs no
    more shared memory than row 1 takes."""
    monkeypatch.setattr(lstm, "_sm_count", lambda index: lstm.H100_SMS)
    b, t, h = 64, 73, 128
    xp = torch.empty(1).expand(s, b, t, 8 * h)  # shapes only: nothing is launched
    w_hh = torch.empty(1).expand(s, 2, 4 * h, h)
    h_seq, c_seq = torch.empty(1).expand(s, b, t, 2 * h), torch.empty(1).expand(s, 2, t, b, h)
    rows, cseq = _Recorder(), _Recorder()
    lstm._launch_rec(rows, xp, w_hh, h_seq)
    lstm._launch_rec(cseq, xp, w_hh, h_seq, c_seq)
    assert lstm.cluster_plan("rec", s, b, h, torch.float32) == want
    assert rows.args[3:] == (s, b, t, h, *want, lstm._cluster_smem("rec", *want, h, 4))
    assert cseq.args[4:] == rows.args[3:]
    assert cseq.args[3].value == c_seq.data_ptr()


# --------------------------------------------------------------------------
# CPU: the layer under each schedule against the JAX layer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", lstm.SCHEDULES)
def test_fused_bilstm_layer_schedule_matches_jax(schedule):
    """Output, dx and both directions' dW_ih, dW_hh, db_ih, db_hh against
    ``jax.grad`` of the JAX layer under the matching switch (interpret
    mode)."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, _ = _one_model(20)
    args = jnp.asarray(x), tuple(map(jnp.asarray, fwd)), tuple(map(jnp.asarray, bwd))
    with _jax_schedule(schedule) as use_xproj:
        layer = lambda *a: jl.fused_bilstm_layer(*a, interpret=True, use_xproj=use_xproj)
        ref_out = layer(*args)
        ref = jax.grad(lambda *a: jnp.sum(jnp.sin(layer(*a))), argnums=(0, 1, 2))(*args)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, *fwd, *bwd)]
    out = lstm.fused_bilstm_layer(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]),
                                  schedule=schedule)
    _close(out.detach(), ref_out, 1e-4)
    torch.sin(out).sum().backward()
    for leaf, r in zip(leaves, jax.tree.leaves(ref)):
        _close(leaf.grad, r, 1e-4)


# the plain kernels each schedule's layer calls, forward and backward
SCHEDULE_PLAIN = {
    "v9": ("bilstm_fwd_plain", "bilstm_cbnd_plain", "bilstm_segbwd_plain"),
    "v9.1": ("bilstm_fwd_plain", "bilstm_cbndk_plain", "bilstm_segbwd_plain"),
    "v8": ("bilstm_fwd_plain", "bilstm_cseq_plain", "bilstm_bwdc_plain"),
    "v6": ("bilstm_fwd_plain", "bilstm_cseq_plain", "bilstm_bwd_split_plain"),
    "v5": ("bilstm_fwd_xp_plain", "bilstm_bwd_xp_plain"),
}


def _spy(monkeypatch, name):
    calls, fn = [], getattr(lstm, name)

    def spy(*args, **kw):
        calls.append(tuple(a.shape for a in args if isinstance(a, torch.Tensor)))
        return fn(*args, **kw)

    monkeypatch.setattr(lstm, name, spy)
    return calls


@pytest.mark.parametrize("schedule", lstm.SCHEDULES)
def test_schedule_under_vmap_grad(monkeypatch, schedule):
    """x and every weight's gradient of S models through one
    ``vmap(grad_and_value)`` equal S per-model autograd runs, and each of
    the schedule's plain kernels is entered once, with all S models; no
    other schedule's kernel is entered."""
    x, fwd, bwd, _ = _models(30)
    tx = torch.from_numpy(x)
    tf, tb = (tuple(map(torch.from_numpy, p)) for p in (fwd, bwd))
    loss = lambda x, f, b: torch.sin(lstm.fused_bilstm_layer(x, f, b, schedule=schedule)).sum()
    names = sorted({n for v in SCHEDULE_PLAIN.values() for n in v} | {"bilstm_segbwd_plain"})
    calls = {n: _spy(monkeypatch, n) for n in names}
    grads, values = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(tx, tf, tb)
    entered = {n for n, c in calls.items() if c}
    # the plain versions at K=1 are the K-segment ones: bilstm_cseq_plain
    # calls bilstm_cbnd_plain, bilstm_bwdc_plain calls bilstm_segbwd_plain
    wanted = set(SCHEDULE_PLAIN[schedule]) | {
        "bilstm_cseq_plain": {"bilstm_cbnd_plain"},
        "bilstm_bwdc_plain": {"bilstm_segbwd_plain"}}.get(SCHEDULE_PLAIN[schedule][-1], set())
    if schedule in ("v8", "v6"):
        wanted.add("bilstm_cbnd_plain")
    assert entered == wanted
    for n in SCHEDULE_PLAIN[schedule]:
        assert len(calls[n]) == 1 and all(shape[0] == S for shape in calls[n][0]), n
    for s in range(S):
        leaves = [tx[s].clone().requires_grad_(),
                  *(t[s].clone().requires_grad_() for t in (*tf, *tb))]
        v = loss(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]))
        v.backward()
        torch.testing.assert_close(values[s], v.detach(), rtol=0, atol=1e-5)
        got = [grads[0][s], *(g[s] for g in grads[1]), *(g[s] for g in grads[2])]
        for g, leaf in zip(got, leaves):
            torch.testing.assert_close(g, leaf.grad, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# CPU: the keyword through the model, serving, and its refusals
# --------------------------------------------------------------------------


def _small_model(schedule="v9"):
    return MultimodalTransformerModel(feat_dim=16, eeg_time=64, dropout=0.0,
                                      generator=torch.Generator().manual_seed(0),
                                      lstm_schedule=schedule)


@pytest.mark.parametrize("schedule", lstm.SCHEDULES)
def test_model_and_serving_take_the_schedule(schedule):
    """The schedule is neither a parameter nor a buffer (the state_dict is
    the default model's), reaches the BiLSTM, and on the CPU the eval
    forward and ``build_serving_forward`` give the default's logits."""
    base, model = _small_model().eval(), _small_model(schedule).eval()
    assert model.eeg_net.bilstm.schedule == schedule
    sd, base_sd = model.state_dict(), base.state_dict()
    assert sd.keys() == base_sd.keys() and all(torch.equal(sd[k], base_sd[k]) for k in sd)
    rng = np.random.default_rng(1)
    eeg, eye, pps = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     for s in ((4, 32, 64), (4, 38), (4, 230)))
    with torch.no_grad():
        want = base(eeg, eye, pps)
        for got in (model(eeg, eye, pps),
                    build_serving_forward(model, feat_dim=16, lstm_schedule=schedule)(eeg, eye, pps)):
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def _bf16_layer(schedule, dtype=torch.bfloat16):
    x, fwd, bwd, _ = _one_model(40)
    to = lambda a: torch.from_numpy(a).to(dtype)
    return lambda f: f(to(x), tuple(map(to, fwd)), tuple(map(to, bwd)), schedule)


REFUSALS = {
    "layer unknown": (ValueError, lambda: lstm.fused_bilstm_layer(
        torch.zeros(2, 3, 4), *[(torch.zeros(8, 4), torch.zeros(8, 2), torch.zeros(8),
                                 torch.zeros(8))] * 2, schedule="v7")),
    "ops unknown": (ValueError, lambda: rnn.bilstm_layer(
        torch.zeros(2, 3, 4), *[(torch.zeros(8, 4), torch.zeros(8, 2), torch.zeros(8),
                                 torch.zeros(8))] * 2, "v10")),
    "model unknown": (ValueError, lambda: _small_model("V9")),
    "serving unknown": (ValueError, lambda: build_serving_forward(
        _small_model(), feat_dim=16, lstm_schedule="v9.2")),
    **{f"layer fp16 {s}": (TypeError, lambda s=s: _bf16_layer(s, torch.float16)(
        lambda x, f, b, s: lstm.fused_bilstm_layer(x, f, b, schedule=s)))
       for s in lstm.SCHEDULES},
    "ops fp16 v6": (TypeError, lambda: _bf16_layer("v6", torch.float16)(rnn.bilstm_layer)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_schedule_refusals(case):
    """An unknown schedule raises ``ValueError`` wherever it is given; an
    fp16 tensor raises ``TypeError`` under every schedule (their kernels
    have fp32 and bf16 forms only), on the CPU as on the card."""
    error, call = REFUSALS[case]
    with pytest.raises(error):
        call()


def test_bf16_layer_runs_under_v9():
    """The refusal above is the dtype's: the same layer runs in bf16 under
    v9 (and under every other schedule, ``test_torch_port_lstm_bf16_schedules.py``)."""
    out = _bf16_layer("v9")(lambda x, f, b, s: lstm.fused_bilstm_layer(x, f, b, schedule=s))
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, 2 * H)


# --------------------------------------------------------------------------
# card: each kernel against its plain version; each schedule's gradients
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# (S, B, T, I, H): ragged, and the LOSO layer at full width over two models
CARD_SHAPES = {"ragged": (3, 5, 11, 12, 64), "layer": (2, 64, 73, 256, 128)}


def _card_case(cuda, shape, seed):
    s, b, t, i, h = CARD_SHAPES[shape]
    x, fwd, bwd, dh = _models(seed, s, b, t, i, h)
    x, dh = (torch.from_numpy(a).to(cuda) for a in (x, dh))
    w = tuple(a.to(cuda) for a in _stacked(fwd, bwd))
    with torch.no_grad():
        h_seq = lstm.bilstm_fwd_plain(x, *w)
        c_seq = lstm.bilstm_cseq_plain(x, h_seq, *w)
        xp = lstm._projection(x, w[0], w[2])
    return x, w, dh, h_seq, c_seq, xp


CARD_KERNELS = {
    "bilstm_fwd_xp": lambda x, w, dh, h, c, xp: (xp, w[1]),
    "bilstm_bwd_xp": lambda x, w, dh, h, c, xp: (dh, xp, h, c, w[1]),
    "bilstm_cseq": lambda x, w, dh, h, c, xp: (x, h, *w),
    "bilstm_bwd_split": lambda x, w, dh, h, c, xp: (dh, x, h, c, *w),
    "bilstm_bwdc": lambda x, w, dh, h, c, xp: (dh, x, h, c, *w),
    "bilstm_cbndk": lambda x, w, dh, h, c, xp: (x, h, *w),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_KERNELS))
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_schedule_kernel_matches_plain(cuda, shape, name):
    """One S-wide launch, against the plain version on the same card
    tensors: the c states and dx at 1e-4, dW_cat at 1e-4 of its largest
    entry (``tests/test_torch_port_train_kernels.py``'s bars)."""
    args = CARD_KERNELS[name](*_card_case(cuda, shape, 50))
    kernel = getattr(lstm, name.upper().removeprefix("BILSTM_") + "_KERNEL")
    with torch.no_grad():
        before = kernel.launches
        got = getattr(lstm, name)(*args)
        assert kernel.launches == before + 1
        want = getattr(lstm, name + "_plain")(*args)
    torch.cuda.synchronize()
    got, want = ((g,) if isinstance(g, torch.Tensor) else g for g in (got, want))
    for k, (g, r) in enumerate(zip(got, want)):
        if name == "bilstm_bwdc" and k == 1:  # dW_cat: sums over B*T rows
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=1e-4)


# (S, B, T, H) of row 4 alone: a batch tile of 37 rows and small hidden
# sizes (the cluster plan takes C = 4 at H = 12, 8 at H = 40); S 0: one
# model without the model axis
FWD_XP_SHAPES = {"h12": (2, 37, 11, 12), "h40": (3, 37, 9, 40), "one_model": (0, 37, 73, 40)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(FWD_XP_SHAPES))
def test_fwd_xp_kernel_matches_plain(cuda, shape):
    """Row 4 is one launch of the cluster recurrence's c-storing form (and
    none of row 1's form): ``h_seq`` and ``c_seq`` within 1e-4 of the plain
    version on the same card tensors."""
    s, b, t, h = FWD_XP_SHAPES[shape]
    rng = np.random.default_rng(52)
    lead = (s,) if s else ()
    xp = torch.from_numpy(rng.normal(size=(*lead, b, t, 8 * h)).astype(np.float32)).to(cuda)
    w_hh = torch.from_numpy((0.3 * rng.normal(size=(*lead, 2, 4 * h, h))).astype(np.float32))
    w_hh = w_hh.to(cuda)
    before = lstm.FWD_XP_KERNEL.launches, lstm.REC_KERNEL.launches
    with torch.no_grad():
        got = lstm.bilstm_fwd_xp(xp, w_hh)
        assert (lstm.FWD_XP_KERNEL.launches, lstm.REC_KERNEL.launches) == (before[0] + 1,
                                                                           before[1])
        want = lstm.bilstm_fwd_xp_plain(xp, w_hh)
    torch.cuda.synchronize()
    assert got[1].shape == (*lead, 2, t, b, h)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", lstm.SCHEDULES)
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_schedule_gradients_on_card(cuda, shape, schedule):
    """Each schedule's layer records gradients on the card and they match
    the plain path's (``test_bilstm_gradients_on_card``'s bar)."""
    _, b, t, i, h = CARD_SHAPES[shape]
    x, fwd, bwd, dh = _one_model(51, b=b, t=t, i=i, h=h)
    x, dh = (torch.from_numpy(a).to(cuda) for a in (x, dh))
    fwd, bwd = (tuple(torch.from_numpy(a).to(cuda) for a in p) for p in (fwd, bwd))
    leaves = [x, *fwd, *bwd]
    for leaf in leaves:
        leaf.requires_grad_()
    out = lstm.fused_bilstm_layer(x, fwd, bwd, schedule=schedule)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * dh).sum(), leaves)
    ref = torch.autograd.grad((lstm.fused_bilstm_layer_plain(x, fwd, bwd) * dh).sum(), leaves)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())


# (S, B, T, I, H) of row 10 alone: the flagship layer at one model (S 0: no
# model axis) and at the LOSO step's 24 models, and H = 192, which the old
# per-block walk refused
CBNDK_SHAPES = {"layer": (0, 64, 73, 256, 128), "loso": (24, 64, 73, 256, 128),
                "h192": (2, 37, 11, 64, H_WIDE)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CBNDK_SHAPES))
def test_cbndk_is_row_9_pieces(cuda, shape):
    """Row 10 on the card is one gates GEMM and one c scan, counting one
    call of row 10 and none of row 9, within 1e-4 of its plain version (the
    JAX block walk)."""
    s, b, t, i, h = CBNDK_SHAPES[shape]
    x, fwd, bwd, _ = _models(53, max(s, 1), b, t, i, h)
    x = torch.from_numpy(x).to(cuda)
    w = tuple(a.to(cuda) for a in _stacked(fwd, bwd))
    if not s:
        x, w = x[0], tuple(a[0] for a in w)
    counts = lambda: (lstm.CBNDK_KERNEL.launches, lstm.GEMM_KERNEL.launches,
                      lstm.CSCAN_KERNEL.launches, lstm.CBND_KERNEL.launches,
                      lstm.SWEEP_KERNEL.launches)
    with torch.no_grad():
        h_seq = lstm.bilstm_fwd_plain(x, *w)
        before = counts()
        got = lstm.bilstm_cbndk(x, h_seq, *w)
        assert counts() == tuple(n + e for n, e in zip(before, (1, 1, 1, 0, 0)))
        want = lstm.bilstm_cbndk_plain(x, h_seq, *w)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_v91_layer_backward_launches_v9s_kernels(cuda):
    """One v9.1 layer backward of S models under ``vmap(grad)``: v9's five
    launches (three GEMMs, one scan, one sweep), one call of rows 10 and 11
    each, and nothing of row 9."""
    from multimodal_sentiment_aanalysis_tpu_torch import kernels

    x, fwd, bwd, dh = (torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray)
                       else tuple(torch.from_numpy(t).to(cuda) for t in a)
                       for a in _models(54, 3, 5, 11, 12, 64))
    loss = lambda x, f, b, g: (lstm.fused_bilstm_layer(x, f, b, schedule="v9.1") * g).sum()
    kernels.reset_launch_counts()
    vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(x, fwd, bwd, dh)
    torch.cuda.synchronize()
    got = {n: c for n, c in kernels.launch_counts().items() if c}
    # the forward: one call of row 1, its projection GEMM and recurrence
    assert got == {"bilstm_fwd": 1, "bilstm_rec": 1, "bilstm_gemm": 1 + 3, "bilstm_cbndk": 1,
                   "bilstm_segbwd": 1, "bilstm_cscan": 1, "bilstm_sweep": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["layer", "h192"])
def test_v91_gradients_equal_v9s_on_card(cuda, shape):
    """v9.1's layer gradients on the card are v9's, bit for bit: the same
    kernels in the same order (every reduction in a fixed order)."""
    _, b, t, i, h = CBNDK_SHAPES[shape]
    x, fwd, bwd, dh = _one_model(55, b=b, t=t, i=i, h=h)
    x, dh = (torch.from_numpy(a).to(cuda) for a in (x, dh))
    fwd, bwd = (tuple(torch.from_numpy(a).to(cuda) for a in p) for p in (fwd, bwd))
    grads = {}
    for schedule in ("v9", "v9.1"):
        leaves = [a.clone().requires_grad_() for a in (x, *fwd, *bwd)]
        out = lstm.fused_bilstm_layer(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]),
                                      schedule=schedule)
        grads[schedule] = torch.autograd.grad((out * dh).sum(), leaves)
    torch.cuda.synchronize()
    for g9, g91 in zip(grads["v9"], grads["v9.1"]):
        assert torch.equal(g9, g91)

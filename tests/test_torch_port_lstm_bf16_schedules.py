"""bf16 under the BiLSTM's schedules other than v9 (``fused_bilstm_layer(
schedule=)`` with bf16 operands): the bf16 forms of rows 4-8 and 10.

On the CPU, every input made with numpy from a seed and rounded to bf16,
the same values handed to both packages (JAX on the CPU, its Pallas kernels
in interpret mode with bf16 operands):

- each of the six kernels' plain versions against its Pallas call, with the
  model axis S: both read the bf16 operands as stored and compute in fp32;
- the layer's output and every gradient under each schedule against
  ``jax.grad`` of the JAX layer in bf16, the matching switch set and
  restored (``_jax_schedule``; v5 with ``use_xproj=False``);
- each schedule in bf16 under ``torch.func.vmap(grad_and_value)``: one
  S-wide call of each of its plain kernels, none of another schedule's;
- the ``msa_torch::bilstm_fwd_xp`` fake against its CPU implementation in
  bf16 (``torch.library.opcheck``), output dtypes included;
- bf16 v5 serving against JAX bf16 serving;
- ``check_schedule``: fp32 and bf16 under every schedule, ``TypeError`` for
  fp16.

Tolerances, over the largest entry of the reference ("its scale"):

- a bf16-stored result (``h_seq``, the layer output, the gradients, which
  the layer rounds to its inputs' dtype) within 2^-8 of its scale: both
  packages compute the same fp32 value and round it once, so a value may
  differ by the one bf16 ulp that an fp32 rounding difference tips (at most
  2^-8 of the scale for a value in the scale's binade). Measured: outputs
  0, gradients 0 to 2.2e-5. Two exceptions, where JAX rounds more often
  than the port, each held to its own reference:

  - ``dx`` under v8, v9 and v9.1: JAX rounds each direction's half to bf16
    and sums the halves in bf16, the port rounds the fp32 sum once
    (measured 3.6e-3 of the scale, 9.4e-4 beyond one ulp of the value):
    within 2^-8 of the scale plus one bf16 ulp of the value (2^-7), the bar
    of ``tests/test_torch_port_bf16.py``;
  - the bias gradients under v5: JAX sums its bf16 ``dxp`` over (T, B) in
    bf16 (about 1e-2 of the scale from the fp64 sum of that same ``dxp``);
    the port sums the fp32 ``dxp`` and rounds once. Held within 2^-8 of the
    scale to the fp64 sum of JAX's own bf16 ``dxp`` (measured 2.0e-3 and
    2.2e-3);

- an fp32 result (``c_seq``, the checkpoints, ``dxp``, ``dW_cat``) within
  1e-6 of its scale (measured at most 1.2e-7: the same fp32 arithmetic
  summed in another order); row 8's dx halves, fp32 in the port and stored
  in x's dtype by JAX's ``_bwd_bwdc_kernel``, within 2^-8 of their scale
  (JAX's rounding to bf16: half an ulp, at most 2^-8 of the value;
  measured 3.0e-3 and 2.3e-3);
- ``vmap`` gradients against per-model autograd of the same bf16 layer:
  equal (the same plain arithmetic per model);
- bf16 v5 serving against JAX bf16 serving: rtol and atol 2e-2 and argmax
  agreement of at least 90%, the bar of
  ``test_bf16_serving_matches_jax_bf16_serving`` (measured max |diff| 2.0e-3
  and 9.8e-4 at logits up to 0.26 and 0.13: JAX serves through its bf16
  ``lax.scan``, which rounds h and c to bf16 every step); against the
  port's own bf16 serving under v9 at the same bar (measured 2.0e-3 and
  2.4e-4: v5 rounds the projection to bf16, v9 keeps it fp32).

The ``gpu``-marked tests hold each bf16 kernel form against its plain
version on the card at one model and at the LOSO step's S=24, full width,
and each schedule's bf16 layer gradients on the card against the plain
path's. They skip without a card and import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_lstm_bf16_schedules.py``.
"""

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from multimodal_sentiment_aanalysis_tpu_torch.eval.serving import build_serving_forward
from multimodal_sentiment_aanalysis_tpu_torch.kernels import library, lstm
from multimodal_sentiment_aanalysis_tpu_torch.models import MultimodalTransformerModel
from test_torch_port_lstm_schedules import (B, H, I, S, SCHEDULE_PLAIN, T, _jax_schedule, _models,
                                            _one_model, _spy)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BF16 = torch.bfloat16
BF16_REL = 2.0 ** -8  # a bf16-stored result, over its scale
ULP = 2.0 ** -7       # one bf16 ulp, relative to the value
F32_REL = 1e-6        # an fp32 result, over its scale
SERVE_TOL, SERVE_ARGMAX = 2e-2, 0.9
OTHER_SCHEDULES = tuple(s for s in lstm.SCHEDULES if s != "v9")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(np.asarray(a).astype(np.float32))


def _close(got, ref, rel, rtol=0.0):
    """|got - ref| <= rel * max |ref| + rtol * |ref|, elementwise."""
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, rtol=rtol, atol=rel * np.abs(r).max())


def _bf(a) -> torch.Tensor:
    """A float32 array as a bf16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)


def _jbf(a):
    """A float32 array (or a bf16 tensor) as a JAX bf16 array."""
    import jax.numpy as jnp

    return jnp.asarray(_np(a)).astype(jnp.bfloat16)


def _packed(a):
    """The port's ``(S, 2, T, B, H)`` -> JAX packed ``(S, T, B, 2H)``."""
    a = _np(a)
    return np.concatenate([a[:, 0], a[:, 1]], -1)


def _swap(a):
    """``(S, T, B, ·)`` <-> ``(S, B, T, ·)``."""
    return np.swapaxes(_np(a), 1, 2)


# --------------------------------------------------------------------------
# CPU: each kernel's plain version in bf16 against its Pallas call
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_case():
    """S models' operands rounded to bf16, in both packages' layouts:
    ``x``, the stacked weights and bias (summed in fp32, then rounded),
    ``h_seq`` (bf16) and ``c_seq`` (fp32) of the port's plain forward, the
    v5 projection ``xp`` (fp32 from the bf16 operands, then rounded, as the
    bf16 matmul rounds it) and ``dh``."""
    import jax.numpy as jnp

    x, fwd, bwd, dh = _models(70)
    w_ih = np.stack([fwd[0], bwd[0]], 1)  # (S, 2, 4H, I)
    w_hh = np.stack([fwd[1], bwd[1]], 1)
    bias = np.stack([fwd[2] + fwd[3], bwd[2] + bwd[3]], 1)
    port = dict(x=_bf(x), w=(_bf(w_ih), _bf(w_hh), _bf(bias)), dh=_bf(dh))
    with torch.no_grad():
        port["h"] = lstm.bilstm_fwd_plain(port["x"], *port["w"])
        port["c"] = lstm.bilstm_cseq_plain(port["x"], port["h"], *port["w"])
        port["xp"] = lstm._projection(*(t.float() for t in (port["x"], port["w"][0],
                                                            port["w"][2]))).to(BF16)
    tr = lambda a: np.swapaxes(_np(a), -1, -2)
    jax = dict(x=_jbf(_swap(port["x"])), h=_jbf(_swap(port["h"])), dh=_jbf(_swap(port["dh"])),
               w_ih=_jbf(tr(port["w"][0])), w_hh=_jbf(tr(port["w"][1])),
               b=_jbf(_np(port["w"][2])[:, :, None, :]), xp=_jbf(_swap(port["xp"])),
               c=jnp.asarray(_packed(port["c"])))
    return port, jax


def _check_fwd_xp(jl, p, j):
    h_ref, c_ref = jl._fwd_call(j["xp"], j["w_hh"], True)
    h_seq, c = lstm.bilstm_fwd_xp_plain(p["xp"], p["w"][1])
    assert h_seq.dtype == BF16 and c.dtype == torch.float32
    assert str(h_ref.dtype) == "bfloat16" and str(c_ref.dtype) == "float32"
    _close(h_seq, _swap(h_ref), BF16_REL)
    _close(_packed(c), c_ref, F32_REL)


def _check_bwd_xp(jl, p, j):
    ref = jl._bwd_call(j["dh"], j["xp"], j["h"], j["c"], j["w_hh"], True)
    got = lstm.bilstm_bwd_xp_plain(p["dh"], p["xp"], p["h"], p["c"], p["w"][1])
    assert got.dtype == torch.float32 and got.shape == (S, B, T, 8 * H)
    _close(got, _swap(ref), F32_REL)


def _check_cseq(jl, p, j):
    ref = jl._cseq_call(j["x"], j["h"], j["w_ih"], j["w_hh"], j["b"], True)
    got = lstm.bilstm_cseq_plain(p["x"], p["h"], *p["w"])
    assert got.dtype == torch.float32 and got.shape == (S, 2, T, B, H)
    _close(_packed(got), ref, F32_REL)


def _check_bwd_split(jl, p, j):
    ref = jl._bwd_xproj_call(j["dh"], j["x"], j["h"], j["c"], j["w_ih"], j["w_hh"], j["b"], True)
    got = lstm.bilstm_bwd_split_plain(p["dh"], p["x"], p["h"], p["c"], *p["w"])
    assert got.dtype == torch.float32
    _close(got, _swap(ref), F32_REL)


def _check_bwdc(jl, p, j):
    dx_ref, dw_ref = (_np(a) for a in jl._bwd_bwdc_call(j["dh"], j["x"], j["h"], j["c"],
                                                         j["w_ih"], j["w_hh"], j["b"], True))
    dx_pk, dw_cat = lstm.bilstm_bwdc_plain(p["dh"], p["x"], p["h"], p["c"], *p["w"])
    assert dx_pk.dtype == dw_cat.dtype == torch.float32
    for d in (0, 1):  # JAX stores the dx halves in x's dtype: rounded once more
        _close(dx_pk[:, d], _swap(dx_ref[..., d * I:(d + 1) * I]), BF16_REL)
    _close(dw_cat, dw_ref[:, :, :I + H + 1], F32_REL)


def _check_cbndk(jl, p, j):
    k = lstm.SEG_K
    old, jl._CBND_K = jl._CBND_K, lstm.CBNDK_ROWS
    try:
        ref = _np(jl._cbndk_call(j["x"], j["h"], j["w_ih"], j["w_hh"], j["b"], k, True))
    finally:
        jl._CBND_K = old
    got = lstm.bilstm_cbndk_plain(p["x"], p["h"], *p["w"], k)
    nseg = -(-T // k)
    assert got.dtype == torch.float32 and got.shape == (S, 2, nseg, B, H)
    got = _packed(got)
    # the slots a block reads: entries of blocks 1.. (d=0) and ..NSEG-2 (d=1)
    _close(got[:, :nseg - 1, :, :H], ref[:, :nseg - 1, :, :H], F32_REL)
    _close(got[:, 1:, :, H:], ref[:, 1:, :, H:], F32_REL)


KERNEL_CASES = {"bilstm_fwd_xp": _check_fwd_xp, "bilstm_bwd_xp": _check_bwd_xp,
                "bilstm_cseq": _check_cseq, "bilstm_bwd_split": _check_bwd_split,
                "bilstm_bwdc": _check_bwdc, "bilstm_cbndk": _check_cbndk}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_bf16_schedule_kernel_plain_matches_jax(bf16_case, name):
    """The plain version of S models in bf16 against the Pallas kernel's
    own model axis at bf16 (interpret mode)."""
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    KERNEL_CASES[name](jl, *bf16_case)


def test_row5_reads_the_forward_c_in_bf16(bf16_case):
    """Row 5's pieces in bf16, the gates from ``xp`` then the sweep at K=1,
    which reads each step's c from the v5 forward's ``c_seq`` (JAX
    ``_bwd_kernel``'s ``c_cur``), give ``bilstm_bwd_xp_plain`` within 1e-6
    of its scale. Rebuilding c from the previous step would not: the
    forward carried h in fp32, the backward's gates read the stored bf16
    ``h_seq``, and the c they rebuild is off the forward's by far more."""
    p, _ = bf16_case
    h_seq, c_seq = lstm.bilstm_fwd_xp_plain(p["xp"], p["w"][1])
    ref = lstm.bilstm_bwd_xp_plain(p["dh"], p["xp"], h_seq, c_seq, p["w"][1])
    act = lstm.bilstm_gemm_plain("gates_xp", None, None, p["w"][1], None, h_seq=h_seq,
                                 xp=p["xp"])
    _close(lstm.bilstm_sweep_plain(act, p["dh"], c_seq, p["w"][1], 1), ref, F32_REL)
    i, f, g, _ = act[..., :4 * H].chunk(4, dim=-1)  # direction 0, actual time = step
    rebuilt = f[:, :, 1:] * c_seq[:, 0, :-1].transpose(1, 2) + i[:, :, 1:] * g[:, :, 1:]
    stored = c_seq[:, 0, 1:].transpose(1, 2)
    assert (rebuilt - stored).abs().max() > 100 * F32_REL * stored.abs().max()


# --------------------------------------------------------------------------
# CPU: the bf16 layer under each schedule against the JAX layer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", lstm.SCHEDULES)
def test_bf16_layer_schedule_matches_jax(schedule):
    """Output, dx and both directions' dW_ih, dW_hh, db_ih, db_hh of the
    bf16 layer against ``jax.grad`` of the JAX layer in bf16 under the
    matching switch (interpret mode); every gradient bf16, as its input."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    x, fwd, bwd, _ = _one_model(71)
    w = np.random.default_rng(72).normal(size=(B, T, 2 * H)).astype(np.float32)
    args = _jbf(x), tuple(map(_jbf, fwd)), tuple(map(_jbf, bwd))
    with _jax_schedule(schedule) as use_xproj:
        layer = lambda *a: jl.fused_bilstm_layer(*a, interpret=True, use_xproj=use_xproj)
        loss = lambda *a: jnp.sum(layer(*a).astype(jnp.float32) * w)
        ref_out = layer(*args)
        ref = jax.tree.leaves(jax.grad(loss, argnums=(0, 1, 2))(*args))
        if schedule == "v5":  # JAX's own bf16 dxp, the gradient of its projection
            xp = jnp.swapaxes(args[0], 0, 1) @ jnp.concatenate([fwd[0], bwd[0]], 0).astype(
                jnp.bfloat16).T + jnp.concatenate([args[1][2] + args[1][3],
                                                   args[2][2] + args[2][3]])
            w_hh = jnp.stack([args[1][1].T, args[2][1].T])
            dxp = jax.grad(lambda xp: jnp.sum(jnp.swapaxes(jl.lstm_recurrence(
                xp, w_hh, True), 0, 1).astype(jnp.float32) * w))(xp)
            assert str(dxp.dtype) == "bfloat16"
            db = _np(dxp).astype(np.float64).sum((0, 1))  # (8H,), [fwd | bwd]
    leaves = [_bf(a).requires_grad_() for a in (x, *fwd, *bwd)]
    out = lstm.fused_bilstm_layer(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]),
                                  schedule=schedule)
    assert out.dtype == BF16 and str(ref_out.dtype) == "bfloat16"
    _close(out, ref_out, BF16_REL)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert all(leaf.grad.dtype == BF16 for leaf in leaves)
    for n, (leaf, r) in enumerate(zip(leaves, ref)):
        if n == 0 and schedule in ("v8", "v9", "v9.1"):
            _close(leaf.grad, r, BF16_REL, rtol=ULP)
        elif schedule == "v5" and n in (3, 4, 7, 8):  # b_ih, b_hh of each direction
            _close(leaf.grad, db[:4 * H] if n < 5 else db[4 * H:], BF16_REL)
        else:
            _close(leaf.grad, r, BF16_REL)


def _first_dtype(monkeypatch, name):
    """The dtype of the first argument of each call of ``lstm.name``."""
    dtypes, fn = [], getattr(lstm, name)
    monkeypatch.setattr(lstm, name, lambda *a, **kw: dtypes.append(a[0].dtype) or fn(*a, **kw))
    return dtypes


@pytest.mark.parametrize("schedule", lstm.SCHEDULES)
def test_bf16_schedule_under_vmap_grad(monkeypatch, schedule):
    """x and every weight's bf16 gradient of S models through one
    ``vmap(grad_and_value)`` equal S per-model autograd runs, and each of
    the schedule's plain kernels is entered once, with all S models, on
    bf16 operands; no other schedule's kernel is entered."""
    x, fwd, bwd, _ = _models(73)
    tx = _bf(x)
    tf, tb = (tuple(map(_bf, p)) for p in (fwd, bwd))
    loss = lambda x, f, b: torch.sin(
        lstm.fused_bilstm_layer(x, f, b, schedule=schedule).float()).sum()
    names = sorted({n for v in SCHEDULE_PLAIN.values() for n in v} | {"bilstm_segbwd_plain"})
    calls = {n: _spy(monkeypatch, n) for n in names}
    leads = {n: _first_dtype(monkeypatch, n) for n in SCHEDULE_PLAIN[schedule]}
    grads, values = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(tx, tf, tb)
    entered = {n for n, c in calls.items() if c}
    wanted = set(SCHEDULE_PLAIN[schedule]) | {
        "bilstm_cseq_plain": {"bilstm_cbnd_plain"},
        "bilstm_bwdc_plain": {"bilstm_segbwd_plain"}}.get(SCHEDULE_PLAIN[schedule][-1], set())
    if schedule in ("v8", "v6"):
        wanted.add("bilstm_cbnd_plain")
    assert entered == wanted
    for n in SCHEDULE_PLAIN[schedule]:
        assert len(calls[n]) == 1 and all(shape[0] == S for shape in calls[n][0]), n
        assert leads[n] == [BF16], n  # x, xp or dh_seq: the operands stay bf16
    for s in range(S):
        leaves = [tx[s].clone().requires_grad_(),
                  *(t[s].clone().requires_grad_() for t in (*tf, *tb))]
        v = loss(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]))
        v.backward()
        torch.testing.assert_close(values[s], v.detach(), rtol=0, atol=0)
        got = [grads[0][s], *(g[s] for g in grads[1]), *(g[s] for g in grads[2])]
        for g, leaf in zip(got, leaves):
            assert g.dtype == BF16
            torch.testing.assert_close(g, leaf.grad, rtol=0, atol=0)


# --------------------------------------------------------------------------
# CPU: row 4's op in bf16, serving, the dtype check
# --------------------------------------------------------------------------


@pytest.mark.parametrize("models", [None, 2])
def test_fwd_xp_op_bf16(models):
    """``msa_torch::bilstm_fwd_xp`` on bf16 ``xp`` and ``w_hh``: the fake
    implementation against the CPU one (``opcheck``: schema, fake, dynamic
    shapes), and both give ``h_seq`` bf16 and ``c_seq`` fp32."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    s = () if models is None else (models,)
    g = torch.Generator().manual_seed(74)
    b, t, h = 3, 5, 4
    mk = lambda *shape: (0.3 * torch.randn(*s, *shape, generator=g)).to(BF16)
    args = (mk(b, t, 8 * h), mk(2, 4 * h, h))
    torch.library.opcheck(library.OPS["bilstm_fwd_xp"], args)
    real = library.bilstm_fwd_xp(*args)
    with FakeTensorMode() as mode:
        fake = library.bilstm_fwd_xp(*(mode.from_tensor(a) for a in args))
    assert [r.dtype for r in real] == [f.dtype for f in fake] == [BF16, torch.float32]
    assert [r.shape for r in real] == [f.shape for f in fake]
    assert [r.shape for r in real] == [(*s, b, t, 2 * h), (*s, 2, t, b, h)]


def test_bf16_v5_serving_matches_jax_bf16_serving():
    """``build_serving_forward(compute_dtype=bf16, lstm_schedule="v5")``
    against the JAX package's bf16 serving on the same weights (JAX
    variables from a seeded port model), at the bar of
    ``test_bf16_serving_matches_jax_bf16_serving``; and against the port's
    bf16 serving under v9 (the same function, the projections rounded to
    bf16 under v5 as JAX's v5 rounds them)."""
    import jax

    from multimodal_sentiment_aanalysis_tpu.eval.serving import (
        build_serving_forward as jax_serving,
    )
    from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
        variables_from_torch_state_dict,
    )
    from test_torch_port_models import inputs

    feat_dim, eeg_time, b = 32, 64, 16
    port = MultimodalTransformerModel(feat_dim=feat_dim, eeg_time=eeg_time,
                                      generator=torch.Generator().manual_seed(75)).eval()
    gen = torch.Generator().manual_seed(76)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    v = jax.tree.map(np.asarray, variables_from_torch_state_dict(port.state_dict()))
    x = inputs(b, eeg_time, seed=77)
    import jax.numpy as jnp

    ref = jax_serving(jax.tree.map(jnp.asarray, v), feat_dim, use_pallas=False,
                      compute_dtype=jnp.bfloat16)(*x)
    xt = tuple(map(torch.from_numpy, x))
    got = build_serving_forward(port, feat_dim, compute_dtype=BF16, lstm_schedule="v5")(*xt)
    v9 = build_serving_forward(port, feat_dim, compute_dtype=BF16)(*xt)
    for g, r, g9 in zip(got, ref, v9):
        assert g.dtype == torch.float32 and g.shape == (b, 3)
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=SERVE_TOL, atol=SERVE_TOL)
        assert (g.numpy().argmax(-1) == r.argmax(-1)).mean() >= SERVE_ARGMAX
        np.testing.assert_allclose(g.numpy(), g9.numpy(), rtol=SERVE_TOL, atol=SERVE_TOL)


@pytest.mark.parametrize("schedule", lstm.SCHEDULES)
def test_check_schedule_takes_fp32_and_bf16(schedule):
    """Every schedule takes fp32 and bf16 (each kernel has both forms);
    fp16 raises ``TypeError``, on the CPU as on the card."""
    for dtype in (torch.float32, BF16):
        lstm.check_schedule(schedule, dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lstm.check_schedule(schedule, torch.float16)


# --------------------------------------------------------------------------
# card: each bf16 form against its plain version; each schedule's gradients
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# (S, B, T, I, H): the flagship layer at one model (S 0: no model axis), at
# the LOSO step's 24 models, and a ragged shape
CARD_SHAPES = {"one_model": (0, 64, 73, 256, 128), "loso": (24, 64, 73, 256, 128),
               "ragged": (3, 5, 11, 12, 64)}


def _card_case(cuda, shape, seed):
    """bf16 operands on the card, model axis first unless S is 0; ``h``
    bf16 and ``c`` fp32 from the plain forward, ``xp`` the bf16 projection
    and ``hc_xp`` the plain v5 forward's ``(h_seq, c_seq)`` over it, which
    row 5 reads on the v5 path."""
    s, b, t, i, h = CARD_SHAPES[shape]
    x, fwd, bwd, dh = _models(seed, max(s, 1), b, t, i, h)
    bf = lambda a: _bf(a).to(cuda)
    x, dh = bf(x), bf(dh)
    w = (bf(np.stack([fwd[0], bwd[0]], 1)), bf(np.stack([fwd[1], bwd[1]], 1)),
         bf(np.stack([fwd[2] + fwd[3], bwd[2] + bwd[3]], 1)))
    if not s:
        x, dh, w = x[0], dh[0], tuple(a[0] for a in w)
    with torch.no_grad():
        h_seq = lstm.bilstm_fwd_plain(x, *w)
        c_seq = lstm.bilstm_cseq_plain(x, h_seq, *w)
        xp = lstm.bilstm_gemm_plain("proj", x, *w).to(BF16)
        hc_xp = lstm.bilstm_fwd_xp_plain(xp, w[1])
    return x, w, dh, h_seq, c_seq, xp, hc_xp


CARD_KERNELS = {
    "bilstm_fwd_xp": lambda x, w, dh, h, c, xp, hc: (xp, w[1]),
    "bilstm_bwd_xp": lambda x, w, dh, h, c, xp, hc: (dh, xp, *hc, w[1]),
    "bilstm_cseq": lambda x, w, dh, h, c, xp, hc: (x, h, *w),
    "bilstm_bwd_split": lambda x, w, dh, h, c, xp, hc: (dh, x, h, c, *w),
    "bilstm_bwdc": lambda x, w, dh, h, c, xp, hc: (dh, x, h, c, *w),
    "bilstm_cbndk": lambda x, w, dh, h, c, xp, hc: (x, h, *w),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_KERNELS))
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_bf16_schedule_kernel_matches_plain(cuda, shape, name):
    """One launch of the bf16 form (its own count moves, the fp32 form's
    does not), against the plain version on the same card tensors: fp32
    outputs at 1e-4 (dW_cat at 1e-4 of its largest entry: it sums B*T
    rows), ``h_seq`` within one bf16 ulp of the value plus 1e-4."""
    from multimodal_sentiment_aanalysis_tpu_torch import kernels

    args = CARD_KERNELS[name](*_card_case(cuda, shape, 80))
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = getattr(lstm, name)(*args)
        counts = kernels.launch_counts()
        want = getattr(lstm, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert counts[name + "_bf16"] == 1 and counts[name] == 0
    got, want = ((g,) if isinstance(g, torch.Tensor) else g for g in (got, want))
    for k, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == r.dtype and g.shape == r.shape
        if name == "bilstm_bwdc" and k == 1:
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())
        else:
            torch.testing.assert_close(g.float(), r.float(), rtol=ULP if r.dtype == BF16 else 0,
                                       atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", OTHER_SCHEDULES)
@pytest.mark.parametrize("shape", ["one_model", "ragged"])
def test_bf16_schedule_gradients_on_card(cuda, shape, schedule):
    """Each schedule's bf16 layer on the card: output and every bf16
    gradient against the plain path's (the CPU) on the same inputs, within
    one bf16 ulp of the value plus 1e-3 of the largest entry; under v5 plus
    2^-7 of the largest entry: v5 rounds ``xp`` and ``dxp`` to bf16 inside
    the layer, cuBLAS and the CPU sum their products in other orders, and
    an entry that tips to the other bf16 neighbour carries one ulp of itself
    into everything after it."""
    _, b, t, i, h = CARD_SHAPES[shape]
    x, fwd, bwd, dh = _one_model(81, b=b, t=t, i=i, h=h)
    leaves = [_bf(a).to(cuda).requires_grad_() for a in (x, *fwd, *bwd)]
    dh = torch.from_numpy(dh).to(cuda)
    out = lstm.fused_bilstm_layer(leaves[0], tuple(leaves[1:5]), tuple(leaves[5:]),
                                  schedule=schedule)
    assert out.dtype == BF16 and out.grad_fn is not None
    got = torch.autograd.grad((out.float() * dh).sum(), leaves)
    cpu = [a.detach().cpu().requires_grad_() for a in leaves]
    ref_out = lstm.fused_bilstm_layer(cpu[0], tuple(cpu[1:5]), tuple(cpu[5:]), schedule=schedule)
    ref = torch.autograd.grad((ref_out.float() * dh.cpu()).sum(), cpu)
    torch.cuda.synchronize()
    rel = 2.0 ** -7 if schedule == "v5" else 1e-3
    for g, r in zip((out, *got), (ref_out, *ref)):
        assert g.dtype == r.dtype == BF16
        r = r.float()
        torch.testing.assert_close(g.detach().float().cpu(), r, rtol=ULP,
                                   atol=rel * r.abs().max().item())

"""The BiLSTM forward (row 1) and reverse sweep (row 11) as their pieces:
the tensor-core GEMM (``lstm.bilstm_gemm``: the projection, the gate
recompute, dx and dW_cat), the forward's recurrence over the projection
(``lstm.bilstm_rec``) and the sweep over the precomputed activations
(``lstm.bilstm_sweep``).

On the CPU, the pieces' plain versions composed against the JAX kernels of
the two rows (``_fwd_xproj_call``, ``_segbwd_call``, Pallas in interpret
mode) and against the ports' own plain versions of the rows, at S=2 models,
B=5 (a ragged batch tile), T=7 (a partial last segment at K=4), I=12, H=8,
in fp32 and bf16, on seeded numpy inputs. Tolerances: fp32 1e-5 (the same
fp32 arithmetic summed in other orders); bf16 the bar of
``tests/test_torch_port_bf16.py``, one bf16 ulp (2^-7) of the value, since
the JAX kernels round ``h_seq`` and dx to bf16 where the port keeps fp32
until the layer's gradient. Also the cluster plan the wrappers pick from
the shapes.

The ``gpu``-marked tests hold each piece's kernel against its plain version
on the card, at those sizes and at the flagship layer (B=64, T=73, I=256,
H=128), and count the launches of rows 1 and 11:
``python -m pytest --noconftest -m gpu tests/test_torch_port_lstm_gemm.py``.
"""

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.kernels import lstm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BF16 = torch.bfloat16
ULP = 2.0 ** -7  # one bf16 ulp, relative to the value
S, B, T, I, H = 2, 5, 7, 12, 8
DTYPES = {"fp32": torch.float32, "bf16": BF16}


def _case(seed, s=S, b=B, t=T, i=I, h=H, scale=0.3):
    """x, stacked weights (w_ih, w_hh, bias) and an output gradient, as numpy
    fp32; bf16 cases round them first, so both packages read the same
    values. Each direction has weights of its own."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape, sc=1.0: (sc * rng.normal(size=shape)).astype(np.float32)
    return (mk(s, b, t, i), mk(s, 2, 4 * h, i, sc=scale), mk(s, 2, 4 * h, h, sc=scale),
            mk(s, 2, 4 * h, sc=scale), mk(s, b, t, 2 * h))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _np(t):
    return t.detach().float().cpu().numpy()


def _jax_operands(x, w_ih, w_hh, bias, dtype):
    """The JAX kernels' (S, T, B, .) operands of the same S models."""
    import jax.numpy as jnp

    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if dtype == BF16 else jnp.asarray
    return (cast(np.swapaxes(x, 1, 2)), cast(np.swapaxes(w_ih, -1, -2)),
            cast(np.swapaxes(w_hh, -1, -2)), cast(bias[:, :, None, :]))


def _rounded(arrays, dtype):
    """The numpy inputs as the dtype rounds them, back in fp32."""
    return [_np(torch.from_numpy(a).to(dtype)) for a in arrays]


def _forward_pieces(x, w):
    """Row 1 as its plain pieces: the projection, then the recurrence."""
    return lstm.bilstm_rec_plain(lstm.bilstm_gemm_plain("proj", x, *w), w[1])


def _backward_pieces(dh, x, h_seq, c_bnd, w, k):
    """Row 11 as its plain pieces: the gate recompute, the sweep, dx, dW_cat."""
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    dg = lstm.bilstm_sweep_plain(act, dh, c_bnd, w[1], k)
    return (lstm.bilstm_gemm_plain("dx", x, *w, h_seq=h_seq, dg=dg),
            lstm.bilstm_gemm_plain("dw", x, *w, h_seq=h_seq, dg=dg))


# --------------------------------------------------------------------------
# CPU: the composed plain pieces against JAX and the rows' plain versions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_pieces_match_jax(dtype):
    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    dt = DTYPES[dtype]
    arrays = _rounded(_case(0)[:4], dt)
    x, *w = _torch(arrays, dt)
    got = _forward_pieces(x, w)
    ref = np.swapaxes(np.asarray(jl._fwd_xproj_call(*_jax_operands(*arrays, dt), True),
                                 np.float32), 1, 2)
    assert got.shape == (S, B, T, 2 * H) and got.dtype == dt
    if dt == BF16:
        np.testing.assert_allclose(_np(got), ref, rtol=ULP, atol=0)
    else:
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(got, lstm.bilstm_fwd_plain(x, *w), rtol=0, atol=0)


@pytest.mark.parametrize("k", [2, lstm.SEG_K])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_pieces_match_jax_and_segbwd_plain(dtype, k):
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import lstm as jl

    dt = DTYPES[dtype]
    arrays = _rounded(_case(1), dt)
    x, w_ih, w_hh, bias, dh = _torch(arrays, dt)
    w = (w_ih, w_hh, bias)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    c_bnd = lstm.bilstm_cbnd_plain(x, h_seq, *w, k)
    dx_pk, dw_cat = _backward_pieces(dh, x, h_seq, c_bnd, w, k)
    assert dx_pk.shape == (S, 2, B, T, I) and dw_cat.shape == (S, 2, I + H + 1, 4 * H)
    assert dx_pk.dtype == dw_cat.dtype == torch.float32

    # the row's own plain version: the same arithmetic, summed in other orders
    dx_ref, dw_ref = lstm.bilstm_segbwd_plain(dh, x, h_seq, c_bnd, *w, k)
    scale = dw_ref.abs().max().item()
    torch.testing.assert_close(dx_pk, dx_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(dw_cat, dw_ref, rtol=0, atol=1e-5 * max(scale, 1.0))

    # the JAX kernels on the same h_seq, with their own checkpoints
    xt, wi, wh, b = _jax_operands(*arrays[:4], dt)
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if dt == BF16 else jnp.asarray
    hs = cast(np.swapaxes(_np(h_seq), 1, 2))
    c_jax = jl._cbnd_call(xt, hs, wi, wh, b, k, True)
    jdx, jdw = jl._segbwd_call(cast(np.swapaxes(arrays[4], 1, 2)), xt, hs, c_jax, wi, wh, b, k,
                               True)
    jdx, jdw = np.asarray(jdx, np.float32), np.asarray(jdw, np.float32)
    for d in (0, 1):
        want = np.swapaxes(jdx[..., d * I:(d + 1) * I], 1, 2)
        if dt == BF16:  # JAX rounds each half to bf16
            np.testing.assert_allclose(_np(dx_pk[:, d]), want, rtol=ULP, atol=0)
        else:
            np.testing.assert_allclose(_np(dx_pk[:, d]), want, rtol=0, atol=1e-5)
    want = jdw[:, :, : I + H + 1]
    if dt == BF16:
        np.testing.assert_allclose(_np(dw_cat), want, rtol=ULP, atol=0)
    else:
        np.testing.assert_allclose(_np(dw_cat), want, rtol=0, atol=1e-5 * max(scale, 1.0))


def test_pieces_of_one_model_match_the_model_axis():
    """A leading model axis is optional: one model's pieces equal its slice
    of the S-model call, bit for bit."""
    x, w_ih, w_hh, bias, dh = _torch(_case(2), torch.float32)
    w = (w_ih, w_hh, bias)
    h_seq = _forward_pieces(x, w)
    c_bnd = lstm.bilstm_cbnd_plain(x, h_seq, *w)
    many = _backward_pieces(dh, x, h_seq, c_bnd, w, lstm.SEG_K)
    for s in range(S):
        ws = tuple(t[s] for t in w)
        torch.testing.assert_close(_forward_pieces(x[s], ws), h_seq[s], rtol=0, atol=0)
        one = _backward_pieces(dh[s], x[s], h_seq[s], c_bnd[s], ws, lstm.SEG_K)
        for a, m in zip(one, many):
            torch.testing.assert_close(a, m[s], rtol=0, atol=1e-6)


def test_sweep_plain_leaves_the_activations():
    x, w_ih, w_hh, bias, dh = _torch(_case(3), torch.float32)
    h_seq = lstm.bilstm_fwd_plain(x, w_ih, w_hh, bias)
    act = lstm.bilstm_gemm_plain("gates", x, w_ih, w_hh, bias, h_seq=h_seq)
    before = act.clone()
    lstm.bilstm_sweep(act, dh, lstm.bilstm_cbnd_plain(x, h_seq, w_ih, w_hh, bias), w_hh)
    assert torch.equal(act, before)
    # activations: tanh for g, in (-1, 1); sigmoid for i, f, o, in (0, 1)
    gates = act.unflatten(-1, (2, 4, H))
    assert bool((gates[..., 2, :].abs() < 1).all())
    assert bool(((gates[..., [0, 1, 3], :] > 0) & (gates[..., [0, 1, 3], :] < 1)).all())


def test_cpu_pieces_launch_nothing():
    x, w_ih, w_hh, bias, dh = _torch(_case(4), torch.float32)
    kernels = (lstm.GEMM_KERNEL, lstm.REC_KERNEL, lstm.SWEEP_KERNEL, lstm.KERNEL,
               lstm.SEGBWD_KERNEL)
    before = [k.launches for k in kernels]
    h_seq = lstm.bilstm_fwd(x, w_ih, w_hh, bias)
    c_bnd = lstm.bilstm_cbnd(x, h_seq, w_ih, w_hh, bias)
    lstm.bilstm_segbwd(dh, x, h_seq, c_bnd, w_ih, w_hh, bias)
    packed = torch.zeros(S, B, T, 8 * H)
    for mode in lstm.GEMM_MODES:
        lstm.bilstm_gemm(mode, x, w_ih, w_hh, bias, h_seq=h_seq, dg=packed, xp=packed)
    lstm.bilstm_rec(torch.zeros(S, B, T, 8 * H), w_hh)
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError):
        lstm.bilstm_gemm_plain("matmul", x, w_ih, w_hh, bias)


@pytest.mark.parametrize("s, b, h, dtype, want", [
    (1, 64, 128, torch.float32, (8, 16, 2)),    # one model: 64 CTAs, 2 rows a thread
    (24, 64, 128, torch.float32, (2, 64, 8)),   # the LOSO step: 96 CTAs, one wave
    (24, 64, 128, BF16, (2, 64, 8)),
    (24, 512, 128, torch.float32, (8, 32, 4)),  # more than a wave
    (2, 5, 8, torch.float32, (8, 5, 2)),
])
def test_cluster_plan(s, b, h, dtype, want):
    """The wrappers' cluster size, batch tile and rows per thread, from the
    shapes alone: a grid of one wave of 132 SMs where one exists, the least
    serial work per step, every CTA within 227 KB of shared memory and 512
    threads."""
    for kind in ("rec", "sweep"):
        c, bt, r = lstm.cluster_plan(kind, s, b, h, dtype)
        assert (c, bt, r) == want
        esize = torch.finfo(dtype).bits // 8
        assert lstm._cluster_smem(kind, c, bt, r, h, esize) <= 227 * 1024


def test_cluster_plan_raises_past_its_limits():
    """No cluster of up to 8 CTAs holds W_hh: raise, never fall back. H=300
    divides by 4 at most and its W_hh slice is 360 KB; H=129 runs on one
    CTA only, which W_hh does not fit."""
    for h in (300, 129):
        for kind in ("rec", "sweep"):
            with pytest.raises(ValueError):
                lstm.cluster_plan(kind, 1, 64, h, torch.float32)


@pytest.mark.parametrize("s, rows, i, h, want", [
    (1, 64 * 73, 256, 128, 4),   # the flagship at S=1: 112 dW_cat tiles
    (2, 64 * 73, 256, 128, 2),
    (4, 64 * 73, 256, 128, 1),
    (24, 64 * 73, 256, 128, 1),  # the LOSO step: 2,688 tiles
    (2, 5 * 7, 12, 8, 1),        # too few rows to split
])
def test_gemm_splits(s, rows, i, h, want):
    """dW_cat splits its B*T rows into fixed ranges only where its output
    tiles alone leave the card's 132 SMs short of four blocks each, and
    keeps each range at least 512 rows."""
    assert lstm.gemm_splits(s, rows, i, h) == want


# --------------------------------------------------------------------------
# card: each piece's kernel against its plain version
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gemm_dw_split_is_deterministic(cuda, dtype):
    """At S=1 dW_cat sums four row ranges' partials in rank order: two
    calls agree bit for bit."""
    x, w, _ = _card_case(cuda, "flagship", dtype, 15)
    x, w = x[:1], tuple(t[:1] for t in w)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    dg = torch.randn(*h_seq.shape[:-1], 8 * w[1].shape[-1], device=cuda)
    assert lstm.gemm_splits(1, x.shape[1] * x.shape[2], x.shape[3], w[1].shape[-1]) > 1
    first = lstm.bilstm_gemm("dw", x, *w, h_seq=h_seq, dg=dg)
    assert torch.equal(first, lstm.bilstm_gemm("dw", x, *w, h_seq=h_seq, dg=dg))

SHAPES = {"small": (S, B, T, I, H), "flagship": (2, 64, 73, 256, 128)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _card_case(cuda, shape, dtype, seed, scale=0.1):
    s, b, t, i, h = SHAPES[shape]
    x, w_ih, w_hh, bias, dh = _torch(_case(seed, s, b, t, i, h, scale), DTYPES[dtype], cuda)
    return x, (w_ih, w_hh, bias), dh


@pytest.mark.gpu
@pytest.mark.parametrize("mode", lstm.GEMM_MODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gemm_kernel_matches_plain(cuda, shape, dtype, mode):
    """fp32 operands as 3xTF32, bf16 ones as stored: fp32-accurate, within
    1e-5 of each output's largest entry. ``"gates_xp"`` reads the
    projection ``xp`` of the same layer in the operands' dtype (bf16 in the
    bf16 form, as the v5 schedule's bf16 matmul writes it)."""
    x, w, _ = _card_case(cuda, shape, dtype, 10)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    dg = torch.randn(*h_seq.shape[:-1], 8 * w[1].shape[-1], device=cuda)
    xp = lstm.bilstm_gemm_plain("proj", x, *w).to(x.dtype)
    kernel = lstm.GEMM_KERNELS[DTYPES[dtype]]
    before = kernel.launches
    got = lstm.bilstm_gemm(mode, x, *w, h_seq=h_seq, dg=dg, xp=xp)
    assert kernel.launches == before + 1
    want = lstm.bilstm_gemm_plain(mode, x, *w, h_seq=h_seq, dg=dg, xp=xp)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(want.abs().max().item(), 1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rec_kernel_matches_plain(cuda, shape, dtype):
    x, w, _ = _card_case(cuda, shape, dtype, 11)
    xp = lstm.bilstm_gemm_plain("proj", x, *w)
    kernel = lstm.REC_KERNELS[DTYPES[dtype]]
    before = kernel.launches
    got = lstm.bilstm_rec(xp, w[1])
    assert kernel.launches == before + 1
    want = lstm.bilstm_rec_plain(xp, w[1])
    torch.cuda.synchronize()
    assert got.dtype == DTYPES[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=ULP if dtype == "bf16" else 0,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, lstm.SEG_K])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sweep_kernel_matches_plain(cuda, shape, dtype, k):
    """dgates within 1e-4 of their largest entry: the dh carry sums its 4H
    terms per CTA, then the C partials, in another order than the plain
    version, through T dependent steps. The kernel overwrites ``act``."""
    x, w, dh = _card_case(cuda, shape, dtype, 12)
    h_seq = lstm.bilstm_fwd_plain(x, *w)
    c_bnd = lstm.bilstm_cbnd_plain(x, h_seq, *w, k)
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    want = lstm.bilstm_sweep_plain(act, dh, c_bnd, w[1], k)
    kernel = lstm.SWEEP_KERNELS[DTYPES[dtype]]
    before = kernel.launches
    got = lstm.bilstm_sweep(act, dh, c_bnd, w[1], k)
    assert kernel.launches == before + 1 and got.data_ptr() == act.data_ptr()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(want.abs().max().item(), 1.0))


@pytest.mark.gpu
def test_gemm_raises_on_widths_that_are_not_4_vectors(cuda):
    x, w, _ = _card_case(cuda, "small", "fp32", 14)
    for i, h in ((10, 8), (12, 6)):
        xi = x[..., :i].contiguous()
        wi = (w[0][..., :4 * h, :i].contiguous(), w[1][..., :4 * h, :h].contiguous(),
              w[2][..., :4 * h].contiguous())
        with pytest.raises(ValueError):
            lstm.bilstm_fwd(xi, *wi)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rows_launch_their_pieces(cuda, shape, dtype):
    """One call of row 1 is one projection and one recurrence; one call of
    row 9 one GEMM and one scan; one call of row 11 three GEMMs and one
    sweep; each row counts its calls."""
    dt = DTYPES[dtype]
    x, w, dh = _card_case(cuda, shape, dtype, 13)
    counts = lambda: (lstm.KERNELS[dt].launches, lstm.SEGBWD_KERNELS[dt].launches,
                      lstm.GEMM_KERNELS[dt].launches, lstm.REC_KERNELS[dt].launches,
                      lstm.SWEEP_KERNELS[dt].launches, lstm.CBND_KERNELS[dt].launches,
                      lstm.CSCAN_KERNEL.launches)
    before = counts()
    h_seq = lstm.bilstm_fwd(x, *w)
    c_bnd = lstm.bilstm_cbnd(x, h_seq, *w)
    dx_pk, dw_cat = lstm.bilstm_segbwd(dh, x, h_seq, c_bnd, *w)
    assert counts() == tuple(n + e for n, e in zip(before, (1, 1, 5, 1, 1, 1, 1)))
    dx_ref, dw_ref = lstm.bilstm_segbwd_plain(dh, x, h_seq, c_bnd, *w)
    torch.cuda.synchronize()
    torch.testing.assert_close(h_seq.float(), lstm.bilstm_fwd_plain(x, *w).float(),
                               rtol=ULP if dtype == "bf16" else 0, atol=1e-4)
    torch.testing.assert_close(dx_pk, dx_ref, rtol=0, atol=1e-4 * max(dx_ref.abs().max().item(), 1))
    torch.testing.assert_close(dw_cat, dw_ref, rtol=1e-4, atol=1e-4 * dw_ref.abs().max().item())

"""The port's int8 serving forward (``eval/quantization.py``) against the
JAX package's, on the CPU.

- the weight quantizers (``quantize_weight``, ``_q_dense`` with and without
  a BatchNorm fold, ``_q_linear_t``, ``_q_conv``): int8 codes equal to
  JAX's, scales within 1e-6 relative (both compute ``max|w| / 127`` and
  ``rint(w / s)`` in fp32; the port's codes are also checked inside the
  zero-padded ``(N8, K8)`` operand that ``torch._int_mm`` reads);
- the int8 products ``_qdot`` and ``_qconv1d`` against JAX's on the same
  codes, with K and N not multiples of 8 and 16 rows or fewer, and more:
  the integer products are exact, the padding adds zeros, and the float
  rescale is the same fp32 arithmetic in the same order, so 1e-6 of the
  output's scale (measured bit-equal or one fp32 ulp);
- the whole int8 forward with fp32 glue against JAX's, row by row: the
  products are exact, and the float glue (GELU, layer norm, the
  recurrence) rounds in other places in each package, by ~3e-8. A gap of
  that size moves an activation code only where ``x / sx`` sits within
  rounding of a .5; such a flip is the known source of a larger gap, and it
  stays in its row (every scale is per row but the conv's, whose codes
  alone flip). So each row's logits agree within 1e-5, but at most a quarter
  of the rows, which may differ by up to 5% of the largest |logit| (measured
  over 4 seeds of 16 rows: at most 2 rows, 1.7%);
- with bf16 glue against JAX's at 2e-2, the bar of the port's bf16 serving
  against JAX bf16 serving (``tests/test_torch_port_bf16.py``): bf16 rounds
  at other places in each (the JAX layer norm mixes bf16 activations with
  fp32 parameters, the port's runs in bf16), measured 5e-3 to 8e-3;
- each glue dtype against the port's fp32 serving at the JAX package's own
  bar (``tests/test_serving.py``: max gap at most 0.1 of the largest fp32
  logit, argmax agreement at least 0.9), at ``--tiny`` dims and full width,
  with batches of 16 rows or fewer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_sentiment_aanalysis_tpu.eval import quantization as jq
from multimodal_sentiment_aanalysis_tpu_torch.eval import build_serving_forward
from multimodal_sentiment_aanalysis_tpu_torch.eval import quantization as pq
from multimodal_sentiment_aanalysis_tpu_torch.kernels.conv_stem import fold_bn
from multimodal_sentiment_aanalysis_tpu_torch.models import state_dict_from_jax_variables

from test_torch_port_models import inputs, jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BF16 = torch.bfloat16
SCALE_RTOL = 1e-6
PRODUCT_RTOL = 1e-6   # of the output's largest entry
ROW_ATOL = 1e-5         # fp32 glue, a row without a flipped code
FLIPPED_ROWS = 0.25     # the share of rows that may hold a flipped code ...
FLIPPED_REL = 0.05      # ... and their gap, over the largest |logit|
BF16_GLUE_ATOL = 2e-2
DIMS = {"tiny": (32, 64, 5), "full": (256, 585, 16)}  # feat_dim, eeg_time, batch


def _rng_w(seed: int, *shape) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _codes_equal(got: dict, want: dict) -> None:
    """The port's codes in the JAX layout and in the padded operand, and its
    scales, against JAX's."""
    q, s = np.asarray(want["q"]), np.asarray(want["s"])
    np.testing.assert_array_equal(got["q"].numpy(), q)
    k, n = int(np.prod(q.shape[:-1])), q.shape[-1]
    mat = got["mat"].numpy()
    assert mat.shape == (-(-n // 8) * 8, -(-k // 8) * 8)
    np.testing.assert_array_equal(mat[:n, :k], q.reshape(k, n).T)
    assert not mat[n:].any() and not mat[:, k:].any()
    np.testing.assert_allclose(got["s"].numpy(), s, rtol=SCALE_RTOL, atol=0)
    if "bias" in want:
        np.testing.assert_allclose(got["bias"].numpy(), np.asarray(want["bias"]), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("shape, axes", [((38, 3), (0,)), ((230, 32), (0,)),
                                         ((15, 32, 64), (0, 1)), ((5, 64, 12), (0, 1))])
def test_quantize_weight_matches_jax(shape, axes):
    w = _rng_w(len(shape) + shape[0], *shape)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    got = pq.quantize_weight(torch.from_numpy(w), axes)
    want = jq.quantize_weight(w, axes)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]), rtol=SCALE_RTOL, atol=0)


def _bn(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 1.5, n).astype(np.float32), rng.normal(size=n).astype(np.float32),
            rng.normal(0, 0.2, n).astype(np.float32), rng.uniform(0.5, 1.5, n).astype(np.float32)]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("n_in, n_out", [(38, 32), (230, 3), (96, 12)])
def test_q_dense_and_linear_t_match_jax(n_in, n_out, fold):
    w, b = _rng_w(n_in, n_out, n_in), _rng_w(n_out, n_out)
    sd = {"lin.weight": torch.from_numpy(w), "lin.bias": torch.from_numpy(b)}
    if fold:
        gamma, beta, mean, var = _bn(n_in + n_out, n_out)
        pf = fold_bn(*map(torch.from_numpy, (gamma, beta, mean, var, b)))
        jf = tuple(np.asarray(a) for a in pf)
        got = pq._q_dense(sd, "lin", pf)
        want = jq._q_dense({"kernel": w.T, "bias": b}, fold=jf)
    else:
        got = pq._q_dense(sd, "lin")
        want = jq._q_dense({"kernel": w.T, "bias": b})
        _codes_equal(pq._q_linear_t(*sd.values()), jq._q_linear_t(w, b))
    _codes_equal(got, want)


@pytest.mark.parametrize("o, c, k", [(64, 32, 15), (32, 64, 5), (12, 6, 3)])
def test_q_conv_matches_jax(o, c, k):
    w, bias = _rng_w(o + c, o, c, k), _rng_w(k, o)
    pf = fold_bn(*map(torch.from_numpy, (*_bn(o, o), bias)))
    got = pq._q_conv(torch.from_numpy(w), pf)
    want = jq._q_conv(w, tuple(np.asarray(a) for a in pf))
    _codes_equal(got, want)


def _scaled_close(got: torch.Tensor, want, rtol: float) -> None:
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead, k, n", [((5,), 38, 32), ((16,), 230, 3), ((17,), 96, 12),
                                        ((3, 7), 36, 20), ((1,), 8, 8)])
def test_qdot_matches_jax(lead, k, n, dtype):
    x = np.random.default_rng(k + n).normal(size=(*lead, k)).astype(np.float32)
    w, b = _rng_w(k * n, n, k), _rng_w(n, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    got = pq._qdot(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt),
                   pq._q_linear_t(torch.from_numpy(w), torch.from_numpy(b)), tdt)
    want = jq._qdot(xj, jq._q_linear_t(w, b), jdt)
    assert got.dtype == tdt and got.shape == (*lead, n)
    _scaled_close(got, np.asarray(want.astype(jnp.float32)),
                  PRODUCT_RTOL if dtype == "float32" else 2.0 ** -8)


@pytest.mark.parametrize("b, t, c, o, k, pad", [(5, 64, 32, 64, 15, 7), (16, 16, 64, 32, 5, 2),
                                                (2, 9, 6, 12, 3, 0)])
def test_qconv1d_matches_jax(b, t, c, o, k, pad):
    x = np.random.default_rng(t).normal(size=(b, t, c)).astype(np.float32)
    w = _rng_w(o * k, o, c, k)
    pf = fold_bn(*map(torch.from_numpy, (*_bn(c, o), _rng_w(o, o))))
    got = pq._qconv1d(torch.from_numpy(x), pq._q_conv(torch.from_numpy(w), pf), pad,
                      torch.float32)
    want = jq._qconv1d(jnp.asarray(x), jq._q_conv(w, tuple(np.asarray(a) for a in pf)), pad,
                       jnp.float32)
    assert got.shape == (b, t + 2 * pad - k + 1, o)
    _scaled_close(got, want, PRODUCT_RTOL)


@pytest.fixture(scope="module", params=sorted(DIMS))
def case(request):
    feat_dim, eeg_time, b = DIMS[request.param]
    v = jax_variables(feat_dim, eeg_time, seed=31)
    x = inputs(b, eeg_time, seed=32)
    sd = state_dict_from_jax_variables(v)
    fp32 = tuple(o.numpy() for o in build_serving_forward(sd, feat_dim)(*map(torch.from_numpy, x)))
    return feat_dim, v, sd, x, fp32


@pytest.mark.parametrize("glue", ["float32", "bfloat16"])
def test_int8_forward_matches_jax(case, glue):
    feat_dim, v, sd, x, _ = case
    got = pq.build_quantized_serving_forward(sd, feat_dim, getattr(torch, glue))(
        *map(torch.from_numpy, x))
    want = jq.build_quantized_serving_forward(jax.tree.map(jnp.asarray, v), feat_dim,
                                              getattr(jnp, glue))(*x)
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    for g in got:
        assert g.dtype == np.float32 and g.shape == (len(x[0]), 3) and np.isfinite(g).all()
    if glue == "bfloat16":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=BF16_GLUE_ATOL)
        return
    rows = np.max([np.abs(g - w).max(-1) for g, w in zip(got, want)], axis=0)
    scale = max(np.abs(w).max() for w in want)
    flipped = rows > ROW_ATOL
    assert flipped.mean() <= FLIPPED_ROWS, rows
    assert rows.max() <= FLIPPED_REL * scale, rows


@pytest.mark.parametrize("glue", ["float32", "bfloat16"])
def test_int8_forward_meets_jax_bar_against_fp32_serving(case, glue):
    feat_dim, _, sd, x, fp32 = case
    got = pq.build_quantized_serving_forward(sd, feat_dim, getattr(torch, glue))(
        *map(torch.from_numpy, x))
    for ref, g in zip(fp32, got):
        g = g.numpy()
        assert np.isfinite(g).all()
        assert np.abs(ref - g).max() <= 0.1 * np.abs(ref).max()
        assert (ref.argmax(-1) == g.argmax(-1)).mean() >= 0.9

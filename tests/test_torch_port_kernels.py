"""The port's kernel modules (``multimodal_sentiment_aanalysis_tpu_torch.kernels``).

On the CPU, each module's plain PyTorch version is held against the JAX
package's Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs
it) and against the JAX jnp path, on the same numpy inputs at the small
shapes the JAX tests use. Tolerances: BiLSTM atol 2e-5 (fp32 summation
order over 7 steps); stems atol 1e-4 (the Pallas kernels' polynomial erf,
|error| < 1.5e-7, plus conv summation order).

The ``gpu``-marked tests hold each CUDA kernel against its plain version on
the card, at the shapes the serving path gives it. They skip without a card
and import no JAX, so they run on a machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_port_kernels.py``.
"""

import math
import shutil

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch import kernels
from multimodal_sentiment_aanalysis_tpu_torch.kernels import _build, conv_stem, conv_stem_train, lstm
from multimodal_sentiment_aanalysis_tpu_torch.ops import rnn
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# --------------------------------------------------------------------------
# inputs (numpy, from a seed) shared by the CPU and card tests
# --------------------------------------------------------------------------


def _lstm_inputs(seed, b, t, i, h):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)
    params = [tuple(mk(*s) for s in [(4 * h, i), (4 * h, h), (4 * h,), (4 * h,)])
              for _ in range(2)]
    return rng.normal(size=(b, t, i)).astype(np.float32), params[0], params[1]


def _bn_inputs(rng, c):
    return (
        (rng.normal(size=c) * 0.3 + 1).astype(np.float32),   # gamma
        (rng.normal(size=c) * 0.1).astype(np.float32),       # beta
        (rng.normal(size=c) * 0.1).astype(np.float32),       # running mean
        (rng.random(c) + 0.5).astype(np.float32),            # running var
    )


def _stem_tail_inputs(seed, b, t, c):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, c)).astype(np.float32), *_bn_inputs(rng, c))


def _conv_stem_inputs(seed, b, t, c, o, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    w = (rng.normal(size=(o, c, k)) * 0.1).astype(np.float32)
    bias = rng.normal(size=o).astype(np.float32)
    return x, w, bias, *_bn_inputs(rng, o)


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


# --------------------------------------------------------------------------
# CPU: plain versions against the JAX package
# --------------------------------------------------------------------------

LSTM_PORT = {
    "kernels.lstm.fused_bilstm_layer": lstm.fused_bilstm_layer,
    "ops.rnn.bilstm_layer": rnn.bilstm_layer,
}


@pytest.mark.parametrize("jax_path", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("port_fn", sorted(LSTM_PORT))
def test_bilstm_plain_matches_jax(jax_path, port_fn):
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels.lstm import fused_bilstm_layer
    from multimodal_sentiment_aanalysis_tpu.ops.rnn import bilstm_layer

    x, fwd, bwd = _lstm_inputs(0, 8, 7, 12, 128)  # tests/test_kernels.py shapes
    jfwd, jbwd = (tuple(map(jnp.asarray, p)) for p in (fwd, bwd))
    if jax_path == "pallas_interpret":
        ref = fused_bilstm_layer(jnp.asarray(x), jfwd, jbwd, interpret=True, use_xproj=True)
    else:
        ref = bilstm_layer(jnp.asarray(x), jfwd, jbwd, use_fused=False)
    got = LSTM_PORT[port_fn](torch.from_numpy(x), tuple(_torch(fwd)), tuple(_torch(bwd)))
    assert got.shape == (8, 7, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_single_direction_lstm_matches_jax():
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.ops.rnn import lstm as jax_lstm

    x, fwd, _ = _lstm_inputs(1, 4, 9, 12, 16)
    for reverse in (False, True):
        ref = jax_lstm(jnp.asarray(x), *map(jnp.asarray, fwd), reverse=reverse)
        got = rnn.lstm(torch.from_numpy(x), *_torch(fwd), reverse=reverse)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("jax_path", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("t,c,pool", [(585, 64, 4), (146, 256, 2)])
def test_stem_tail_plain_matches_jax(jax_path, t, c, pool):
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import conv_stem_train as cst
    from multimodal_sentiment_aanalysis_tpu.models.eeg import max_pool1d

    arrays = _stem_tail_inputs(2, 16, t, c)  # TestFusedTrainStem batch
    conv, gamma, beta, mean, var = map(jnp.asarray, arrays)
    if jax_path == "pallas_interpret":
        ref = cst.fused_stage_train(conv, gamma, beta, mean, var,
                                    jnp.zeros((8, 128), jnp.int32), 0.0, pool, 1e-5, True)
    else:  # models/eeg.py eval-mode jnp path
        y = (conv - mean) * jax.lax.rsqrt(var + 1e-5) * gamma + beta
        ref = max_pool1d(jax.nn.gelu(y, approximate=False), pool)
    got = conv_stem_train.fused_stage_train(*_torch(arrays), 0.0, pool)
    assert got.shape == (16, t // pool, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("jax_path", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("c,o,k,pad,pool,t", [(32, 64, 15, 7, 4, 585), (64, 128, 5, 2, 2, 146)])
def test_conv_stem_plain_matches_jax(jax_path, c, o, k, pad, pool, t):
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels.conv_stem import (
        fold_bn,
        fused_conv_bn_gelu_pool,
    )

    arrays = _conv_stem_inputs(3, 6, t, c, o, k)
    x, w, bias, gamma, beta, mean, var = map(jnp.asarray, arrays)
    if jax_path == "pallas_interpret":  # interpret is automatic off the TPU
        ref = fused_conv_bn_gelu_pool(x, w, *fold_bn(gamma, beta, mean, var, bias), pad, pool)
    else:  # tests/test_kernels.py jnp reference
        conv = jax.lax.conv_general_dilated(
            x, jnp.transpose(w, (2, 1, 0)), (1,), [(pad, pad)],
            dimension_numbers=("NWC", "WIO", "NWC")) + bias
        bn = gamma * (conv - mean) / jnp.sqrt(var + 1e-5) + beta
        act = 0.5 * bn * (1.0 + jax.lax.erf(bn / math.sqrt(2.0)))
        ref = act[:, : (t // pool) * pool].reshape(6, t // pool, pool, o).max(axis=2)
    tx, tw, tbias, tgamma, tbeta, tmean, tvar = _torch(arrays)
    scale, shift = conv_stem.fold_bn(tgamma, tbeta, tmean, tvar, tbias)
    got = conv_stem.fused_conv_bn_gelu_pool(tx, tw, scale, shift, pad, pool)
    assert got.shape == (6, t // pool, o)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_fold_bn_matches_jax():
    from multimodal_sentiment_aanalysis_tpu.kernels.conv_stem import fold_bn

    rng = np.random.default_rng(4)
    gamma, beta, mean, var = _bn_inputs(rng, 64)
    bias = rng.normal(size=64).astype(np.float32)
    ref = fold_bn(gamma, beta, mean, var, bias)
    got = conv_stem.fold_bn(*_torch([gamma, beta, mean, var, bias]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_wrappers_reject_other_devices_and_dropout():
    """A tensor that is neither on the CPU nor on a card has no path; a
    dropout rate outside [0, 1) is refused."""
    x = torch.empty(2, 8, 4, device="meta")
    w = torch.empty(4, 4, 3, device="meta")
    with pytest.raises(ValueError):
        conv_stem.fused_conv_bn_gelu_pool(x, w, w[:, 0, 0], w[:, 0, 0], 1, 2)
    with pytest.raises(ValueError):
        conv_stem_train.fused_stage_train(x, *[w[:, 0, 0]] * 4, 0.0, 2)
    with pytest.raises(ValueError):
        lstm.fused_bilstm_layer(x, (torch.empty(4, 4, device="meta"),) * 4,
                                (torch.empty(4, 4, device="meta"),) * 4)
    conv, *bn = _torch(_stem_tail_inputs(5, 2, 8, 4))
    for p in (1.0, -0.1):
        with pytest.raises(ValueError):
            conv_stem_train.fused_stage_train(conv, *bn, p, 2)
    out = conv_stem_train.fused_stage_train(conv, *bn, 0.4, 2,
                                            generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 4, 4) and torch.isfinite(out).all()


def test_cpu_tensors_launch_nothing():
    """Forward and backward of every wrapper on CPU tensors take the plain
    versions and count no launch."""
    from multimodal_sentiment_aanalysis_tpu_torch.kernels import attention, contrastive, fusion_head, iir
    from multimodal_sentiment_aanalysis_tpu_torch.models import MEMHACLClassifier, MultiheadAttention
    from multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model import init_parameters

    kernels.reset_launch_counts()
    x, fwd, bwd = _lstm_inputs(6, 2, 3, 8, 4)
    fwd = tuple(t.requires_grad_() for t in _torch(fwd))
    for schedule in lstm.SCHEDULES:
        lstm.fused_bilstm_layer(torch.from_numpy(x), fwd, tuple(_torch(bwd)),
                                schedule=schedule).sum().backward()
        bf = torch.bfloat16  # and each schedule's bf16 forms
        lstm.fused_bilstm_layer(torch.from_numpy(x).to(bf).requires_grad_(),
                                tuple(t.detach().to(bf) for t in fwd),
                                tuple(t.to(bf) for t in _torch(bwd)),
                                schedule=schedule).float().sum().backward()
    conv, *bn = _torch(_stem_tail_inputs(6, 2, 8, 4))
    conv.requires_grad_()
    conv_stem_train.fused_stage_train(conv, *bn, 0.4, 2).sum().backward()
    feats = torch.randn(3, 4, 5, requires_grad=True)
    contrastive.fused_supervised_infonce_multi(feats, feats, torch.tensor([0, 1, 0, 1]),
                                               0.1).sum().backward()
    q = torch.randn(1, 2, 12, 8, requires_grad=True)
    attention.flash_mha(q, q, q).sum().backward()
    q16 = q.detach().to(torch.bfloat16).requires_grad_()  # and the bf16 forms
    attention.flash_mha(q16, q16, q16).float().sum().backward()
    x = torch.randn(5, 16)
    mha, clf = MultiheadAttention(16, 4), MEMHACLClassifier(16, 8)
    init_parameters(mha)
    with torch.no_grad():
        fusion_head.fused_mha_fusion_head(x, x, x, mha, clf, 4)
    series = []
    for dtype in (torch.float32, torch.float64):
        sos = torch.tensor([[0.2, 0.4, 0.2, 1.0, -0.3, 0.1]], dtype=dtype)
        series.append(torch.randn(3, 12, dtype=dtype, requires_grad=True))
        iir.sos_filtfilt(series[-1], sos, torch.ones(1, 2, dtype=dtype), 3).sum().backward()
    assert fwd[0].grad is not None and conv.grad is not None and feats.grad is not None
    assert q.grad is not None and q16.grad is not None
    assert all(x.grad is not None for x in series)
    training = ("bilstm_fwd", "bilstm_cbnd", "bilstm_segbwd", "bilstm_gemm", "bilstm_rec",
                "bilstm_sweep", "stem_tail", "stem_tail_bwd", "infonce")
    assert kernels.launch_counts() == {
        **{name: 0 for name in training}, **{f"{name}_bf16": 0 for name in training},
        "conv_stem": 0, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_fwd_bf16": 0, "flash_bwd_dq_bf16": 0, "flash_bwd_dkv_bf16": 0,
        "fusion_head": 0, "fusion_head_bf16": 0, "bilstm_cscan": 0,
        **{f"{name}{sfx}": 0 for name in ("bilstm_fwd_xp", "bilstm_bwd_xp", "bilstm_cseq",
                                           "bilstm_bwd_split", "bilstm_bwdc", "bilstm_cbndk")
           for sfx in ("", "_bf16")},
        "sos_filtfilt": 0, "sos_filtfilt_f64": 0}


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No toolkit, no kernel: the build raises and nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("lstm_fwd")
    assert list(tmp_path.iterdir()) == []


def test_build_reuses_library_until_a_source_changes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    before = _build._digest(csrc / "stem_tail.cu")
    (tmp_path / "build").mkdir()
    lib = tmp_path / "build" / f"stem_tail-{before}.so"
    lib.write_bytes(b"")
    assert _build.build("stem_tail") == lib  # current build found: no nvcc needed
    header = csrc / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._digest(csrc / "stem_tail.cu") != before
    with pytest.raises(RuntimeError, match="nvcc not found"):  # stale: must rebuild
        _build.build("stem_tail")


# --------------------------------------------------------------------------
# card: CUDA kernels against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# the serving path's shapes (B=64, full width) plus one ragged shape each
# that leaves partial tiles in every blocked dimension
LSTM_SHAPES = {"layer": (64, 73, 256, 128), "ragged": (5, 7, 12, 64)}
STEM_TAIL_SHAPES = {"stage1": (64, 585, 64, 4), "stage2": (64, 146, 256, 2),
                    "ragged": (3, 11, 5, 3)}
CONV_STEM_SHAPES = {"stage1": (64, 585, 32, 64, 15, 7, 4),
                    "stage2": (64, 146, 64, 256, 5, 2, 2),
                    "ragged": (3, 37, 7, 40, 3, 1, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(LSTM_SHAPES))
def test_bilstm_kernel_matches_plain(cuda, shape):
    x, fwd, bwd = _lstm_inputs(7, *LSTM_SHAPES[shape])
    x, fwd, bwd = torch.from_numpy(x).to(cuda), tuple(_torch(fwd, cuda)), tuple(_torch(bwd, cuda))
    before = lstm.KERNEL.launches
    got = lstm.fused_bilstm_layer(x, fwd, bwd)
    assert lstm.KERNEL.launches == before + 1
    want = lstm.fused_bilstm_layer_plain(x, fwd, bwd)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(STEM_TAIL_SHAPES))
def test_stem_tail_kernel_matches_plain(cuda, shape):
    b, t, c, pool = STEM_TAIL_SHAPES[shape]
    args = _torch(_stem_tail_inputs(8, b, t, c), cuda)
    before = conv_stem_train.KERNEL.launches
    got = conv_stem_train.fused_stage_train(*args, 0.0, pool)
    assert conv_stem_train.KERNEL.launches == before + 1
    want = conv_stem_train.fused_stage_train_plain(*args, pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CONV_STEM_SHAPES))
def test_conv_stem_kernel_matches_plain(cuda, shape):
    b, t, c, o, k, pad, pool = CONV_STEM_SHAPES[shape]
    x, w, bias, *bn = _torch(_conv_stem_inputs(9, b, t, c, o, k), cuda)
    scale, shift = conv_stem.fold_bn(*bn, bias)
    before = conv_stem.KERNEL.launches
    got = conv_stem.fused_conv_bn_gelu_pool(x, w, scale, shift, pad, pool)
    assert conv_stem.KERNEL.launches == before + 1
    want = conv_stem.fused_conv_bn_gelu_pool_plain(x, w, scale, shift, pad, pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_bad_input(cuda):
    conv, *bn = _torch(_stem_tail_inputs(10, 2, 8, 4), cuda)
    with pytest.raises(ValueError):  # not contiguous
        conv_stem_train.fused_stage_train(conv.transpose(0, 1), *bn, 0.0, 2)
    with pytest.raises(TypeError):  # not fp32
        conv_stem_train.fused_stage_train(conv.double(), *bn, 0.0, 2)
    with pytest.raises(ValueError):  # dropout rate outside [0, 1)
        conv_stem_train.fused_stage_train(conv, *bn, 1.5, 2)
    x, fwd, bwd = _lstm_inputs(10, 2, 3, 8, 300)  # 4H > 1024 threads
    with pytest.raises(ValueError):
        lstm.fused_bilstm_layer(torch.from_numpy(x).to(cuda), tuple(_torch(fwd, cuda)),
                                tuple(_torch(bwd, cuda)))

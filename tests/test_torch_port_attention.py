"""The port's flash attention (``kernels/attention.py``) and the
``MultiheadAttention`` that dispatches to it.

On the CPU each wrapper takes its plain version, which is held against the
JAX package's Pallas kernels in interpret mode on the same numpy inputs:
the forward ``(O, LSE)`` at the JAX test's shapes (rtol 1e-4, atol 1e-5),
the two backward kernels and the gradients of ``flash_mha(force=True)`` at
(1, 2, 96/80, 16) (rtol 1e-3, atol 1e-4: sums over 80-96 rows of products
of O(1) terms). The port's ``MultiheadAttention`` is held against the flax
module below and above the length-8 dispatch (1e-5), with no launch on the
CPU. ``flash_mha`` zero-pads a head dim between the kernels' sizes (held
against JAX at Dh 48 and 100), runs fp16 in fp32, takes bf16 to the bf16
forms (their plain versions on the CPU; the bf16 path is held against JAX
in ``tests/test_torch_port_flash_bf16.py``), and refuses a second-order
gradient.

The ``gpu``-marked tests hold each CUDA kernel against its plain version
on the card at ragged shapes (forward 1e-4, backward 1e-3), and against
fp64: the forward's O and LSE within 1e-5 of their largest entry, dQ, dK
and dV within 1e-5 of their scale (the largest sum of absolute terms) at
ragged lengths, every head dim and tile pair: bars one TF32 pass misses
(``tests/test_torch_port_flash_fwd_tc.py``, ``..._flash_bwd_tc.py``). They
skip without a card:
``python -m pytest --noconftest -m gpu tests/test_torch_port_attention.py``.
"""

import math

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch import kernels
from multimodal_sentiment_aanalysis_tpu_torch.kernels import attention
from multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model import init_parameters
from multimodal_sentiment_aanalysis_tpu_torch.models.layers import MultiheadAttention
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FLASH_SHAPES = [(128, 128), (73, 73), (64, 256), (200, 100)]


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, tq, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32))


def _flat(q, k, v):
    """The kernels' ``(BH, T, D)`` operands, ``q`` pre-scaled."""
    b, h, tq, d = q.shape
    return ((q / np.float32(math.sqrt(d))).reshape(b * h, tq, d).astype(np.float32),
            k.reshape(b * h, -1, d), v.reshape(b * h, -1, d))


# --------------------------------------------------------------------------
# CPU: the plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tq,tk", FLASH_SHAPES)
def test_flash_fwd_plain_matches_pallas(tq, tk):
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import attention as ja

    q, k, v = _flat(*_qkv(0, 2, 4, tq, tk, 32))
    o_ref, lse_ref = ja._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 64)
    o, lse = attention.flash_fwd(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, :tq, 0], rtol=1e-4, atol=1e-5)


def test_flash_bwd_plain_matches_pallas():
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import attention as ja

    q, k, v = _flat(*_qkv(1, 1, 2, 96, 80, 16))
    do = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o_ref, lse_ref = ja._flash_fwd(jq, jk, jv, 32, 32)
    want = ja._flash_bwd(jq, jk, jv, o_ref, lse_ref, jdo, 32, 32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention.flash_fwd(tq, tk, tv)
    delta = (tdo * o).sum(-1)
    dq = attention.flash_bwd_dq(tq, tk, tv, tdo, lse, delta)
    dk, dv = attention.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("tq,tk", FLASH_SHAPES)
def test_flash_mha_matches_jax(tq, tk):
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels.attention import flash_mha as jax_flash

    q, k, v = _qkv(3, 2, 4, tq, tk, 32)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=64, block_k=64, force=True)
    got = attention.flash_mha(*map(torch.from_numpy, (q, k, v)), force=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_flash_mha_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels.attention import flash_mha as jax_flash

    q, k, v = _qkv(4, 1, 2, 96, 80, 16)
    want = jax.grad(lambda *a: (jax_flash(*a, block_q=32, block_k=32, force=True) ** 2).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (attention.flash_mha(tq, tk, tv, force=True) ** 2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dh", [48, 100])
def test_flash_mha_pads_other_head_dims_to_jax(dh):
    """A head dim between the kernels' sizes is zero-padded to the next one
    and sliced back: forward and gradients equal the JAX function's."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels.attention import flash_mha as jax_flash

    q, k, v = _qkv(10, 1, 2, 40, 24, dh)
    loss = lambda *a: (jax_flash(*a, block_q=32, block_k=32, force=True) ** 2).sum()
    want, want_g = jax.value_and_grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention.flash_mha(tq, tk, tv, force=True)
    assert out.shape == (1, 2, 40, dh)
    (out ** 2).sum().backward()
    np.testing.assert_allclose((out ** 2).sum().item(), float(want), rtol=1e-5)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want_g):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


def test_flash_mha_half_dtypes_run_in_float32():
    """fp16 operands still run in fp32 and come back as fp16; bf16 operands
    now take the bf16 forms (on the CPU their bf16 plain versions, ``q``
    scaled in bf16) and come back as bf16, gradients included."""
    x = _qkv(11, 2, 2, 20, 12, 16)
    q, k, v = (torch.from_numpy(a).to(torch.float16) for a in x)
    got = attention.flash_mha(q, k, v)
    assert got.dtype == torch.float16
    want = attention.flash_mha(q.float(), k.float(), v.float())
    assert torch.equal(got, want.to(torch.float16))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in x)
    got = attention.flash_mha(q, k, v)
    assert got.dtype == torch.bfloat16
    flat = lambda t: t.detach().reshape(4, -1, 16)
    want, _ = attention.flash_fwd_plain(attention.scale_q(flat(q)), flat(k), flat(v))
    assert torch.equal(got.reshape(4, 20, 16), want)
    got.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))
    torch.testing.assert_close(got.float(), attention.mha_reference(*map(torch.from_numpy, x)),
                               rtol=0, atol=1e-2)


def test_flash_mha_refuses_double_backward():
    """The backward kernels are not differentiable: a second-order gradient
    raises instead of returning a wrong one."""
    q = torch.randn(1, 2, 12, 16, requires_grad=True)
    (g,) = torch.autograd.grad((attention.flash_mha(q, q, q) ** 2).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_flash_mha_dispatch_and_no_cpu_launch():
    """Both lengths <= 8 take ``mha_reference`` (the flagship's sites, at
    length 1); ``force`` or a longer length takes the Function; CPU
    tensors launch nothing."""
    kernels.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(5, 2, 4, 8, 8, 16))
    assert torch.equal(attention.flash_mha(q, k, v), attention.mha_reference(q, k, v))
    q.requires_grad_()
    forced = attention.flash_mha(q, k, v, force=True)
    assert type(forced.grad_fn).__name__ == "ViewBackward0"  # reshape of the Function's O
    assert "FlashAttention" in type(forced.grad_fn.next_functions[0][0]).__name__
    torch.testing.assert_close(forced, attention.mha_reference(q, k, v), rtol=1e-5, atol=1e-6)
    forced.sum().backward()
    long_q = torch.randn(1, 2, 9, 16)
    torch.testing.assert_close(attention.flash_mha(long_q, long_q, long_q),
                               attention.mha_reference(long_q, long_q, long_q),
                               rtol=1e-5, atol=1e-6)
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_flash_function_refuses_vmap():
    """No vmapped path reaches length > 8, so the Function has no vmap rule."""
    q = torch.randn(3, 1, 2, 12, 8)
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(lambda x: attention.flash_mha(x, x, x))(q)


def test_flash_wrappers_refuse_other_devices():
    q = torch.empty(2, 12, 16, device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        attention.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        attention.flash_bwd_dq(q, q, q, q, q[..., 0], q[..., 0])
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        attention.flash_bwd_dkv(q, q, q, q, q[..., 0], q[..., 0])


# --------------------------------------------------------------------------
# CPU: MultiheadAttention against the flax module
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tq,tk", [(3, 3), (20, 20), (20, 12)])
def test_multihead_attention_matches_flax(tq, tk):
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.models.layers import (
        MultiheadAttention as FlaxMHA,
    )

    e, heads, b = 32, 4, 3
    rng = np.random.default_rng(6)
    xq = rng.normal(size=(b, tq, e)).astype(np.float32)
    xk = rng.normal(size=(b, tk, e)).astype(np.float32)
    flax_mha = FlaxMHA(e, heads)
    params = flax_mha.init(jax.random.key(0), xq, xk, xk)["params"]
    params = {k: np.asarray(p) + rng.normal(size=p.shape).astype(np.float32) * 0.1
              for k, p in params.items()}  # nonzero biases
    want = flax_mha.apply({"params": params}, *map(jnp.asarray, (xq, xk, xk)))

    port = MultiheadAttention(e, heads)
    port.load_state_dict({"in_proj_weight": torch.from_numpy(params["in_proj_weight"]),
                          "in_proj_bias": torch.from_numpy(params["in_proj_bias"]),
                          "out_proj.weight": torch.from_numpy(params["out_proj_weight"]),
                          "out_proj.bias": torch.from_numpy(params["out_proj_bias"])})
    kernels.reset_launch_counts()
    tq_in, tk_in = torch.from_numpy(xq), torch.from_numpy(xk)
    got = port(tq_in, tk_in, tk_in)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert port.in_proj_weight.grad is not None
    assert all(n == 0 for n in kernels.launch_counts().values())


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


# (BH, tq, tk, D, block_q, block_k): partial tiles in both lengths, every
# head dim the kernels are built for, tq != tk both ways, other tiles; and
# ragged lengths (1, 63, 65) in every pair, the head dims in turn, so each
# head dim meets one row or key alone and a tile one short or one over
CARD_SHAPES = {
    "t9": (16, 9, 9, 32, 64, 64),
    "cross": (8, 200, 100, 32, 64, 64),
    "long_k": (4, 73, 130, 16, 32, 128),
    "d64": (3, 33, 65, 64, 64, 32),
    "d8": (5, 17, 5, 8, 128, 64),
    "d128": (4, 70, 45, 128, 64, 64),
    **{f"ragged_{tq}_{tk}": (3, tq, tk, attention.HEAD_DIMS[(a + b) % 5], 64, 64)
       for a, tq in enumerate((1, 63, 65)) for b, tk in enumerate((1, 63, 65))},
}
# the kernels against fp64 (chip_smoke.py's FLASH_FP64_REL): the forward's O
# and LSE within this share of their largest entry, dQ, dK and dV of their
# scale (attention.flash_bwd_magnitudes)
FP64_REL = 1e-5


def _card_inputs(cuda, bh, tq, tk, d, seed=7):
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(bh, tq, d, generator=g) / math.sqrt(d)).to(cuda)
    k, v = (torch.randn(bh, tk, d, generator=g).to(cuda) for _ in range(2))
    do = torch.randn(bh, tq, d, generator=g).to(cuda)
    return q, k, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_flash_kernels_match_plain(cuda, shape):
    bh, tq, tk, d, bq, bk = CARD_SHAPES[shape]
    q, k, v, do = _card_inputs(cuda, bh, tq, tk, d)
    before = kernels.launch_counts()
    o, lse = attention.flash_fwd(q, k, v, bq, bk)
    delta = (do * o).sum(-1)
    dq = attention.flash_bwd_dq(q, k, v, do, lse, delta, bq, bk)
    dk, dv = attention.flash_bwd_dkv(q, k, v, do, lse, delta, bq, bk)
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    o_ref, lse_ref = attention.flash_fwd_plain(q, k, v)
    dq_ref = attention.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta)
    dk_ref, dv_ref = attention.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta)
    o64, lse64 = attention.flash_fwd_plain(q.double(), k.double(), v.double())
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    for got, ref in ((o, o64), (lse, lse64)):  # 3xTF32: as accurate as fp32
        assert (got.double() - ref).abs().max() <= FP64_REL * ref.abs().max()
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("d", attention.HEAD_DIMS)
@pytest.mark.parametrize("bq,bk", [(bq, bk) for bq in attention.TILES for bk in attention.TILES])
def test_flash_bwd_kernels_match_fp64(cuda, d, bq, bk):
    """dQ, dK and dV at ragged lengths (1, 63, 65 queries and keys: a row or
    key alone, a tile one short or one over) against the fp64 plain
    versions on the same inputs, within FP64_REL of each output's scale
    (``attention.flash_bwd_magnitudes``; at Tk = 1 dQ and dK cancel to 0),
    at every head dim and tile pair the backward wrappers take."""
    for tq in (1, 63, 65):
        for tk in (1, 63, 65):
            q, k, v, do = _card_inputs(cuda, 3, tq, tk, d, seed=tq * 100 + tk)
            o, lse = attention.flash_fwd_plain(q, k, v)
            args = (q, k, v, do, lse, (do * o).sum(-1))
            got = [attention.flash_bwd_dq(*args, bq, bk), *attention.flash_bwd_dkv(*args, bq, bk)]
            args64 = [a.double() for a in args]
            want = [attention.flash_bwd_dq_plain(*args64), *attention.flash_bwd_dkv_plain(*args64)]
            for g, w, scale in zip(got, want, attention.flash_bwd_magnitudes(*args64)):
                err = (g.double() - w).abs().max()
                assert err <= FP64_REL * scale, (tq, tk, (err / scale).item())


@pytest.mark.gpu
def test_multihead_attention_on_card_matches_cpu(cuda):
    """T = 20 self-attention through the three kernels: outputs and every
    gradient against the CPU plain path."""
    cpu = MultiheadAttention(64, 8)
    init_parameters(cpu, torch.Generator().manual_seed(8))
    card = MultiheadAttention(64, 8, device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(6, 20, 64, generator=torch.Generator().manual_seed(9))
    outs = []
    before = kernels.launch_counts()
    for m, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        xi = x.to(dev).requires_grad_()
        y = m(xi, xi, xi)
        (y ** 2).sum().backward()
        outs.append((y.detach().cpu(), xi.grad.cpu(), m.in_proj_weight.grad.cpu()))
    after = kernels.launch_counts()
    assert all(after[n] - before[n] == 1 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [48, 128])
def test_flash_mha_other_head_dims_on_card_match_cpu(cuda, dh):
    """Dh = 48 runs the 64 kernels on zero-padded operands, Dh = 128 its own
    build: output and gradients against the CPU plain path."""
    x = _qkv(12, 2, 4, 70, 45, dh)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True) for a in x)
        before = kernels.launch_counts()
        y = attention.flash_mha(q, k, v)
        (y ** 2).sum().backward()
        after = kernels.launch_counts()
        outs.append((y.detach().cpu(), q.grad.cpu(), k.grad.cpu(), v.grad.cpu()))
        launched = {after[n] - before[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        assert launched == ({1} if dev.type == "cuda" else {0})
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_flash_mha_refuses_double_backward_on_card(cuda):
    q = torch.randn(1, 2, 12, 16, device=cuda, requires_grad=True)
    (g,) = torch.autograd.grad((attention.flash_mha(q, q, q) ** 2).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


@pytest.mark.gpu
def test_flash_wrappers_raise_on_bad_input(cuda):
    q, k, v, _ = _card_inputs(cuda, 2, 12, 12, 24)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_fwd(q, k, v)
    q, k, v, _ = _card_inputs(cuda, 2, 12, 12, 32)
    with pytest.raises(ValueError, match="block_q"):
        attention.flash_fwd(q, k, v, 48, 64)
    with pytest.raises(TypeError):
        attention.flash_fwd(q.double(), k, v)
    with pytest.raises(ValueError):  # not contiguous
        attention.flash_fwd(q.transpose(0, 1), k, v)

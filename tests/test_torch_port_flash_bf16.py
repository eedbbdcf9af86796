"""The bf16 forms of the flash-attention kernels (rows 14-16 in bf16,
``csrc/flash_attn_bf16.cu``) and the bf16 path of ``flash_mha`` and
``MultiheadAttention`` above the length-8 dispatch.

On the CPU each wrapper takes its bf16 plain version, which rounds where
the kernels round (products of bf16 operands summed in fp32, P and dS
rounded to bf16 for their products, O, dQ, dK and dV returned as bf16, LSE
fp32). Held against the JAX package on the same numpy inputs, rounded to
bf16 on both sides:

- the forward against JAX ``_flash_fwd`` in interpret mode at bf16: O
  within 1e-2 of max |O| (bf16 rounds O to 2^-9 of itself; JAX interpret
  mode keeps P in fp32 for P V), LSE within 1e-4 relative (both fp32 from
  exact products);
- the two backward kernels against JAX ``_flash_bwd`` at bf16: dQ, dK and
  dV within 5e-3 of each one's scale (``attention.flash_bwd_magnitudes``;
  1.9e-3 measured: JAX's interpret mode keeps P and dS in fp32 for their
  products, the port rounds them to bf16 as the TPU's DEFAULT dot does);
- delta: ``attention.flash_delta`` and the delta ``_FlashAttention`` hands
  the kernels equal JAX's ``(do * o).sum(-1)`` at bf16 bit for bit (a bf16
  row sum of the bf16 products, as ``_flash_bwd`` forms it);
- ``flash_mha(force=True)`` and its gradients against JAX ``flash_mha(...,
  force=True)`` at bf16, at ragged lengths and at Dh 8 (padded to 16), 32
  and 48: the output within 1e-2 of max |O|, each gradient within 1e-2 of
  its largest entry (6.5e-3 measured);
- the port's bf16 ``MultiheadAttention`` (flax parameters imported, then
  both cast to bf16) against the flax module applied with bf16 parameters,
  above length 8. On the CPU the flax module takes ``mha_reference``, which
  rounds the scores and the softmax to bf16: within 3e-2 of max |y|;
- the bf16 scaling of ``q`` bit for bit against JAX's ``q * scale`` at Dh =
  32, whose scale 1/sqrt(32) is not exact in bf16.

Against the emulation of the kernels' arithmetic (``torch_flash_emulation``:
bf16 operands, exact products summed in fp64 and rounded to fp32, P and dS
rounded to bf16): the forward's O within one bf16 ulp (2^-7 of |O|) plus
2e-3 of max |O| (the plain version takes P = exp(S - m) at each row's
final max, the kernel at the running max of its key tile, so P rounds at
other values; 1.5e-3 measured), LSE within 1e-6 relative; dQ, dK and dV
within one ulp plus 1e-3 of their scale (the same rounding points, but
``exp`` and the kernels' ``exp2`` differ in the last fp32 bit, which now and
then rounds a P or dS to the other bf16 neighbour; 1.8e-4 measured). The emulation against fp64
meets ``chip_smoke.py``'s bf16 bars (O 1e-2 of max |O|, LSE 1e-5 of max
|LSE|, dQ, dK and dV 1e-2 of their scale) at the shapes where they were
set; with ``ex2.approx.ftz``'s flush of subnormal exps, the forward's still
meets them. The fragment tests put the Hopper kernels' TMA tiles, wgmma
descriptors (K-major and MN-major, 32/64/128-byte swizzles) and m64nNk16
fragments through the hardware's layouts at every head dim and tile, and
the forward's persistent walk over its items and ring stages.

The ``gpu``-marked tests hold each bf16 kernel against its plain version
on the card (O one ulp plus 2e-3, LSE 1e-4, dQ, dK and dV one ulp plus
2e-3 of their scale) and against fp64 at the bars above, at ragged shapes,
every head dim and every tile pair, two runs of the backward bit for bit,
and the bf16 ``MultiheadAttention`` on the card against the CPU plain
path. They skip without a card: ``python -m pytest --noconftest -m gpu
tests/test_torch_port_flash_bf16.py``.
"""

import math

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch import kernels
from multimodal_sentiment_aanalysis_tpu_torch.kernels import attention
from multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model import init_parameters
from multimodal_sentiment_aanalysis_tpu_torch.models.layers import MultiheadAttention
from torch_flash_emulation import (
    ACCURACY_SHAPES,
    BF16,
    BF16_CASES,
    BF16_HEAD_DIMS,
    OWN_ROWS,
    acc_as_a,
    emulate_bwd_bf16,
    emulate_fwd_bf16,
    from_a_fragments,
    from_accumulators,
    rs_product,
    s_product,
    sub_tile,
    swizzle,
    tma_tile,
    to_accumulators,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ULP = 2.0 ** -7  # one bf16 ulp, relative: the largest gap between two bf16 values over the smaller
# against fp64 (chip_smoke.py's FLASH_BF16_FP64_REL): O of max |O|, LSE of
# max |LSE|, dQ, dK and dV of their scale (attention.flash_bwd_magnitudes)
FP64_REL = {"O": 1e-2, "LSE": 1e-5, "dQ": 1e-2, "dK": 1e-2, "dV": 1e-2}
JAX_FWD_REL, JAX_LSE_RTOL, JAX_BWD_REL, JAX_MHA_GRAD_REL, FLAX_MHA_REL = 1e-2, 1e-4, 5e-3, 1e-2, 3e-2
# the kernels against their plain versions on the card: a bf16 output within
# one ulp plus this share of its scale (max |O|; flash_bwd_magnitudes), LSE
# within CARD_LSE_ATOL
CARD_REL, CARD_LSE_ATOL = 2e-3, 1e-4


def _rand(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(BF16)


def _qkv(seed, bh, tq, tk, d):
    """Seeded bf16 ``q`` (scaled in bf16, as ``flash_mha`` scales it), ``k``, ``v``."""
    rng = np.random.default_rng(seed)
    return attention.scale_q(_rand(rng, bh, tq, d)), _rand(rng, bh, tk, d), _rand(rng, bh, tk, d)


def _bwd_args(q, k, v, seed=5):
    """The backward's inputs: a seeded bf16 dO, the plain forward's O's LSE,
    and delta = rowsum(dO * O) as ``_FlashAttention`` forms it
    (``attention.flash_delta``: a bf16 row sum, as fp32)."""
    do = _rand(np.random.default_rng(seed), *q.shape)
    o, lse = attention.flash_fwd_plain(q, k, v)
    return q, k, v, do, lse, attention.flash_delta(do, o)


def _jnp(t: torch.Tensor):
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).double()


def _rel(got, ref, scale=None) -> float:
    """max |got - ref| over ``scale`` (max |ref| where None)."""
    ref = ref.double()
    scale = ref.abs().max() if scale is None else scale
    return ((got.double() - ref).abs().max() / scale).item()


def _within_ulp(got, ref, atol) -> bool:
    """|got - ref| <= one bf16 ulp of |ref| plus ``atol``, everywhere."""
    ref = ref.double()
    return bool(((got.double() - ref).abs() <= ULP * ref.abs() + atol).all())


# --------------------------------------------------------------------------
# CPU: the bf16 plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tq,tk", [(128, 128), (73, 73), (200, 100)])
def test_bf16_fwd_plain_matches_pallas(tq, tk):
    from multimodal_sentiment_aanalysis_tpu.kernels import attention as ja

    q, k, v = _qkv(0, 8, tq, tk, 32)
    o_ref, lse_ref = ja._flash_fwd(_jnp(q), _jnp(k), _jnp(v), 64, 64)
    o, lse = attention.flash_fwd(q, k, v)
    assert o.dtype == BF16 and lse.dtype == torch.float32 and str(o_ref.dtype) == "bfloat16"
    assert _rel(o, _np(o_ref)) <= JAX_FWD_REL
    lse_ref = _np(lse_ref)[:, :tq, 0]
    assert ((lse.double() - lse_ref).abs() / lse_ref.abs()).max() <= JAX_LSE_RTOL


def test_bf16_bwd_plain_matches_pallas():
    from multimodal_sentiment_aanalysis_tpu.kernels import attention as ja

    q, k, v = _qkv(1, 2, 96, 80, 16)
    args = _bwd_args(q, k, v, seed=2)
    o_ref, lse_ref = ja._flash_fwd(_jnp(q), _jnp(k), _jnp(v), 32, 32)
    want = ja._flash_bwd(_jnp(q), _jnp(k), _jnp(v), o_ref, lse_ref, _jnp(args[3]), 32, 32)
    got = [attention.flash_bwd_dq(*args), *attention.flash_bwd_dkv(*args)]
    scales = attention.flash_bwd_magnitudes(*(a.double() for a in args))
    for g, w, scale in zip(got, want, scales):
        assert g.dtype == BF16 and str(w.dtype) == "bfloat16"
        assert _rel(g, _np(w), scale) <= JAX_BWD_REL


@pytest.mark.parametrize("tq,tk,dh", [(40, 24, 8), (73, 73, 32), (33, 65, 48), (9, 130, 32)])
def test_bf16_flash_mha_and_gradients_match_jax(tq, tk, dh):
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels.attention import flash_mha as jax_flash

    rng = np.random.default_rng(tq + tk + dh)
    q, k, v = _rand(rng, 1, 2, tq, dh), _rand(rng, 1, 2, tk, dh), _rand(rng, 1, 2, tk, dh)

    def loss(*a):
        out = jax_flash(*a, block_q=32, block_k=32, force=True)
        return (out.astype(jnp.float32) ** 2).sum(), out

    (_, want), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(_jnp, (q, k, v)))
    tq_, tk_, tv_ = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention.flash_mha(tq_, tk_, tv_, force=True)
    assert out.dtype == BF16 and out.shape == (1, 2, tq, dh)
    (out.float() ** 2).sum().backward()
    assert _rel(out, _np(want)) <= JAX_FWD_REL
    for got, ref in zip((tq_.grad, tk_.grad, tv_.grad), want_g):
        assert got.dtype == BF16 and got.shape == ref.shape
        assert _rel(got, _np(ref)) <= JAX_MHA_GRAD_REL


@pytest.mark.parametrize("tq,tk", [(20, 20), (20, 12)])
def test_bf16_multihead_attention_matches_flax(tq, tk):
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.models.layers import (
        MultiheadAttention as FlaxMHA,
    )

    e, heads, b = 32, 4, 3
    rng = np.random.default_rng(6)
    xq = _rand(rng, b, tq, e)
    xk = _rand(rng, b, tk, e)
    flax_mha = FlaxMHA(e, heads)
    params = flax_mha.init(jax.random.key(0), _jnp(xq), _jnp(xk), _jnp(xk))["params"]
    params = {n: np.asarray(p, np.float32) + rng.normal(size=p.shape).astype(np.float32) * 0.1
              for n, p in params.items()}  # nonzero biases
    flax_bf16 = {n: jnp.asarray(p).astype(jnp.bfloat16) for n, p in params.items()}
    want = flax_mha.apply({"params": flax_bf16}, _jnp(xq), _jnp(xk), _jnp(xk))
    assert str(want.dtype) == "bfloat16"

    port = MultiheadAttention(e, heads)
    port.load_state_dict({"in_proj_weight": torch.from_numpy(params["in_proj_weight"]),
                          "in_proj_bias": torch.from_numpy(params["in_proj_bias"]),
                          "out_proj.weight": torch.from_numpy(params["out_proj_weight"]),
                          "out_proj.bias": torch.from_numpy(params["out_proj_bias"])})
    port.to(BF16)
    kernels.reset_launch_counts()
    xq_in = xq.clone().requires_grad_()
    got = port(xq_in, xk, xk)
    got.float().sum().backward()
    assert got.dtype == BF16 and _rel(got.detach(), _np(want)) <= FLAX_MHA_REL
    assert xq_in.grad.dtype == BF16 and port.in_proj_weight.grad.dtype == BF16
    assert all(n == 0 for n in kernels.launch_counts().values())


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    """The bit patterns of a tensor of bf16 values (held in any dtype)."""
    as_bf16 = t.to(BF16)
    assert torch.equal(as_bf16.double(), t.double())  # exactly bf16
    return as_bf16.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("shape", [(64, 585, 32), (2, 96, 16), (3, 9, 128)])
def test_bf16_delta_matches_jax_bitwise(shape):
    """``flash_delta`` forms delta as JAX's ``_flash_bwd`` does for bf16 dO
    and O: ``(do * o).sum(-1)`` in bf16, bit for bit (handed to the kernels
    as fp32); an fp32 sum of the same products differs from it."""
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(shape))
    do, o = _rand(rng, *shape), _rand(rng, *shape)
    want = np.asarray((_jnp(do) * _jnp(o)).sum(axis=-1)).view(np.uint16)
    got = attention.flash_delta(do, o)
    assert got.dtype == torch.float32 and got.shape == shape[:-1]
    np.testing.assert_array_equal(_bf16_bits(got), want)
    fp32 = (do.float() * o.float()).sum(-1)
    assert (fp32.to(BF16).view(torch.int16).numpy().view(np.uint16) != want).any()
    assert jnp.bfloat16 is not None


def test_bf16_function_hands_the_kernels_jax_delta(monkeypatch):
    """The bf16 ``_FlashAttention`` backward hands both kernels JAX's delta
    (``(do * o).sum(-1)`` at bf16, bit for bit) for its O and the incoming
    dO."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(12, 4, 70, 50, 32)
    do = _rand(rng, *q.shape)
    seen = []
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(attention, name)

        def spy(*a, real=real):
            seen.append(a[5])
            return real(*a)

        monkeypatch.setattr(attention, name, spy)
    qi = q.clone().requires_grad_()
    o, _ = attention._FlashAttention.apply(qi, k, v, 64, 64)
    o.backward(do)
    want = np.asarray((_jnp(do) * _jnp(o.detach())).sum(axis=-1)).view(np.uint16)
    assert len(seen) == 2
    for delta in seen:
        assert delta.dtype == torch.float32
        np.testing.assert_array_equal(_bf16_bits(delta), want)


def test_bf16_scale_matches_jax_bitwise():
    """``scale_q`` at Dh = 32 equals JAX's ``q * scale`` on a bf16 array
    bit for bit (JAX rounds the scale to bf16 first); scaling after an
    upcast to fp32, as the fp32 path does, differs from it."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    q = _rand(rng, 4, 8, 200, 32)
    want = np.asarray(_jnp(q) * (1.0 / math.sqrt(32))).view(np.uint16)
    got = attention.scale_q(q)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    upcast = (q.float() * (1.0 / math.sqrt(32))).to(BF16)
    assert (upcast.view(torch.int16).numpy().view(np.uint16) != want).any()
    assert str((_jnp(q) * 0.5).dtype) == "bfloat16" and jnp.bfloat16 is not None


def test_flash_mha_bf16_scales_q_in_bf16():
    """``flash_mha`` hands the bf16 Function ``scale_q(q)``: its output is
    the plain forward of the scaled, flattened operands."""
    q, k, v = (_rand(np.random.default_rng(8), 1, 2, 30, 32) for _ in range(3))
    got = attention.flash_mha(q, k, v, force=True)
    want, _ = attention.flash_fwd_plain(attention.scale_q(q)[0], k[0], v[0])
    assert torch.equal(got[0], want)


# --------------------------------------------------------------------------
# CPU: the plain versions against the emulation of the kernels' arithmetic
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tq,tk,d", BF16_CASES)
def test_bf16_plain_matches_emulation(tq, tk, d):
    q, k, v = _qkv(tq * 1000 + tk, 2, tq, tk, d)
    o, lse = attention.flash_fwd_plain(q, k, v)
    o_emu, lse_emu = emulate_fwd_bf16(q, k, v)
    assert o.dtype == o_emu.dtype == BF16 and o.shape == (2, tq, d)
    assert _within_ulp(o, o_emu, 2e-3 * o_emu.double().abs().max())
    assert ((lse.double() - lse_emu.double()).abs() / lse_emu.double().abs().clamp_min(1)).max() <= 1e-6
    args = _bwd_args(q, k, v)
    got = [attention.flash_bwd_dq_plain(*args), *attention.flash_bwd_dkv_plain(*args)]
    scales = attention.flash_bwd_magnitudes(*(a.double() for a in args))
    for g, e, scale in zip(got, emulate_bwd_bf16(*args), scales):
        assert g.dtype == e.dtype == BF16
        assert _within_ulp(g, e, 1e-3 * scale)


@pytest.mark.parametrize("shape", sorted(ACCURACY_SHAPES))
def test_bf16_emulation_meets_the_fp64_bars(shape):
    """At the attention phase's projections and at 200 queries over 100
    keys, in bf16, the emulated kernels meet chip_smoke.py's bf16 bars
    against the fp64 plain versions on the same inputs."""
    q, k, v = (t.to(BF16) for t in ACCURACY_SHAPES[shape]())
    o, lse = emulate_fwd_bf16(q, k, v)
    o64, lse64 = attention.flash_fwd_plain(q.double(), k.double(), v.double())
    assert _rel(o, o64) <= FP64_REL["O"] and _rel(lse, lse64) <= FP64_REL["LSE"]
    args = _bwd_args(q, k, v)
    args64 = [a.double() for a in args]
    want = [attention.flash_bwd_dq_plain(*args64), *attention.flash_bwd_dkv_plain(*args64)]
    for name, g, w, scale in zip(("dQ", "dK", "dV"), emulate_bwd_bf16(*args), want,
                                 attention.flash_bwd_magnitudes(*args64)):
        assert _rel(g, w, scale) <= FP64_REL[name]


@pytest.mark.parametrize("shared_own", [False, True])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_bf16_fragment_indexing_gives_the_products(kernel, shared_own):
    """One consumer warpgroup's two products as the Hopper kernels index
    them, at D = 32 (two k16 steps), for both warpgroups (own rows 0-63 and
    64-127 of the 128-row own tile): the first product from the own rows as
    register A fragments or (``shared_own``, as at D = 128) read K-major from
    the swizzled tile, against a streamed sub-tile read K-major; then its
    accumulator packed as the A fragments of the second, against a streamed
    tile read MN-major. The forward (``csrc/flash_attn_bf16.cu``): own Q,
    streamed K then V over a 64-key sub-tile, S = Q Kᵀ then P V. dQ
    (``csrc/flash_bwd_bf16.cu``): own Q, streamed K for both over 32 keys,
    S = Q Kᵀ then dS K. dK/dV: own K, streamed Q then dO over 32 queries,
    Sᵀ = K Qᵀ then Pᵀ dO."""
    rng = np.random.default_rng({"fwd": 3, "dq": 4, "dkv": 5}[kernel])
    d, n = 32, 64 if kernel == "fwd" else sub_tile(kernel == "dkv", 32)
    own, x, y = (rng.normal(size=(rows, d)) for rows in (OWN_ROWS, n, n))
    if kernel == "dq":
        y = x  # dQ's second product reads the same K rows
    own_s, xs, ys = tma_tile(own), tma_tile(x), tma_tile(y)
    for own_row in (0, 64):
        s = s_product(own_s, own_row, xs, n, 0, n, d, not shared_own)
        first = from_accumulators(s)
        np.testing.assert_allclose(first, own[own_row:own_row + 64] @ x.T, atol=1e-12)
        second = sum(rs_product(acc_as_a(s, kk), ys, n, 16 * kk, d) for kk in range(n // 16))
        np.testing.assert_allclose(second, first @ y, atol=1e-9)


@pytest.mark.parametrize("d", BF16_HEAD_DIMS)
def test_bf16_shared_memory_fits_every_tile(d):
    """bf16 tiles are half fp32's bytes: every pair of tiles fits the 227 KB
    a block may use at every head dim, the forward's 128-key tile at D = 128
    (which the fp32 form refuses) included; a head dim of 8 is not built.
    The plans (``FwdPlan``, ``BwdPlan``): 1024 bytes of alignment, the own
    tiles of OWN_ROWS rows whatever the own block (the forward's Q; the
    backward's two), a ring of 2-4 stages of two streamed tiles (as many as
    fit 64 KiB; the forward's K and V), dK/dV's columns (fp32 LSE and delta
    a stage) or dQ's own rows' LSE and delta, 8 bytes an mbarrier (two for
    the own tiles, two a stage); the ring's stages never fewer than two, so
    that the producer loads one while the consumers read another."""
    for bq in attention.TILES:
        for bk in attention.TILES:
            for kernel in ("fwd", "dq", "dkv"):
                assert attention.plan_smem(kernel, d, bq, bk, BF16) <= 227 * 1024
    for tile in attention.TILES:
        stage = 2 * tile * 2 * d
        stages = min(4, max(2, 65536 // stage))
        # the forward (FwdPlan): one own tile (Q), no columns
        assert {attention.fwd_smem(d, own, tile, BF16) for own in attention.TILES} == {
            1024 + OWN_ROWS * 2 * d + stages * stage + 8 * (2 + 2 * stages)}
        base = 1024 + 2 * OWN_ROWS * 2 * d + stages * stage + 8 * (2 + 2 * stages)
        assert {attention.dq_smem(d, own, tile, BF16) for own in attention.TILES} == {
            base + 2 * 4 * OWN_ROWS}
        assert {attention.dkv_smem(d, tile, own, BF16) for own in attention.TILES} == {
            base + stages * 2 * 4 * tile}
    with pytest.raises(ValueError, match="head dim"):
        attention.plan_smem("fwd", 8, 64, 64, BF16)
    with pytest.raises(ValueError, match="shared memory"):
        attention.plan_smem("fwd", 128, 64, 128)


@pytest.mark.parametrize("span", [32, 64, 128])
def test_tma_swizzle_permutes_chunks_within_each_period(span):
    """The swizzle model moves 16-byte chunks only, within each 8-row period
    (256 / 512 / 1024 bytes), and is its own inverse, as an XOR of address
    bits is."""
    period = 8 * span
    for byte in range(0, 4 * period, 2):
        moved = swizzle(byte, span)
        assert moved // period == byte // period and moved % 16 == byte % 16
        assert swizzle(moved, span) == byte
    rows = np.arange(8 * (span // 2), dtype=np.float64).reshape(8, span // 2)
    assert sorted(tma_tile(rows)) == sorted(rows.ravel())


@pytest.mark.parametrize("n", [16, 32, 64])
def test_wgmma_accumulator_layout_feeds_the_next_product(n):
    """An m64nNk16 accumulator's registers 8kk .. 8kk + 7, paired
    (``acc_as_a``), are exactly the register A fragment of the next
    product's k16 step kk: columns 16kk .. 16kk + 15 of the accumulated
    matrix."""
    c = np.random.default_rng(n).normal(size=(64, n))
    regs = to_accumulators(c)
    np.testing.assert_array_equal(from_accumulators(regs), c)
    for kk in range(n // 16):
        np.testing.assert_array_equal(from_a_fragments(acc_as_a(regs, kk)),
                                      c[:, 16 * kk:16 * kk + 16])


@pytest.mark.parametrize("tile", attention.TILES)
@pytest.mark.parametrize("d", BF16_HEAD_DIMS)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_bf16_bwd_index_maps_give_the_products(kernel, d, tile):
    """``csrc/flash_bwd_bf16.cu``'s address arithmetic, written out in numpy
    over TMA's swizzled tiles, at every head dim and streamed tile, for both
    consumer warpgroups (own rows 0-63 and 64-127) over every sub-tile of a
    stage: S and dP (dK/dV: their transposes) from the warpgroup's own rows
    (register fragments up to D = 64, the K-major own tile at D = 128)
    against the streamed tile K-major, then the accumulators fed as A
    fragments into dQ += dS K (dK/dV: dV += Pᵀ dO and dK += dSᵀ Q) against
    the streamed tile MN-major. The S and dP accumulators stand in for P and
    dS (the arithmetic between them is elementwise)."""
    rng = np.random.default_rng(d * 1000 + tile + (kernel == "dkv"))
    # dQ: own Q and dO, streamed K and V; dK/dV: own K and V, streamed Q and dO
    own_a, own_b = rng.normal(size=(OWN_ROWS, d)), rng.normal(size=(OWN_ROWS, d))
    x, y = rng.normal(size=(tile, d)), rng.normal(size=(tile, d))
    own_a_s, own_b_s, xs, ys = (tma_tile(t) for t in (own_a, own_b, x, y))
    n = sub_tile(kernel == "dkv", d)
    for own_row in (0, 64):
        a_rows, b_rows = own_a[own_row:own_row + 64], own_b[own_row:own_row + 64]
        acc1, acc2 = np.zeros((64, d)), np.zeros((64, d))
        for row in range(0, tile, n):
            s = s_product(own_a_s, own_row, xs, tile, row, n, d, d <= 64)
            p = s_product(own_b_s, own_row, ys, tile, row, n, d, d <= 64)
            np.testing.assert_allclose(from_accumulators(s), a_rows @ x[row:row + n].T,
                                       atol=1e-12)
            np.testing.assert_allclose(from_accumulators(p), b_rows @ y[row:row + n].T,
                                       atol=1e-12)
            for kk in range(n // 16):
                if kernel == "dq":
                    acc1 += rs_product(acc_as_a(p, kk), xs, tile, row + 16 * kk, d)
                else:
                    acc1 += rs_product(acc_as_a(s, kk), ys, tile, row + 16 * kk, d)
                    acc2 += rs_product(acc_as_a(p, kk), xs, tile, row + 16 * kk, d)
        if kernel == "dq":
            np.testing.assert_allclose(acc1, (b_rows @ y.T) @ x, atol=1e-9)
        else:
            np.testing.assert_allclose(acc1, (a_rows @ x.T) @ y, atol=1e-9)
            np.testing.assert_allclose(acc2, (b_rows @ y.T) @ x, atol=1e-9)


@pytest.mark.parametrize("tile", attention.TILES)
@pytest.mark.parametrize("d", BF16_HEAD_DIMS)
def test_bf16_fwd_index_maps_give_the_products(d, tile):
    """``csrc/flash_attn_bf16.cu``'s address arithmetic over TMA's swizzled
    tiles, at every head dim and key tile, for both consumer warpgroups
    (query rows 0-63 and 64-127 of the 128-row Q tile) over every sub-tile
    of a stage (``FwdPlan::kSub``: 64 keys, 32 for 32-key tiles): S = Q Kᵀ
    (Q as register fragments up to D = 64, the K-major Q tile at D = 128; K
    K-major), then the S accumulator packed as the A fragments of O += P V
    (V MN-major; two m64n64k16 at D = 128). S stands in for P (the softmax
    between them is elementwise)."""
    rng = np.random.default_rng(d * 100 + tile)
    q, k, v = (rng.normal(size=(rows, d)) for rows in (OWN_ROWS, tile, tile))
    qs, ks, vs = tma_tile(q), tma_tile(k), tma_tile(v)
    n = min(tile, 64)
    for own_row in (0, 64):
        rows = q[own_row:own_row + 64]
        acc = np.zeros((64, d))
        for row in range(0, tile, n):
            s = s_product(qs, own_row, ks, tile, row, n, d, d <= 64)
            np.testing.assert_allclose(from_accumulators(s), rows @ k[row:row + n].T, atol=1e-12)
            for kk in range(n // 16):
                acc += rs_product(acc_as_a(s, kk), vs, tile, row + 16 * kk, d)
        np.testing.assert_allclose(acc, (rows @ k.T) @ v, atol=1e-9)


def _fwd_walk(bh: int, tq: int, tk: int, tile: int, d: int, sms: int = 132):
    """The forward's persistent walk as ``flash_fwd_bf16_kernel`` runs it:
    for each CTA (``persistent_grid``: one an SM, at most one an item) the
    items it takes (``Work``: 128 query rows of one head, a head's blocks
    adjacent), the producer's ring slots and phases for each K / V tile,
    and the consumers' for each key sub-tile (``FwdConsumer::stage``, its
    ``mbar_wait`` parity)."""
    blocks, n = -(-tq // OWN_ROWS), -(-tk // tile)
    items, sub = bh * blocks, min(tile, 64)
    stages = min(4, max(2, 65536 // (2 * tile * 2 * d)))
    nsub, spt = -(-tk // sub), tile // sub
    walks = []
    for cta in range(min(items, sms)):
        taken, produced, consumed = [], [], []
        it = 0
        for item in range(cta, items, min(items, sms)):
            taken.append((item // blocks, (item % blocks) * OWN_ROWS))
            for t in range(n):
                produced.append((it + t, (it + t) % stages, ((it + t) // stages) & 1, t * tile))
            for i in range(nsub):
                tl = it + i // spt
                consumed.append((tl, tl % stages, (tl // stages) & 1,
                                 (tl - it) * tile + (i % spt) * sub))
            it += n
        walks.append((taken, produced, consumed))
    return walks


@pytest.mark.parametrize("bh,tq,tk", [(512, 585, 585), (3, 1, 1), (7, 129, 65), (200, 63, 130),
                                      (40, 256, 200)])
def test_bf16_fwd_persistent_walk_covers_every_block_once(bh, tq, tk):
    """Every (head, 128-row block) is one CTA's item exactly once, ragged
    lengths included, and its rows cover the head's queries; for every key
    tile the consumers wait on the slot and phase its producer filled it in
    and take its sub-tiles at its keys, and the item's sub-tiles reach the
    last key, at every key tile."""
    for tile in attention.TILES:
        seen = []
        for taken, produced, consumed in _fwd_walk(bh, tq, tk, tile, 32):
            seen += taken
            fills = {tl: (slot, phase, key0) for tl, slot, phase, key0 in produced}
            assert sorted(fills) == sorted({tl for tl, *_ in consumed})
            for tl, slot, phase, key in consumed:
                assert fills[tl][:2] == (slot, phase)
                assert fills[tl][2] <= key < fills[tl][2] + tile
            assert len(consumed) == len(taken) * -(-tk // min(tile, 64))
            assert max(key for *_, key in consumed) + min(tile, 64) >= tk
        assert sorted(seen) == sorted({(h, r) for h in range(bh) for r in range(0, tq, OWN_ROWS)})
        for h in range(bh):
            rows = set()
            for hh, r in seen:
                if hh == h:
                    rows |= set(range(r, min(r + OWN_ROWS, tq)))
            assert rows == set(range(tq))


@pytest.mark.parametrize("shape", sorted(ACCURACY_SHAPES))
def test_bf16_fwd_ftz_emulation_meets_the_fp64_bars(shape):
    """The Hopper forward's exps are ``ex2.approx.ftz`` (a subnormal result
    flushes to 0, in P and in the rescale factor): emulated over sub-tiles
    of 64 and of 32 keys (the 32-key tile), it still meets chip_smoke.py's
    bf16 bars (O 1e-2 of max |O|, LSE 1e-5) against the fp64 plain
    version."""
    q, k, v = (t.to(BF16) for t in ACCURACY_SHAPES[shape]())
    o64, lse64 = attention.flash_fwd_plain(q.double(), k.double(), v.double())
    for sub in (32, 64):
        o, lse = emulate_fwd_bf16(q, k, v, sub, ftz=True)
        assert _rel(o, o64) <= FP64_REL["O"] and _rel(lse, lse64) <= FP64_REL["LSE"]


# --------------------------------------------------------------------------
# card: the bf16 kernels against their plain versions and fp64
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# (BH, tq, tk, D, block_q, block_k): partial tiles in both lengths, every
# head dim, tq != tk both ways, other tiles, the 128-key forward tile at D =
# 128; and ragged lengths (1, 63, 65) in every pair, the head dims in turn
CARD_SHAPES = {
    "t9": (16, 9, 9, 32, 64, 64),
    "cross": (8, 200, 100, 32, 64, 64),
    "long_k": (4, 73, 130, 16, 32, 128),
    "d64": (3, 33, 65, 64, 64, 32),
    "d128_k128": (4, 70, 150, 128, 64, 128),
    "d128": (4, 70, 45, 128, 128, 64),
    **{f"ragged_{tq}_{tk}": (3, tq, tk, BF16_HEAD_DIMS[(a + b) % 4], 64, 64)
       for a, tq in enumerate((1, 63, 65)) for b, tk in enumerate((1, 63, 65))},
}
NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _on(device, *ts):
    return [t.to(device) for t in ts]


def _check_against_fp64(args, got_fwd, got_bwd):
    q, k, v, do, lse, delta = (a.double() for a in args)
    o64, lse64 = attention.flash_fwd_plain(q, k, v)
    assert _rel(got_fwd[0], o64) <= FP64_REL["O"]
    assert _rel(got_fwd[1], lse64) <= FP64_REL["LSE"]
    want = [attention.flash_bwd_dq_plain(q, k, v, do, lse, delta),
            *attention.flash_bwd_dkv_plain(q, k, v, do, lse, delta)]
    scales = attention.flash_bwd_magnitudes(q, k, v, do, lse, delta)
    for name, g, w, scale in zip(("dQ", "dK", "dV"), got_bwd, want, scales):
        assert _rel(g, w, scale) <= FP64_REL[name], name


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_bf16_flash_kernels_match_plain(cuda, shape):
    bh, tq, tk, d, bq, bk = CARD_SHAPES[shape]
    args = _on(cuda, *_bwd_args(*_qkv(7, bh, tq, tk, d)))
    q, k, v, do, lse, delta = args
    before = kernels.launch_counts()
    o, lse_k = attention.flash_fwd(q, k, v, bq, bk)
    dq = attention.flash_bwd_dq(*args, bq, bk)
    dk, dv = attention.flash_bwd_dkv(*args, bq, bk)
    after = kernels.launch_counts()
    moved = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    assert moved == {f"{n}_bf16": 1 for n in NAMES}
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == BF16 and lse_k.dtype == torch.float32
    o_ref, lse_ref = attention.flash_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    assert _within_ulp(o, o_ref, CARD_REL * o_ref.float().abs().max())
    assert (lse_k - lse_ref).abs().max() <= CARD_LSE_ATOL
    scales = attention.flash_bwd_magnitudes(*(a.double() for a in args))
    want = [attention.flash_bwd_dq_plain(*args), *attention.flash_bwd_dkv_plain(*args)]
    for g, w, scale in zip((dq, dk, dv), want, scales):
        assert _within_ulp(g, w, CARD_REL * scale)
    _check_against_fp64(args, (o, lse_k), (dq, dk, dv))


@pytest.mark.gpu
@pytest.mark.parametrize("d", BF16_HEAD_DIMS)
@pytest.mark.parametrize("bq,bk", [(bq, bk) for bq in attention.TILES for bk in attention.TILES])
def test_bf16_flash_kernels_match_fp64_every_tile(cuda, d, bq, bk):
    """The three bf16 kernels at ragged lengths (1, 63, 65 queries and keys)
    against the fp64 plain versions on the same inputs, at every head dim
    and tile pair."""
    for tq in (1, 63, 65):
        for tk in (1, 63, 65):
            args = _on(cuda, *_bwd_args(*_qkv(tq * 100 + tk, 3, tq, tk, d)))
            fwd = attention.flash_fwd(*args[:3], bq, bk)
            bwd = [attention.flash_bwd_dq(*args, bq, bk), *attention.flash_bwd_dkv(*args, bq, bk)]
            _check_against_fp64(args, fwd, bwd)


@pytest.mark.gpu
@pytest.mark.parametrize("d", BF16_HEAD_DIMS)
def test_bf16_flash_backward_is_deterministic(cuda, d):
    """Two runs of the bf16 backward kernels give the same bits: one CTA
    owns each output and sums it in one order, with no atomics."""
    args = _on(cuda, *_bwd_args(*_qkv(11, 6, 150, 130, d)))
    first = [attention.flash_bwd_dq(*args), *attention.flash_bwd_dkv(*args)]
    second = [attention.flash_bwd_dq(*args), *attention.flash_bwd_dkv(*args)]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("d", BF16_HEAD_DIMS)
def test_bf16_flash_forward_is_deterministic(cuda, d):
    """Two runs of the bf16 forward give the same bits, at every key tile:
    each output row sums its keys in one order, with no atomics."""
    q, k, v = _on(cuda, *_qkv(12, 6, 150, 130, d))
    for bk in attention.TILES:
        first, second = attention.flash_fwd(q, k, v, 64, bk), attention.flash_fwd(q, k, v, 64, bk)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_bf16_multihead_attention_on_card_matches_cpu(cuda):
    """T = 20 bf16 self-attention through the three bf16 kernels, none of
    the fp32 ones: output and gradients against the CPU bf16 plain path."""
    cpu = MultiheadAttention(64, 8)
    init_parameters(cpu, torch.Generator().manual_seed(8))
    cpu.to(BF16)
    card = MultiheadAttention(64, 8, device=cuda).to(BF16)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(6, 20, 64, generator=torch.Generator().manual_seed(9)).to(BF16)
    outs = []
    before = kernels.launch_counts()
    for m, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        xi = x.to(dev).requires_grad_()
        y = m(xi, xi, xi)
        (y.float() ** 2).sum().backward()
        outs.append((y.detach().cpu(), xi.grad.cpu(), m.in_proj_weight.grad.cpu()))
    after = kernels.launch_counts()
    moved = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    assert moved == {f"{n}_bf16": 1 for n in NAMES}
    for got, want in zip(*outs):
        assert got.dtype == BF16 and _rel(got, want) <= 2e-2


@pytest.mark.gpu
def test_bf16_flash_wrappers_raise_on_bad_input(cuda):
    q, k, v = _on(cuda, *_qkv(10, 2, 12, 12, 32))
    with pytest.raises(TypeError):  # operands of two dtypes
        attention.flash_fwd(q, k.float(), v)
    q8 = torch.zeros(2, 12, 8, device=cuda, dtype=BF16)
    with pytest.raises(ValueError, match="head dim"):  # flash_mha pads 8 to 16
        attention.flash_fwd(q8, q8, q8)
    with pytest.raises(ValueError, match="block_q"):
        attention.flash_fwd(q, k, v, 48, 64)

"""The arithmetic of the flash-attention backward on the tensor cores
(``csrc/flash_attn.cu::flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``,
rows 15 and 16), emulated on the CPU.

The kernels cannot run here, so this file writes their arithmetic out in
torch (``torch_flash_emulation``: TF32 splits with the high word rounded
and the low word truncated, three passes a product, the tensor cores' sums
in fp64 rounded to fp32). Both kernels take the streamed side in sub-tiles
of 32 rows, whatever the tile (``kSub``):

- dQ, per 32 keys: S = Q Kᵀ and dP = dO Vᵀ, P = ``exp2f(S log2 e - LSE
  log2 e)`` with LSE log2 e rounded first, dS = P (dP - delta) in fp32 (0
  for keys past Tk), then dS K with dS read in the key pairing (A column t
  takes key 2t of an 8-key step, column t + 4 key 2t + 1, K's rows in that
  order) into a fresh fragment, added to the fp32 accumulator;
- dK/dV, per 32 queries: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, Pᵀ and dSᵀ with each
  query's LSE and delta (0 for queries past Tq), then Pᵀ dO and dSᵀ Q with
  the query pairing into fresh fragments, added to the accumulators.

- The emulation against the JAX ``_flash_bwd`` (Pallas in interpret mode,
  as ``tests/test_torch_port_attention.py`` runs it) and against the fp64
  plain version on the same inputs, at the fp64 bar ``chip_smoke.py``
  holds the kernels to (max |err| <= 1e-5 of the largest fp64 entry of dQ,
  dK and dV), at Tq and Tk in {1, 63, 64, 65, 585} (every pair) and each
  head dim.
- A one-pass emulation misses that bar at both shapes where it was set
  (the ``MHA(256, 8)`` projections of the attention phase and 200 queries
  over 100 keys), which the fp32 plain version meets: so the bar tells
  3xTF32 from one pass and asks no more than fp32 gives.
- The kernels' fragment indexing, put through ``mma.m16n8k8``'s layouts:
  one warp's sub-tile of each kernel, its own rows' A fragments, the
  streamed tile's B fragments at the kernel's shared-memory offsets, the
  accumulator fed into the second product with the pairing.
- Each head dim's shared memory (``attention.dq_smem``, ``dkv_smem``) at
  the tile pairs the wrappers take, and their refusals before any launch.
"""

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.kernels import attention
from torch_flash_emulation import (
    ACCURACY_SHAPES,
    CASES,
    FP64_REL,
    HEAD_DIMS,
    c_fragment,
    exp_log2,
    mma_m16n8k8,
    pair_rows,
    product,
    random_qkv,
    rel,
)

SUB = 32  # kSub: streamed rows a sub-tile


def emulate_dq(q, k, v, do, lse, delta, passes: int = 3) -> torch.Tensor:
    """dQ of pre-scaled ``q (BH, Tq, D)``, fp32, in the kernel's order of
    operations."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    acc = torch.zeros(bh, tq, d)
    order = pair_rows(SUB)
    for j0 in range(0, tk, SUB):
        n = min(SUB, tk - j0)
        kj, vj = k[:, j0:j0 + n], v[:, j0:j0 + n]
        s = product(q, kj.transpose(1, 2), passes)
        dp = product(do, vj.transpose(1, 2), passes)
        # the sub-tile: keys past tk have P = 0 and zero-filled K rows
        ds, kt = torch.zeros(bh, tq, SUB), torch.zeros(bh, SUB, d)
        ds[..., :n] = exp_log2(s, lse[..., None]) * (dp - delta[..., None])
        kt[:, :n] = kj
        acc = acc + product(ds[..., order], kt[:, order], passes)
    return acc


def emulate_dkv(q, k, v, do, lse, delta, passes: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)``, fp32, in the kernel's order of operations."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    dk, dv = torch.zeros(bh, tk, d), torch.zeros(bh, tk, d)
    order = pair_rows(SUB)
    for i0 in range(0, tq, SUB):
        n = min(SUB, tq - i0)
        qi, doi = q[:, i0:i0 + n], do[:, i0:i0 + n]
        s = product(k, qi.transpose(1, 2), passes)
        dp = product(v, doi.transpose(1, 2), passes)
        p = exp_log2(s, lse[:, None, i0:i0 + n])
        # the sub-tile: queries past tq have P = 0 and zero-filled Q, dO rows
        pt, dst = torch.zeros(bh, tk, SUB), torch.zeros(bh, tk, SUB)
        qt, dot = torch.zeros(bh, SUB, d), torch.zeros(bh, SUB, d)
        pt[..., :n], dst[..., :n] = p, p * (dp - delta[:, None, i0:i0 + n])
        qt[:, :n], dot[:, :n] = qi, doi
        dv = dv + product(pt[..., order], dot[:, order], passes)
        dk = dk + product(dst[..., order], qt[:, order], passes)
    return dk, dv


def _inputs(q, k, v, seed: int = 5):
    """The backward's inputs: a seeded dO, the plain forward's LSE, and
    delta = rowsum(dO * O), all fp32."""
    do = torch.from_numpy(np.random.default_rng(seed).normal(size=q.shape).astype(np.float32))
    o, lse = attention.flash_fwd_plain(q, k, v)
    return q, k, v, do, lse, (do * o).sum(-1)


def _fp64(args) -> tuple[list[torch.Tensor], tuple[torch.Tensor, ...]]:
    """dQ, dK, dV of the fp64 plain versions on the same inputs, and the
    scales the bar is a share of (``attention.flash_bwd_magnitudes``)."""
    args = [a.double() for a in args]
    return ([attention.flash_bwd_dq_plain(*args), *attention.flash_bwd_dkv_plain(*args)],
            attention.flash_bwd_magnitudes(*args))


def _err(got, ref, scale) -> float:
    """max |got - ref| over the output's scale."""
    return ((got.double() - ref).abs().max() / scale).item()


def _emulated(args, passes: int = 3) -> list[torch.Tensor]:
    return [emulate_dq(*args, passes=passes), *emulate_dkv(*args, passes=passes)]


@pytest.mark.parametrize("tq,tk,d", CASES)
def test_emulated_backward_matches_jax_and_fp64(tq, tk, d):
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import attention as ja

    args = _inputs(*random_qkv(tq * 1000 + tk, 2, tq, tk, d))
    q, k, v, do = (jnp.asarray(t.numpy()) for t in args[:4])
    o_jax, lse_jax = ja._flash_fwd(q, k, v, 64, 64)
    want_jax = ja._flash_bwd(q, k, v, o_jax, lse_jax, do, 64, 64)
    want, scales = _fp64(args)
    for g, w64, wj, scale in zip(_emulated(args), want, want_jax, scales):
        assert g.shape == w64.shape == wj.shape
        assert _err(g, w64, scale) <= FP64_REL
        assert _err(g, torch.from_numpy(np.array(wj)).double(), scale) <= FP64_REL


@pytest.mark.parametrize("shape", sorted(ACCURACY_SHAPES))
def test_one_pass_misses_the_fp64_bar(shape):
    """Three passes and the fp32 plain version meet the bar on dQ, dK and
    dV; one pass misses it on each."""
    args = _inputs(*ACCURACY_SHAPES[shape]())
    want, scales = _fp64(args)
    plain = [attention.flash_bwd_dq_plain(*args), *attention.flash_bwd_dkv_plain(*args)]
    for three, one, fp32, ref, scale in zip(_emulated(args), _emulated(args, passes=1), plain,
                                            want, scales):
        assert _err(three, ref, scale) <= FP64_REL and _err(fp32, ref, scale) <= FP64_REL
        assert _err(one, ref, scale) > FP64_REL
        assert rel(three, ref) <= FP64_REL  # also within 1e-5 of the largest entry


def test_scale_covers_a_gradient_that_cancels():
    """At Tk = 1, P = 1 and dS = dP - delta = 0: dQ and dK are 0 up to
    rounding, so a share of their own largest entry would ask the fp32
    plain version for digits it cannot have; the scale keeps the terms'
    size, and the emulation meets the bar against it."""
    args = _inputs(*random_qkv(2, 2, 63, 1, 16))
    want, scales = _fp64(args)
    for got, ref, scale, fp32 in zip(_emulated(args), want, scales,
                                     [attention.flash_bwd_dq_plain(*args),
                                      *attention.flash_bwd_dkv_plain(*args)]):
        assert _err(got, ref, scale) <= FP64_REL and _err(fp32, ref, scale) <= FP64_REL
    assert rel(attention.flash_bwd_dq_plain(*args), want[0]) > FP64_REL  # dQ's own max: noise


def _warp_sub_tile(own_a, tile_x, tile_y, d: int):
    """One warp's sub-tile as the kernels index it: ``own_a`` (16, d) is the
    warp's own rows, ``tile_x`` and ``tile_y`` (32, d) the streamed rows of
    the first and second product, laid out in shared memory at kLd = d + 4
    floats a row. Returns (the first product's C, the second's), 16 x 32
    and 16 x d, from each lane's registers through ``mma_m16n8k8``."""
    kld = d + 4
    xs, ys = np.zeros(32 * kld), np.zeros(32 * kld)
    for r in range(32):
        xs[r * kld:r * kld + d], ys[r * kld:r * kld + d] = tile_x[r], tile_y[r]
    lanes = [divmod(lane, 4) for lane in range(32)]
    first = np.zeros((16, 32))
    for j in range(SUB // 8):  # S (or S^T): OwnFrags::frag and mma3(s[j], ..., at, 4)
        c = np.zeros((16, 8))
        for kd in range(d // 8):
            a = [[own_a[g, kd * 8 + t], own_a[g + 8, kd * 8 + t], own_a[g, kd * 8 + t + 4],
                  own_a[g + 8, kd * 8 + t + 4]] for g, t in lanes]
            at = [(j * 8 + g) * kld + kd * 8 + t for g, t in lanes]
            c += mma_m16n8k8(a, [[xs[p], xs[p + 4]] for p in at])
        first[:, j * 8:j * 8 + 8] = c
    second = np.zeros((16, d))
    for j in range(SUB // 8):  # acc_as_a(s[j]) and mma3(part[nd], ..., at + nd * 8, kLd)
        regs = c_fragment(first[:, j * 8:j * 8 + 8])
        a = [[r[0], r[2], r[1], r[3]] for r in regs]
        for nd in range(d // 8):
            at = [(j * 8 + 2 * t) * kld + g + nd * 8 for g, t in lanes]
            second[:, nd * 8:nd * 8 + 8] += mma_m16n8k8(a, [[ys[p], ys[p + kld]] for p in at])
    return first, second


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_fragment_indexing_gives_the_products(kernel):
    """dQ: own Q rows, streamed K for both products: S = Q Kᵀ, then dS K
    (dS fed from S's accumulator, keys paired). dK/dV: own K rows, streamed
    Q then dO: Sᵀ = K Qᵀ, then Pᵀ dO (queries paired). At D = 16 (two
    8-deep steps) over a 32-row sub-tile."""
    rng = np.random.default_rng(4)
    d = 16
    own, x, y = rng.normal(size=(16, d)), rng.normal(size=(32, d)), rng.normal(size=(32, d))
    if kernel == "dq":
        y = x  # dQ's second product reads the same K rows
    first, second = _warp_sub_tile(own, x, y, d)
    np.testing.assert_allclose(first, own @ x.T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(second, first @ y, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(pair_rows(8).numpy(), [0, 2, 4, 6, 1, 3, 5, 7])


# the tile pairs (block_q, block_k) of tests/test_torch_port_attention.py's
# CARD_SHAPES and the default
PAIRS = [(64, 64), (32, 128), (64, 32), (128, 64)]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bwd_shared_memory_fits(d):
    """dQ's and dK/dV's shared memory (which their launchers check byte for
    byte) fits the 227 KB a block may use at every pair of tiles and head
    dim, the card tests' pairs among them: at D = 128 the ring holds two
    32-row stages whatever the tile."""
    for block_q in attention.TILES:
        for block_k in attention.TILES:
            for kernel in ("dq", "dkv"):
                assert attention.plan_smem(kernel, d, block_q, block_k) <= 227 * 1024
    for block_q, block_k in PAIRS:
        assert attention.dq_smem(d, block_q, block_k) <= 227 * 1024


def test_bwd_shared_memory_counts():
    """The counts at the attention phase's shape (D = 32, 64 / 64): 3
    stages of K and V (dQ), of Q, dO, LSE and delta (dK/dV); and at D = 128,
    two 32-row stages and the 128 own rows of two operands."""
    row = 32 + 4
    assert attention.dq_smem(32, 64, 64) == 4 * 3 * 2 * 64 * row
    assert attention.dkv_smem(32, 64, 64) == 4 * 3 * (2 * 64 * row + 2 * 64)
    row = 128 + 4
    assert attention.dq_smem(128, 128, 128) == 4 * (2 * 2 * 32 * row + 2 * 128 * row)
    assert attention.dkv_smem(128, 128, 128) == 4 * (2 * (2 * 32 * row + 2 * 32) + 2 * 128 * row)
    assert attention.dq_smem(128, 128, 128) <= 227 * 1024 < attention.fwd_smem(128, 128, 128)


REFUSALS = {
    "dq_tile_96": ("dq", 32, 64, 96, "block_k 96: the dq kernel streams tiles"),
    "dkv_tile_96": ("dkv", 32, 96, 64, "block_q 96: the dkv kernel streams tiles"),
    "rows_256": ("dq", 32, 256, 64, "block_q 256: a multiple of 32 up to 128"),
    "rows_48": ("dkv", 32, 64, 48, "block_k 48: a multiple of 32 up to 128"),
    "head_dim_24": ("dq", 24, 64, 64, "head dim 24"),
    "fwd_d128_128": ("fwd", 128, 64, 128, "bytes of shared memory"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_bwd_plan_refusals(case):
    """A head dim or tile the kernels do not take, or a plan that does not
    fit, raises before any launch; 96 own rows (6 warps) are taken."""
    kernel, d, block_q, block_k, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        attention.plan_smem(kernel, d, block_q, block_k)
    assert attention.plan_smem("dq", 32, 96, 64) == attention.dq_smem(32, 96, 64)
    assert attention.plan_smem("dkv", 32, 64, 96) == attention.dkv_smem(32, 64, 96)

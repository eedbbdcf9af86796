"""The arithmetic of the flash-attention forward on the tensor cores
(``csrc/flash_attn.cu::flash_fwd_kernel``, row 14), emulated on the CPU.

The kernel cannot run here, so this file writes its arithmetic out in
torch: 64-key tiles; S = Q Kᵀ from Q and K split into TF32 high and low
words, three products a step (hi·hi + hi·lo + lo·hi) summed in fp32; the
online softmax in fp32 (running max, rescale by exp(m_old - m_new) once a
tile, both exponentials as ``exp2f`` of ``x log2 e``); P = exp(S - m)
split as Q and K are and multiplied by the split V with the kernel's key
pairing (A column t takes key 2t of an 8-key step, column t + 4 key 2t +
1, and V's rows are read in that order); each tile's P V added to the fp32
accumulator as ``acc = alpha acc + P V``; O = acc / l, LSE = m + log l.
The high word is rounded to TF32 (to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` rounds), the low word ``v - hi`` truncated to TF32,
as the tensor cores read an operand's upper 19 bits. The tensor cores' own
sums are taken in fp64 here and rounded to fp32.

- The emulation against the JAX ``_flash_fwd`` (Pallas in interpret mode,
  as ``tests/test_torch_port_attention.py`` runs it) and against fp64, at
  the fp64 bar ``chip_smoke.py`` holds the kernel to: max |O - O64| <=
  1e-5 max |O64| and max |LSE - LSE64| <= 1e-5 max |LSE64|, at Tq and Tk
  in {1, 63, 64, 65, 585} (every pair) and each head dim.
- A one-pass emulation (Q, K, P and V rounded to TF32 once, one product a
  step) misses that bar at both shapes where it was set: the ``MHA(256,
  8)`` projections of the attention phase (16 heads, T = 585) and random
  q, k, v at 200 queries over 100 keys. So the bar tells 3xTF32 from one
  pass.
- The key pairing: the A and B fragments the kernel builds from S's
  accumulator fragment and V's rows, put through ``mma.m16n8k8``'s layout,
  give P V.
"""

import math

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.kernels import attention
from multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model import init_parameters
from multimodal_sentiment_aanalysis_tpu_torch.models.layers import MultiheadAttention

FP64_REL = 1e-5  # chip_smoke.py's FLASH_FP64_REL
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)  # kLog2e
KEY_TILE = 64    # the default block_k: keys a tile
LENGTHS = (1, 63, 64, 65, 585)
HEAD_DIMS = attention.HEAD_DIMS


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32: 10 mantissa bits, to nearest, ties away."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32_trunc``: hi rounded, lo = x - hi (exact) truncated."""
    hi = _tf32(x)
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def _exp(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``exp2f(fmaf(x, log2 e, -m log2 e))`` in fp32: the product exact, one
    rounding of the exponent (m log2 e rounded first, as the kernel keeps
    it)."""
    ml = (m * LOG2E).double()
    return torch.exp2((x.double() * LOG2E.double() - ml).float())


def _product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` of fp32 operands as the kernel's mma.sync takes it: three
    TF32 passes (the small terms first), or one; summed in fp64, stored in
    fp32."""
    if passes == 1:
        return (_tf32(a).double() @ _tf32(b).double()).float()
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def _pair_keys(n: int) -> torch.Tensor:
    """The order in which the P V product reads a tile's ``n`` keys (n a
    multiple of 8): A column c of each 8-key step takes key 2c (c < 4) or
    2(c - 4) + 1."""
    step = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    return torch.cat([8 * j + step for j in range(n // 8)])


def emulate_fwd(q, k, v, passes: int = 3, key_tile: int = KEY_TILE):
    """``(O, LSE)`` of pre-scaled ``q (BH, Tq, D)`` and ``k, v (BH, Tk, D)``,
    fp32, in the kernel's order of operations."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    m = torch.full((bh, tq), -math.inf)
    l = torch.zeros(bh, tq)
    acc = torch.zeros(bh, tq, d)
    order = _pair_keys(key_tile)
    for j0 in range(0, tk, key_tile):
        n = min(key_tile, tk - j0)
        s = _product(q, k[:, j0:j0 + n].transpose(1, 2), passes)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)  # 0 on the first tile (m = -inf)
        p = _exp(s, m_new[..., None])
        m, l = m_new, l * alpha + p.sum(-1)
        # the kernel's tile: keys past tk are p = 0 over zero-filled V rows
        pt = torch.zeros(bh, tq, key_tile)
        vt = torch.zeros(bh, key_tile, d)
        pt[..., :n], vt[:, :n] = p, v[:, j0:j0 + n]
        pv = _product(pt[..., order], vt[:, order], passes)
        acc = (acc.double() * alpha.double()[..., None] + pv.double()).float()  # fmaf
    return acc / l[..., None], m + torch.log(l)


def _fp64(q, k, v):
    return attention.flash_fwd_plain(q.double(), k.double(), v.double())


def _rel(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def _random(seed, bh, tq, tk, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, tq, d)) / math.sqrt(d)
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (q, rng.normal(size=(bh, tk, d)), rng.normal(size=(bh, tk, d))))


# every (Tq, Tk) pair, the head dims in a Latin square: each head dim meets
# each Tq and each Tk once
CASES = [(tq, tk, HEAD_DIMS[(a + b) % len(HEAD_DIMS)])
         for a, tq in enumerate(LENGTHS) for b, tk in enumerate(LENGTHS)]


@pytest.mark.parametrize("tq,tk,d", CASES)
def test_emulated_forward_matches_jax_and_fp64(tq, tk, d):
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import attention as ja

    q, k, v = _random(tq * 1000 + tk, 2, tq, tk, d)
    o, lse = emulate_fwd(q, k, v)
    o64, lse64 = _fp64(q, k, v)
    o_jax, lse_jax = ja._flash_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), 64, 64)
    o_jax = torch.from_numpy(np.array(o_jax)).double()
    lse_jax = torch.from_numpy(np.array(lse_jax)[:, :tq, 0]).double()
    assert o.shape == (2, tq, d) and lse.shape == (2, tq)
    for got, ref in ((o, o64), (lse, lse64), (o, o_jax), (lse, lse_jax)):
        assert _rel(got, ref) <= FP64_REL


def _mha_projections():
    """q (pre-scaled), k, v of ``MultiheadAttention(256, 8)`` over a seeded
    (2, 585, 256) input: 16 heads of the attention phase's projections."""
    gen = torch.Generator().manual_seed(0)
    mha = MultiheadAttention(256, 8)
    init_parameters(mha, gen)
    x = torch.randn(2, 585, 256, generator=gen)
    w, b = mha.in_proj_weight.chunk(3), mha.in_proj_bias.chunk(3)
    with torch.no_grad():
        q, k, v = (torch.nn.functional.linear(x, wi, bi).reshape(2, 585, 8, 32).transpose(1, 2)
                   .reshape(16, 585, 32).contiguous() for wi, bi in zip(w, b))
    return q / math.sqrt(32), k, v


ACCURACY_SHAPES = {
    "mha_projections": _mha_projections,
    "random_200_over_100": lambda: _random(1, 8, 200, 100, 32),
}


@pytest.mark.parametrize("shape", sorted(ACCURACY_SHAPES))
def test_one_pass_misses_the_fp64_bar(shape):
    """Three passes meet the bar on O and LSE; one pass misses it on O."""
    q, k, v = ACCURACY_SHAPES[shape]()
    o64, lse64 = _fp64(q, k, v)
    o3, lse3 = emulate_fwd(q, k, v, passes=3)
    o1, _ = emulate_fwd(q, k, v, passes=1)
    assert _rel(o3, o64) <= FP64_REL and _rel(lse3, lse64) <= FP64_REL
    assert _rel(o1, o64) > FP64_REL


def test_pv_key_pairing_gives_p_times_v():
    """One 16 x 8 x 8 step of P V through the fragments the kernel builds:
    lane (g, t) of S's C fragment holds P[g, 2t], P[g, 2t + 1], P[g + 8,
    2t], P[g + 8, 2t + 1]; the kernel passes them as A registers 0, 2, 1,
    3, and loads V's rows 2t and 2t + 1 as B registers 0 and 1."""
    rng = np.random.default_rng(3)
    p, vt = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    a, b = np.zeros((16, 8)), np.zeros((8, 8))  # the mma's A (16 x k) and B (k x n)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c = [p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1]]
        regs = [c[0], c[2], c[1], c[3]]  # a[0..3] in the kernel
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = regs  # A's layout
        for n in range(8):
            if n == g:
                b[t, n], b[t + 4, n] = vt[2 * t, n], vt[2 * t + 1, n]  # B's layout
    np.testing.assert_allclose(a @ b, p @ vt, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(_pair_keys(8).numpy(), [0, 2, 4, 6, 1, 3, 5, 7])


def test_emulation_with_other_key_tiles_agrees():
    """The forward's key tiles (32, 64, 128) change only the order of the
    sums: all three meet the fp64 bar on a shape with a partial last tile."""
    q, k, v = _random(4, 2, 70, 150, 16)
    o64, lse64 = _fp64(q, k, v)
    for tile in attention.FWD_KEY_TILES:
        o, lse = emulate_fwd(q, k, v, key_tile=tile)
        assert _rel(o, o64) <= FP64_REL and _rel(lse, lse64) <= FP64_REL


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fwd_shared_memory_fits(d):
    """The forward's shared memory (``attention.fwd_smem``, which the
    launcher checks byte for byte) fits the 227 KB a block may use at the
    default tiles and at every key tile but the 128-key tile at D = 128,
    which the wrapper refuses."""
    for block_q in (32, 64, 128):
        for block_k in attention.FWD_KEY_TILES:
            fits = attention.fwd_smem(d, block_q, block_k) <= 227 * 1024
            assert fits == (d < 128 or block_k < 128)

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
from torch_flash_emulation import (
    ACCURACY_SHAPES,
    CASES,
    FP64_REL,
    HEAD_DIMS,
    LOG2E,
    exp_log2,
    pair_rows,
    product,
    random_qkv,
    rel,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

KEY_TILE = 64    # the default block_k: keys a tile


def emulate_fwd(q, k, v, passes: int = 3, key_tile: int = KEY_TILE):
    """``(O, LSE)`` of pre-scaled ``q (BH, Tq, D)`` and ``k, v (BH, Tk, D)``,
    fp32, in the kernel's order of operations."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    m = torch.full((bh, tq), -math.inf)
    l = torch.zeros(bh, tq)
    acc = torch.zeros(bh, tq, d)
    order = pair_rows(key_tile)
    for j0 in range(0, tk, key_tile):
        n = min(key_tile, tk - j0)
        s = product(q, k[:, j0:j0 + n].transpose(1, 2), passes)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)  # 0 on the first tile (m = -inf)
        p = exp_log2(s, m_new[..., None])
        m, l = m_new, l * alpha + p.sum(-1)
        # the kernel's tile: keys past tk are p = 0 over zero-filled V rows
        pt = torch.zeros(bh, tq, key_tile)
        vt = torch.zeros(bh, key_tile, d)
        pt[..., :n], vt[:, :n] = p, v[:, j0:j0 + n]
        pv = product(pt[..., order], vt[:, order], passes)
        acc = (acc.double() * alpha.double()[..., None] + pv.double()).float()  # fmaf
    return acc / l[..., None], m + torch.log(l)


def _fp64(q, k, v):
    return attention.flash_fwd_plain(q.double(), k.double(), v.double())


@pytest.mark.parametrize("tq,tk,d", CASES)
def test_emulated_forward_matches_jax_and_fp64(tq, tk, d):
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import attention as ja

    q, k, v = random_qkv(tq * 1000 + tk, 2, tq, tk, d)
    o, lse = emulate_fwd(q, k, v)
    o64, lse64 = _fp64(q, k, v)
    o_jax, lse_jax = ja._flash_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), 64, 64)
    o_jax = torch.from_numpy(np.array(o_jax)).double()
    lse_jax = torch.from_numpy(np.array(lse_jax)[:, :tq, 0]).double()
    assert o.shape == (2, tq, d) and lse.shape == (2, tq)
    for got, ref in ((o, o64), (lse, lse64), (o, o_jax), (lse, lse_jax)):
        assert rel(got, ref) <= FP64_REL


@pytest.mark.parametrize("shape", sorted(ACCURACY_SHAPES))
def test_one_pass_misses_the_fp64_bar(shape):
    """Three passes meet the bar on O and LSE; one pass misses it on O."""
    q, k, v = ACCURACY_SHAPES[shape]()
    o64, lse64 = _fp64(q, k, v)
    o3, lse3 = emulate_fwd(q, k, v, passes=3)
    o1, _ = emulate_fwd(q, k, v, passes=1)
    assert rel(o3, o64) <= FP64_REL and rel(lse3, lse64) <= FP64_REL
    assert rel(o1, o64) > FP64_REL


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
    np.testing.assert_array_equal(pair_rows(8).numpy(), [0, 2, 4, 6, 1, 3, 5, 7])


def test_emulation_with_other_key_tiles_agrees():
    """The forward's key tiles (32, 64, 128) change only the order of the
    sums: all three meet the fp64 bar on a shape with a partial last tile."""
    q, k, v = random_qkv(4, 2, 70, 150, 16)
    o64, lse64 = _fp64(q, k, v)
    for tile in attention.TILES:
        o, lse = emulate_fwd(q, k, v, key_tile=tile)
        assert rel(o, o64) <= FP64_REL and rel(lse, lse64) <= FP64_REL


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fwd_shared_memory_fits(d):
    """The forward's shared memory (``attention.fwd_smem``, which the
    launcher checks byte for byte) fits the 227 KB a block may use at the
    default tiles and at every key tile but the 128-key tile at D = 128,
    which the wrapper refuses."""
    for block_q in (32, 64, 128):
        for block_k in attention.TILES:
            fits = attention.fwd_smem(d, block_q, block_k) <= 227 * 1024
            assert fits == (d < 128 or block_k < 128)

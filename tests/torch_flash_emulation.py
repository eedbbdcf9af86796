"""The tensor-core arithmetic of the flash-attention kernels
(``csrc/flash_attn.cu``), written out in torch for the CPU tests of rows
14-16 (``test_torch_port_flash_fwd_tc.py``, ``test_torch_port_flash_bwd_tc.py``).

An fp32 operand is split into TF32 words as ``split_tf32_trunc`` splits it:
the high word rounded to TF32 (to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` rounds), the low word ``v - hi`` truncated to TF32, as
the tensor cores read an operand's upper 19 bits. A product takes three
passes (hi·hi + hi·lo + lo·hi) or, to show what the bar rules out, one pass
on operands rounded to TF32 once. The tensor cores' own sums are taken in
fp64 here and rounded to fp32. Also the shapes the accuracy bars were set
at, and the m16n8k8 fragment layouts for the pairing tests.
"""

import math

import numpy as np
import torch

FP64_REL = 1e-5  # chip_smoke.py's FLASH_FP64_REL
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)  # kLog2e
LENGTHS = (1, 63, 64, 65, 585)
HEAD_DIMS = (8, 16, 32, 64, 128)  # attention.HEAD_DIMS

# every (Tq, Tk) pair, the head dims in a Latin square: each head dim meets
# each Tq and each Tk once
CASES = [(tq, tk, HEAD_DIMS[(a + b) % len(HEAD_DIMS)])
         for a, tq in enumerate(LENGTHS) for b, tk in enumerate(LENGTHS)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32: 10 mantissa bits, to nearest, ties away."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32_trunc``: hi rounded, lo = x - hi (exact) truncated."""
    hi = tf32(x)
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def exp_log2(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``exp2f(fmaf(x, log2 e, -m log2 e))`` in fp32: the product exact, one
    rounding of the exponent (m log2 e rounded first, as the kernels keep
    it)."""
    ml = (m * LOG2E).double()
    return torch.exp2((x.double() * LOG2E.double() - ml).float())


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` of fp32 operands as the kernels' mma.sync take it: three
    TF32 passes (the small terms first), or one; summed in fp64, stored in
    fp32."""
    if passes == 1:
        return (tf32(a).double() @ tf32(b).double()).float()
    (ah, al), (bh, bl) = split(a), split(b)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def pair_rows(n: int) -> torch.Tensor:
    """The order in which a product fed from an accumulator fragment reads
    ``n`` rows of its B operand (n a multiple of 8): A column c of each
    8-row step takes row 2c (c < 4) or 2(c - 4) + 1."""
    step = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    return torch.cat([8 * j + step for j in range(n // 8)])


def rel(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def random_qkv(seed, bh, tq, tk, d):
    """Seeded q (pre-scaled), k, v."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, tq, d)) / math.sqrt(d)
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (q, rng.normal(size=(bh, tk, d)), rng.normal(size=(bh, tk, d))))


def mha_projections():
    """q (pre-scaled), k, v of ``MultiheadAttention(256, 8)`` over a seeded
    (2, 585, 256) input: 16 heads of the attention phase's projections."""
    from multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model import init_parameters
    from multimodal_sentiment_aanalysis_tpu_torch.models.layers import MultiheadAttention

    gen = torch.Generator().manual_seed(0)
    mha = MultiheadAttention(256, 8)
    init_parameters(mha, gen)
    x = torch.randn(2, 585, 256, generator=gen)
    w, b = mha.in_proj_weight.chunk(3), mha.in_proj_bias.chunk(3)
    with torch.no_grad():
        q, k, v = (torch.nn.functional.linear(x, wi, bi).reshape(2, 585, 8, 32).transpose(1, 2)
                   .reshape(16, 585, 32).contiguous() for wi, bi in zip(w, b))
    return q / math.sqrt(32), k, v


# the shapes where the fp64 bar was set: the attention phase's projections
# and 200 queries over 100 keys
ACCURACY_SHAPES = {
    "mha_projections": mha_projections,
    "random_200_over_100": lambda: random_qkv(1, 8, 200, 100, 32),
}


def mma_m16n8k8(a_regs, b_regs) -> np.ndarray:
    """The 16 x 8 product one ``mma.sync.m16n8k8`` computes from each lane's
    registers (g = lane / 4, t = lane % 4): A a[0] at (g, t), a[1] (g + 8,
    t), a[2] (g, t + 4), a[3] (g + 8, t + 4); B b[0] at (k = t, n = g), b[1]
    (t + 4, g)."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_regs[lane]
        b[t, g], b[t + 4, g] = b_regs[lane]
    return a @ b


def c_fragment(c: np.ndarray) -> list:
    """Each lane's accumulator registers of a 16 x 8 C: (g, 2t), (g, 2t +
    1), (g + 8, 2t), (g + 8, 2t + 1)."""
    return [[c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1]]
            for g, t in (divmod(lane, 4) for lane in range(32))]

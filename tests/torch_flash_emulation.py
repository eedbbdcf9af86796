"""The tensor-core arithmetic of the flash-attention kernels
(``csrc/flash_attn.cu``), written out in torch for the CPU tests of rows
14-16 (``test_torch_port_flash_fwd_tc.py``, ``test_torch_port_flash_bwd_tc.py``),
and of their bf16 forms (``csrc/flash_attn_bf16.cu``,
``test_torch_port_flash_bf16.py``).

An fp32 operand is split into TF32 words as ``split_tf32_trunc`` splits it:
the high word rounded to TF32 (to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` rounds), the low word ``v - hi`` truncated to TF32, as
the tensor cores read an operand's upper 19 bits. A product takes three
passes (hi·hi + hi·lo + lo·hi) or, to show what the bar rules out, one pass
on operands rounded to TF32 once. The tensor cores' own sums are taken in
fp64 here and rounded to fp32. Also the shapes the accuracy bars were set
at, and the m16n8k8 fragment layouts for the pairing tests.

The bf16 forms' rounding points: bf16 operands, each product's terms exact
(a bf16 times a bf16 is exact in fp32) and summed in fp64 here, rounded to
fp32 as the tensor cores' fp32 accumulators hold them; P and dS rounded to
bf16 as the A operand of their products; O, dQ, dK and dV rounded to bf16.
Also, for the bf16 kernels on Hopper (``csrc/flash_attn_bf16.cu`` and
``csrc/flash_bwd_bf16.cu`` on ``csrc/sm90.cuh``), the 32/64/128-byte
swizzled tiles as TMA writes them and K-major and MN-major wgmma
descriptors read them, the wgmma.m64nNk16 accumulator and register-A
fragments, and the kernels' address arithmetic, for the index tests.
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


# --------------------------------------------------------------------------
# the bf16 forms (csrc/flash_attn_bf16.cu)
# --------------------------------------------------------------------------

BF16 = torch.bfloat16
BF16_HEAD_DIMS = (16, 32, 64, 128)  # attention.BF16_HEAD_DIMS
# the bf16 cases: CASES with head dim 8 taken at 16 (the wrapper pads 8 to 16)
BF16_CASES = [(tq, tk, max(d, 16)) for tq, tk, d in CASES]


def bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bf16 (to nearest even) and held in fp32."""
    return x.to(BF16).float()


def product_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one bf16 mma.sync pass takes it: operands rounded to
    bf16, the products exact, summed in fp64, stored in fp32."""
    return (bf16(a).double() @ bf16(b).double()).float()


def flush(x: torch.Tensor) -> torch.Tensor:
    """fp32 results of ``ex2.approx.ftz``: below 2^-126 (subnormal) to 0."""
    return torch.where(x.abs() < 2.0 ** -126, torch.zeros_like(x), x)


def emulate_fwd_bf16(q, k, v, key_tile: int = 64, ftz: bool = False):
    """``(O bf16, LSE fp32)`` of pre-scaled bf16 ``q (BH, Tq, D)`` and ``k,
    v (BH, Tk, D)`` in the bf16 forward's order of operations: per key tile
    (the Hopper forward's sub-tile of 64 keys, or 32) S from one bf16 pass,
    the online softmax in fp32, the accumulator scaled by exp(m_old - m_new)
    and then summed on the tensor cores with P V (P rounded to bf16). With
    ``ftz`` every exp (P and the rescale factor) flushes a subnormal result
    to 0, as ``ex2.approx.ftz`` does."""
    exp = flush if ftz else (lambda x: x)
    bh, tq, d = q.shape
    tk = k.shape[1]
    m = torch.full((bh, tq), -math.inf)
    l = torch.zeros(bh, tq)
    acc = torch.zeros(bh, tq, d)
    for j0 in range(0, tk, key_tile):
        kj, vj = k[:, j0:j0 + key_tile], v[:, j0:j0 + key_tile]
        s = product_bf16(q, kj.transpose(1, 2))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = exp(torch.exp2((m - m_new) * LOG2E))  # 0 on the first tile (m = -inf)
        p = exp(exp_log2(s, m_new[..., None]))
        m, l = m_new, l * alpha + p.sum(-1)
        acc = (acc * alpha[..., None]).double() + bf16(p).double() @ vj.double()
        acc = acc.float()
    return (acc / l[..., None]).to(BF16), m + torch.log(l)


def emulate_bwd_bf16(q, k, v, do, lse, delta) -> list[torch.Tensor]:
    """``[dQ, dK, dV]`` (bf16) of the bf16 backward kernels: S and dP from
    one bf16 pass, P = exp(S - LSE) and dS = P (dP - delta) in fp32, P and
    dS rounded to bf16 for dS K, Pᵀ dO and dSᵀ Q, each output summed on the
    tensor cores over all of T."""
    s = product_bf16(q, k.transpose(1, 2))
    p = exp_log2(s, lse[..., None])
    ds = p * (product_bf16(do, v.transpose(1, 2)) - delta[..., None])
    return [product_bf16(ds, k).to(BF16), product_bf16(ds.transpose(1, 2), q).to(BF16),
            product_bf16(p.transpose(1, 2), do).to(BF16)]


# --------------------------------------------------------------------------
# the bf16 kernels on Hopper (csrc/flash_attn_bf16.cu, csrc/flash_bwd_bf16.cu,
# csrc/sm90.cuh): the shared-memory layouts TMA writes and wgmma descriptors
# read, and the wgmma.m64nNk16 register fragments
# --------------------------------------------------------------------------

OWN_ROWS = 128  # kOwnRows: two consumer warpgroups of 64 rows


def span_of(d: int) -> int:
    """``span_of``: bytes of a tile row, the row's swizzle span (a box of 64
    columns at D = 128)."""
    return 2 * d if d < 64 else 128


def swizzle(byte, span: int):
    """Where byte ``byte`` of a tile of ``span``-byte rows lies under TMA's
    32/64/128-byte swizzle, from a base on the pattern's period: address
    bits 4.. XORed with bits 7.. (one bit at 32 bytes, two at 64, three at
    128)."""
    return byte ^ (((byte >> 7) & (span // 16 - 1)) << 4)


def tma_tile(rows: np.ndarray) -> np.ndarray:
    """Shared memory as ``load_tile`` fills it from a (R, D) bf16 tile (the
    values held exactly, one per 2-byte slot): each 64-column box (one at D
    <= 64) after the other, R rows of ``span_of(D)`` bytes each, swizzled."""
    r, d = rows.shape
    span = span_of(d)
    smem = np.full(r * d, np.nan)
    for row in range(r):
        for col in range(d):
            byte = (col // 64) * r * span + row * span + 2 * (col % 64)
            smem[swizzle(byte, span) // 2] = rows[row, col]
    return smem


def read_kmajor(smem: np.ndarray, start: int, sbo: int, span: int, mn: int) -> np.ndarray:
    """The (mn, 16) operand a K-major descriptor (start byte, stride byte
    offset, swizzle) names: row i, column k at start + (i // 8) sbo + (i %
    8) span + 2k, swizzled."""
    out = np.empty((mn, 16))
    for i in range(mn):
        for k in range(16):
            out[i, k] = smem[swizzle(start + (i // 8) * sbo + (i % 8) * span + 2 * k, span) // 2]
    return out


def read_mnmajor(smem: np.ndarray, start: int, sbo: int, span: int, n: int) -> np.ndarray:
    """The (16, n) operand an MN-major descriptor names (the transpose bit;
    n at most one swizzle span, so the leading byte offset is not read):
    row k, column j at start + (k // 8) sbo + (k % 8) span + 2j, swizzled."""
    assert 2 * n <= span
    out = np.empty((16, n))
    for k in range(16):
        for j in range(n):
            out[k, j] = smem[swizzle(start + (k // 8) * sbo + (k % 8) * span + 2 * j, span) // 2]
    return out


def acc_position(thread: int, reg: int) -> tuple[int, int]:
    """Row and column of accumulator register ``reg`` of ``thread`` (0-127)
    of a wgmma.m64nNk16: warp w, lane (g, t): row 16w + g + 8 ((reg % 4) //
    2), column 8 (reg // 4) + 2t + reg % 2."""
    w, lane = divmod(thread, 32)
    g, t = divmod(lane, 4)
    return 16 * w + g + 8 * ((reg % 4) // 2), 8 * (reg // 4) + 2 * t + reg % 2


def a_position(thread: int, reg: int, half: int) -> tuple[int, int]:
    """Row and column of element ``half`` (0 low, 1 high) of register ``reg``
    (0-3) of a register A fragment of a wgmma.m64nNk16 (64 x 16): rows 16w +
    g (reg 0, 2) and + 8 (1, 3), columns 2t + half (0, 1) and + 8 (2, 3)."""
    w, lane = divmod(thread, 32)
    g, t = divmod(lane, 4)
    return 16 * w + g + 8 * (reg % 2), 2 * t + half + 8 * (reg // 2)


def to_accumulators(c: np.ndarray) -> np.ndarray:
    """A (64, N) product as each thread's accumulator registers (128, N / 2)."""
    n = c.shape[1]
    return np.array([[c[acc_position(th, r)] for r in range(n // 2)] for th in range(128)])


def from_accumulators(regs: np.ndarray) -> np.ndarray:
    """The (64, N) matrix that the threads' accumulator registers hold."""
    out = np.full((64, 2 * regs.shape[1]), np.nan)
    for th in range(128):
        for r in range(regs.shape[1]):
            out[acc_position(th, r)] = regs[th, r]
    return out


def from_a_fragments(frags) -> np.ndarray:
    """The (64, 16) A operand that each thread's four register pairs
    (``frags[thread][reg] = (low, high)``) hold."""
    out = np.full((64, 16), np.nan)
    for th in range(128):
        for reg in range(4):
            for half in range(2):
                out[a_position(th, reg, half)] = frags[th][reg][half]
    return out


def acc_as_a(regs: np.ndarray, kk: int) -> list:
    """``acc_as_a``: accumulator registers 8kk .. 8kk + 7 of each thread as
    the A fragment of k16 step kk, a[e] = (c[8kk + 2e], c[8kk + 2e + 1])."""
    return [[(regs[th, 8 * kk + 2 * e], regs[th, 8 * kk + 2 * e + 1]) for e in range(4)]
            for th in range(128)]


def own_fragments(smem: np.ndarray, d: int, kk: int, own_row: int) -> list:
    """``own_fragments``: each thread of the warpgroup whose rows start at
    ``own_row`` (0 or 64), its A fragment of k16 step kk of the own tile
    (OWN_ROWS rows), read from the swizzled tile: rows r0 = own_row + 16 warp
    + g, r0 + 8, columns 16kk + 2t (+ 8), a 4-byte pair at the swizzle of row
    x span + 2 (col % 64), in box col / 64."""
    span = span_of(d)

    def pair(row, col):
        byte = swizzle(row * span + 2 * (col % 64), span)
        base = (col // 64) * OWN_ROWS * span
        return smem[(base + byte) // 2], smem[(base + byte) // 2 + 1]

    frags = []
    for th in range(128):
        w, lane = divmod(th, 32)
        g, t = divmod(lane, 4)
        r0, c = own_row + 16 * w + g, 16 * kk + 2 * t
        frags.append([pair(r0, c), pair(r0 + 8, c), pair(r0, c + 8), pair(r0 + 8, c + 8)])
    return frags


def s_product(own_smem, own_row: int, tile_smem, tile_rows: int, row: int, n: int, d: int,
              own_in_registers: bool) -> np.ndarray:
    """S (or dP) of a sub-tile as the warpgroup of own rows ``own_row`` ..
    own_row + 63 issues it, as its accumulator registers (128, n / 2): per
    k16 step kk, A the own rows (register fragments from ``own_fragments``,
    or the own tile K-major at own + box x OWN_ROWS x span + own_row x span +
    (kk % 4) 32), B the streamed tile K-major at tile + box x tile_rows x
    span + row x span + (kk % 4) 32, stride byte offset 8 span
    (``rs_product_k``, ``ss_product``)."""
    span = span_of(d)
    acc = np.zeros((64, n))
    for kk in range(d // 16):
        box, at = kk // 4, (kk % 4) * 32
        if own_in_registers:
            a = from_a_fragments(own_fragments(own_smem, d, kk, own_row))
        else:
            a = read_kmajor(own_smem, box * OWN_ROWS * span + own_row * span + at, 8 * span,
                            span, 64)
        b = read_kmajor(tile_smem, box * tile_rows * span + row * span + at, 8 * span, span, n)
        acc += a @ b.T
    return to_accumulators(acc)


def rs_product(frags, tile_smem, tile_rows: int, row: int, d: int) -> np.ndarray:
    """One accumulating product's k16 step as ``rs_product`` issues it: A
    the register fragments, B the streamed tile's rows row .. row + 15 read
    MN-major (tile + row x span, stride byte offset 8 span; at D = 128 one
    m64n64k16 per box, tile + box x tile_rows x 128): the (64, D) term."""
    span = span_of(d)
    a = from_a_fragments(frags)
    if d <= 64:
        return a @ read_mnmajor(tile_smem, row * span, 8 * span, span, d)
    return np.concatenate([a @ read_mnmajor(tile_smem, b * tile_rows * 128 + row * 128, 1024,
                                            128, 64) for b in range(2)], axis=1)


def sub_tile(dkv: bool, d: int) -> int:
    """``BwdPlan::kSub``: the streamed rows of one S / dP product, 32, or 16
    for dK/dV at D = 128."""
    return 16 if dkv and d == 128 else 32

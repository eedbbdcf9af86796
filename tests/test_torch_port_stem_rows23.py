"""Rows 2 and 3 of the kernel table: the EEG stem tail's forward
(``csrc/stem_tail.cu::stem_tail_fwd_kernel``) and the serving conv stem
(``csrc/conv_stem.cu::conv_stem_kernel``).

On the CPU:

- the port's numpy Philox4x32-10 (``conv_stem_train.philox4x32_plain``)
  against Random123's known-answer vectors, and the keep mask built on it
  (``keep_mask_plain``: element ``e`` of a model kept iff word ``e mod 4``
  at counter ``e div 4`` under the model's seed clears the threshold): its
  keep share within 5 sigma of 1 - p, distinct masks across models and
  seeds, and the seeded forward's code at pool 1 equal to it;
- the plain stem tail fed that mask against the JAX package's jnp stem
  stage fed the same mask, at pools 1, 2 and 4 and C = 4, 12 and 64 (C = 12
  and 4 leave the kernel's 4-channel groups whole, and C = 12 a partial
  block of groups; values 1e-5 absolute, gradients 1e-4 of the largest
  entry, as ``test_torch_port_train_kernels.py``);
- row 3's tiling and 3xTF32 arithmetic emulated in torch
  (:func:`conv_stem_emulated`): tap-major k-tiles of 16 input channels of
  one tap, each tile's three TF32 passes (hi.hi + hi.lo + lo.hi, both words
  rounded to TF32 as ``split_tf32`` rounds them) summed in fp64 and rounded
  to fp32 as the tensor cores sum a tile, the tiles summed in fp32, then
  ``fmaf(acc, scale, shift)``, GELU and the pool's max; against JAX
  ``fused_conv_bn_gelu_pool`` in interpret mode (1e-4) and against the fp64
  conv at 1e-5 of the largest entry (``chip_smoke.py``'s bar), a bar one
  TF32 pass misses; and the kernel's epilogue: the xor-shuffle fold of the
  pool's rows across the m16n8k8 accumulator lanes, and the position tiles'
  cover of the pooled rows.

The ``gpu``-marked tests hold each kernel against its plain version on the
card: row 2 in fp32 and bf16, p 0 and 0.4, S 1 and 3, with a ragged B and T
and C % 4 != 0, its keep mask bit for bit against :func:`keep_mask_plain`;
rows 2 and 12 on each channel shard of the two stem stages split 2 and 4
ways, against the unsharded kernel's columns and the plain versions;
row 3 at both serving stages and ragged shapes, against the plain version
(1e-4) and fp64 (1e-5 of the largest entry). They skip without a card and
import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_stem_rows23.py``.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem, conv_stem_train
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FP64_REL = 1e-5  # row 3 against fp64: chip_smoke.py's CONV_FP64_REL
BF16_ULP = 2.0 ** -7


def _stem_case(seed, s, b, t, c):
    """Seeded conv ``(S, B, T, C)`` (S = 0: ``(B, T, C)``), gamma and beta,
    and the batch statistics ``models/eeg.py`` computes."""
    rng = np.random.default_rng(seed)
    lead = (s,) if s else ()
    conv = torch.from_numpy(rng.normal(size=(*lead, b, t, c)).astype(np.float32))
    gamma = torch.from_numpy((rng.normal(size=(*lead, c)) * 0.3 + 1).astype(np.float32))
    beta = torch.from_numpy((rng.normal(size=(*lead, c)) * 0.1).astype(np.float32))
    axes = (-3, -2)
    mean = conv.mean(axes)
    var = (conv * conv).mean(axes) - mean * mean
    return conv, gamma, beta, mean, var


# --------------------------------------------------------------------------
# CPU: the Philox model and the keep mask
# --------------------------------------------------------------------------

# Random123's kat_vectors for philox4x32_10: counter, key, the four words
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("case", range(len(PHILOX_KAT)))
def test_philox_matches_random123_known_answers(case):
    counter, key, want = PHILOX_KAT[case]
    got = conv_stem_train.philox4x32_plain(np.array([counter], np.uint32), key)
    assert got.dtype == np.uint32 and tuple(int(v) for v in got[0]) == want


def test_keep_mask_is_four_words_per_counter():
    """Element e takes word e mod 4 at counter e div 4 under (seed low,
    seed high): the mask of a (1, 2, 3, 5) conv spelled out."""
    seed, p = (7 << 32) + 11, 0.4
    keep = conv_stem_train.keep_mask_plain(torch.tensor([seed]), (1, 2, 3, 5), p)
    n = 2 * 3 * 5
    counters = np.zeros((-(-n // 4), 4), np.uint32)
    counters[:, 0] = np.arange(counters.shape[0])
    words = conv_stem_train.philox4x32_plain(counters, (11, 7))
    want = [words[e // 4, e % 4] >= round(p * 2 ** 32) for e in range(n)]
    assert keep.shape == (1, 2, 3, 5) and keep.reshape(-1).tolist() == want


def test_keep_mask_share_and_streams():
    """p = 0.4 at stage 1's one-model shape: the keep share within 5 sigma
    of 0.6 for each model; the masks of two models, and of one model under
    two seeds, differ."""
    p, shape = 0.4, (64, 585, 64)
    seeds = torch.tensor([1, 2, 2 ** 40 + 1], dtype=torch.int64)
    keep = conv_stem_train.keep_mask_plain(seeds, (3, *shape), p)
    n = math.prod(shape)
    sigma = math.sqrt(p * (1 - p) / n)
    for s in range(3):
        assert abs(keep[s].double().mean().item() - (1 - p)) < 5 * sigma
    assert not torch.equal(keep[0], keep[1]) and not torch.equal(keep[0], keep[2])
    # one model's mask is its seed's alone: the same under S = 1
    assert torch.equal(conv_stem_train.keep_mask_plain(seeds[1:2], shape, p), keep[1])


def test_seeded_forward_takes_the_philox_mask_on_the_cpu():
    """``stem_tail_fwd_seeded`` at pool 1: the code is the keep bit of
    every element, and the output the plain version fed that mask."""
    p = 0.4
    conv, gamma, beta, mean, var = _stem_case(1, 3, 2, 9, 7)
    seeds = torch.tensor([5, 6, 7])
    out, code = conv_stem_train.stem_tail_fwd_seeded(conv, gamma, beta, mean, var, p, 1, seeds)
    keep = conv_stem_train.keep_mask_plain(seeds, conv.shape, p)
    assert torch.equal(code, keep.int())
    ref = conv_stem_train.fused_stage_train_plain(conv, gamma, beta, mean, var, 1, 1e-5, p, keep)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError):  # one seed per model
        conv_stem_train.stem_tail_fwd_seeded(conv, gamma, beta, mean, var, p, 1, seeds[:2])


@pytest.mark.parametrize("pool", [1, 2, 4])
@pytest.mark.parametrize("c", [4, 12, 64])
def test_plain_stem_tail_under_the_mask_matches_jnp(pool, c):
    """p = 0.4 under the Philox mask: the plain version's values and
    d(conv, gamma, beta) against the JAX jnp stem stage
    (``models/eeg.py``'s path) fed the same mask."""
    import jax
    import jax.numpy as jnp

    b, t, p = 3, 37, 0.4
    conv, gamma, beta, _, _ = _stem_case(2, 0, b, t, c)
    keep = conv_stem_train.keep_mask_plain(torch.tensor([2 ** 33 + c]), conv.shape, p)
    w = np.random.default_rng(3).normal(size=(b, t // pool, c)).astype(np.float32)
    keep_np = keep.numpy()

    def jnp_stage(conv, gamma, beta):
        mean = conv.mean((0, 1))
        var = (conv ** 2).mean((0, 1)) - mean ** 2
        y = (conv - mean) * jax.lax.rsqrt(var + 1e-5) * gamma + beta
        a = jnp.where(keep_np, jax.nn.gelu(y, approximate=False) / (1.0 - p), 0.0)
        return a[:, : (t // pool) * pool].reshape(b, t // pool, pool, c).max(2)

    args = tuple(jnp.asarray(a.numpy()) for a in (conv, gamma, beta))
    ref_out = jnp_stage(*args)
    ref_g = jax.grad(lambda *a: jnp.sum(jnp_stage(*a) * w), argnums=(0, 1, 2))(*args)
    leaves = [a.clone().requires_grad_() for a in (conv, gamma, beta)]
    tc, tg, tb = leaves
    mean = tc.mean((0, 1))  # with gradient, as in the jnp stage
    var = (tc * tc).mean((0, 1)) - mean * mean
    out = conv_stem_train.fused_stage_train_plain(tc, tg, tb, mean, var, pool, 1e-5, p, keep)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)
    for g, r in zip((tc.grad, tg.grad, tb.grad), ref_g):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()
    seeded, _ = conv_stem_train.stem_tail_fwd_seeded(
        conv, gamma, beta, mean.detach(), var.detach(), p, pool, torch.tensor([2 ** 33 + c]),
        with_code=False)
    assert torch.equal(seeded, out.detach())


# --------------------------------------------------------------------------
# CPU: row 3's arithmetic and epilogue, emulated
# --------------------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32<false>``: hi = TF32(x), lo = TF32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` on fp32 operands as one k-tile of ``mma.sync`` takes it:
    three TF32 passes (the small terms first) or one, summed in fp64 and
    rounded to fp32."""
    if passes == 1:
        return (tf32(a).double() @ tf32(b).double()).float()
    (ah, al), (bh, bl) = split(a), split(b)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def conv_stem_emulated(x, weight, scale, shift, padding: int, pool: int,
                       passes: int = 3) -> torch.Tensor:
    """``csrc/conv_stem.cu``'s arithmetic: the implicit GEMM's tap-major
    k-tiles of ``TILE_K`` input channels of one tap (zero past C), each a
    :func:`product`, summed in fp32 in the kernel's order; then
    ``fmaf(acc, scale, shift)`` (one rounding), erf-GELU in fp32, and the
    max over each pool window."""
    b, t, c = x.shape
    o, _, k = weight.shape
    t_out = (t + 2 * padding - k + 1) // pool
    m = t_out * pool
    xp = F.pad(x, (0, 0, padding, padding))
    acc = torch.zeros(b, m, o)
    for tap in range(k):
        for c0 in range(0, c, conv_stem.TILE_K):
            a = xp[:, tap: tap + m, c0: c0 + conv_stem.TILE_K]
            acc = acc + product(a, weight[:, c0: c0 + conv_stem.TILE_K, tap].T, passes)
    y = (acc.double() * scale.double() + shift.double()).float()
    return F.gelu(y).reshape(b, t_out, pool, o).amax(2)


def _conv_case(seed, b, t, c, o, k):
    """Seeded x, weight and a folded BatchNorm of the serving stem's scale."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(o, c, k)) / math.sqrt(c * k)).astype(np.float32))
    gamma = rng.normal(size=o) * 0.3 + 1
    mean, var = rng.normal(size=o) * 0.1, rng.uniform(0.5, 1.5, size=o)
    bias = rng.normal(size=o) * 0.1
    scale = gamma / np.sqrt(var + 1e-5)
    shift = rng.normal(size=o) * 0.1 - mean * scale + bias * scale
    return x, w, torch.from_numpy(scale.astype(np.float32)), torch.from_numpy(
        shift.astype(np.float32))


# the serving stages' (C, O, K, pad, pool) at a small B and T
CONV_STAGES = {"stage1": (2, 45, 32, 64, 15, 7, 4), "stage2": (2, 22, 64, 256, 5, 2, 2)}


@pytest.mark.parametrize("stage", sorted(CONV_STAGES))
def test_conv_emulation_matches_jax_interpret(stage):
    from multimodal_sentiment_aanalysis_tpu.kernels.conv_stem import fused_conv_bn_gelu_pool
    import jax.numpy as jnp

    b, t, c, o, k, pad, pool = CONV_STAGES[stage]
    x, w, scale, shift = _conv_case(11, b, t, c, o, k)
    ref = fused_conv_bn_gelu_pool(*(jnp.asarray(a.numpy()) for a in (x, w, scale, shift)),
                                  pad, pool)
    got = conv_stem_emulated(x, w, scale, shift, pad, pool)
    assert got.shape == ref.shape == (b, t // pool, o)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stage", sorted(CONV_STAGES))
def test_conv_emulation_meets_the_fp64_bar_one_pass_misses(stage):
    """Three TF32 passes within 1e-5 of the largest fp64 entry, as the fp32
    plain version is; one pass on TF32-rounded operands is not."""
    b, t, c, o, k, pad, pool = CONV_STAGES[stage]
    x, w, scale, shift = _conv_case(12, b, t, c, o, k)
    ref = conv_stem.fused_conv_bn_gelu_pool_plain(*(a.double() for a in (x, w, scale, shift)),
                                                  pad, pool)
    largest = ref.abs().max().item()
    err = lambda got: (got.double() - ref).abs().max().item() / largest
    assert err(conv_stem_emulated(x, w, scale, shift, pad, pool)) <= FP64_REL
    assert err(conv_stem_emulated(x, w, scale, shift, pad, pool, passes=1)) > FP64_REL
    assert err(conv_stem.fused_conv_bn_gelu_pool_plain(x, w, scale, shift, pad, pool)) <= 1e-5


def shuffle_pool(frag: np.ndarray, pool: int) -> dict:
    """The kernel's epilogue fold over one 16 x 8 accumulator fragment
    (lane = 4 gid + tig holds rows gid and gid + 8, columns 2 tig and
    2 tig + 1): each lane's values, then ``__shfl_xor_sync`` at lane
    offsets 4, 8, .. below 4 pool, the lane with the offset bit set holding
    the later rows; returns what the lanes with gid % pool == 0 store, by
    (row, column)."""
    regs = {lane: [frag[lane // 4 + 8 * h, 2 * (lane % 4) + e] for h in (0, 1) for e in (0, 1)]
            for lane in range(32)}
    off = 4
    while off < 4 * pool:
        new = {}
        for lane in range(32):
            mine, other = regs[lane], regs[lane ^ off]
            earlier, later = (other, mine) if lane & off else (mine, other)
            new[lane] = [lt if lt > er else er for er, lt in zip(earlier, later)]
        regs, off = new, off * 2
    stored = {}
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        if gid % pool == 0:
            for h in (0, 1):
                for e in (0, 1):
                    stored[(gid + 8 * h, 2 * tig + e)] = regs[lane][2 * h + e]
    return stored


@pytest.mark.parametrize("pool", [1, 2, 4, 8])
def test_epilogue_shuffles_fold_each_pool_window(pool):
    """Every pool window of a fragment's rows is folded into the lane of
    its first row, with its max; no other row is stored."""
    frag = np.random.default_rng(pool).normal(size=(16, 8))
    frag[0, :] = frag[1, :]  # a tie: the value is the same whichever row wins
    stored = shuffle_pool(frag, pool)
    want = {(r, n): frag[r: r + pool, n].max() for r in range(0, 16, pool) for n in range(8)}
    assert stored == want


@pytest.mark.parametrize("pool", [1, 2, 3, 4, 8, 64])
def test_position_tiles_cover_the_pooled_rows_once(pool):
    """A block's ``TILE_M`` conv positions hold ``TILE_M // pool`` whole
    windows: the grid's tiles cover every pooled row once, and a tile's
    windows lie inside its positions and the staged halo."""
    t_out = 146
    per = conv_stem.TILE_M // pool
    tiles = -(-t_out // per)
    rows = [tile * per + r for tile in range(tiles) for r in range(per) if tile * per + r < t_out]
    assert rows == list(range(t_out))
    assert per * pool <= conv_stem.TILE_M


def test_conv_smem_counts_the_window_and_ring():
    """The weight ring (4 k-tiles of 16 x 72 floats) and the window's two
    TF32 words (64 + K - 1 rows of C rounded up to 16, plus 4): both stages
    fit four blocks an SM (228 KB, 1 KB reserved a block)."""
    assert conv_stem.smem_bytes(32, 15) == 4 * (4 * 16 * 72 + 2 * 78 * 36)
    assert conv_stem.smem_bytes(7, 3) == 4 * (4 * 16 * 72 + 2 * 66 * 20)
    for c, k in ((32, 15), (64, 5)):
        assert 4 * (conv_stem.smem_bytes(c, k) + 1024) <= 228 * 1024


# --------------------------------------------------------------------------
# card: the kernels against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# (S, B, T, C, pool): S = 0 is a (B, T, C) conv; the stages at S = 1 and 3,
# and ragged B and T with C % 4 != 0 (the scalar path) and C = 12
STEM_CARD = {"stage1_s1": (0, 64, 585, 64, 4), "stage2_s3": (3, 64, 146, 256, 2),
             "stage1_s3": (3, 16, 585, 64, 4), "ragged_c5": (3, 5, 37, 5, 3),
             "ragged_c12": (0, 7, 23, 12, 2), "ragged_c7_pool1": (3, 3, 13, 7, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.4])
@pytest.mark.parametrize("shape", sorted(STEM_CARD))
def test_stem_tail_kernel_matches_plain_under_the_mask(cuda, shape, p, dtype):
    """Row 2 with its seeds given: the pooled output against the plain
    version fed ``keep_mask_plain`` of the same seeds (fp32 1e-5; bf16 one
    ulp on top), the codes equal but where two window entries tie within
    rounding, and at pool 1 the code (the keep bit) equal bit for bit."""
    s, b, t, c, pool = STEM_CARD[shape]
    dt = getattr(torch, dtype)
    conv, gamma, beta, mean, var = (a.to(cuda) for a in _stem_case(21, s, b, t, c))
    conv = conv.to(dt)
    seeds = torch.arange(max(s, 1), device=cuda, dtype=torch.int64) * 977 + 2 ** 35
    keep = conv_stem_train.keep_mask_plain(seeds.cpu(), conv.shape, p).to(cuda) if p else None
    kernel = conv_stem_train.KERNELS[dt]
    with torch.no_grad():
        before = kernel.launches
        out, code = conv_stem_train.stem_tail_fwd_seeded(conv, gamma, beta, mean, var, p, pool,
                                                         seeds)
        assert kernel.launches == before + 1 and out.dtype == dt and out.shape == code.shape
        ref, ref_code = conv_stem_train.fused_stage_train_plain(
            conv, gamma, beta, mean, var, pool, 1e-5, p, keep, with_code=True)
    torch.cuda.synchronize()
    tol = BF16_ULP if dt == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=1e-5)
    assert (code != ref_code).double().mean().item() <= 1e-3
    if pool == 1:  # winner 0 + pool * keep bit
        assert torch.equal(code, keep.int() if p else torch.ones_like(code))


@pytest.mark.gpu
def test_stem_tail_kernel_mask_is_the_cpu_model_at_stage_shapes(cuda):
    """pool 1 over stage 1's and stage 2's LOSO shapes at S = 2: every keep
    bit of the kernel equals the numpy Philox model's."""
    for shape in ((2, 64, 585, 64), (2, 64, 146, 256)):
        conv = torch.randn(shape, device=cuda)
        ones, zeros = torch.ones(2, shape[-1], device=cuda), torch.zeros(2, shape[-1], device=cuda)
        seeds = torch.tensor([3, 2 ** 61 + 17], device=cuda)
        with torch.no_grad():
            _, code = conv_stem_train.stem_tail_fwd_seeded(conv, ones, zeros, zeros, ones, 0.4, 1,
                                                           seeds)
        keep = conv_stem_train.keep_mask_plain(seeds.cpu(), shape, 0.4)
        assert torch.equal(code.cpu(), keep.int())


# (B, T, C, pool) of the stem's two stages, split over a tensor-parallel model axis
SHARD_CARD = {"stage1": (64, 585, 64, 4), "stage2": (64, 146, 256, 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("stage", sorted(SHARD_CARD))
def test_stem_tail_kernels_on_a_channel_shard(cuda, stage, tp):
    """Rows 2 and 12 on each channel shard of a stem layer split ``tp``
    ways (``channels=(c_off, C)``), p 0.4 at the stage's pool: the shard's
    pooled output and codes equal the unsharded kernel's columns bit for
    bit, and the plain version's fed ``keep_mask_plain(channels=)`` (1e-5,
    the codes but where two window entries tie); row 12 on the shard's code
    against its plain version (``dy`` 1e-5, the summed partials 1e-4
    relative + 1e-3)."""
    b, t, c, pool = SHARD_CARD[stage]
    h = c // tp
    conv, gamma, beta, mean, var = (a.to(cuda) for a in _stem_case(22, 0, b, t, c))
    seeds = torch.tensor([2 ** 40 + 5], device=cuda)
    dpool = torch.from_numpy(np.random.default_rng(23).normal(size=(b, t // pool, c))
                             .astype(np.float32)).to(cuda)
    with torch.no_grad():
        whole, whole_code = conv_stem_train.stem_tail_fwd_seeded(conv, gamma, beta, mean, var,
                                                                 0.4, pool, seeds)
        for i in range(tp):
            cols = slice(i * h, (i + 1) * h)
            args = [a[..., cols].contiguous() for a in (conv, gamma, beta, mean, var)]
            out, code = conv_stem_train.stem_tail_fwd_seeded(*args, 0.4, pool, seeds,
                                                             channels=(i * h, c))
            assert torch.equal(out, whole[..., cols]) and torch.equal(code, whole_code[..., cols])
            keep = conv_stem_train.keep_mask_plain(seeds.cpu(), (b, t, h), 0.4,
                                                   channels=(i * h, c)).to(cuda)
            ref, ref_code = conv_stem_train.fused_stage_train_plain(*args, pool, 1e-5, 0.4, keep,
                                                                    with_code=True)
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
            assert (code != ref_code).double().mean().item() <= 1e-3
            inv = torch.rsqrt(args[4] + 1e-5)
            scale = args[1] * inv
            bwd = (args[0], dpool[..., cols].contiguous(), code, scale,
                   args[2] - args[3] * scale, args[3], inv, 0.4, pool)
            dy, dg, db = conv_stem_train.stem_tail_bwd(*bwd)
            want = conv_stem_train.stem_tail_bwd_plain(*bwd)
            torch.cuda.synchronize()
            torch.testing.assert_close(dy, want[0], rtol=0, atol=1e-5)
            for g, w in zip((dg, db), want[1:]):
                torch.testing.assert_close(g.sum(0), w.sum(0), rtol=1e-4, atol=1e-3)


# (B, T, C, O, K, pad, pool): the serving stages, and ragged shapes: C % 4
# != 0 (scalar window copies), O % 4 != 0 (a padded weight row), pools
# that do not divide 8 (the shared-memory epilogue), partial tiles
CONV_CARD = {"stage1": (64, 585, 32, 64, 15, 7, 4), "stage2": (64, 146, 64, 256, 5, 2, 2),
             "ragged_c7": (3, 37, 7, 40, 3, 1, 3), "ragged_o37": (5, 101, 20, 37, 4, 1, 8),
             "ragged_pool5": (2, 200, 16, 70, 7, 3, 5), "pool1": (3, 70, 8, 64, 1, 0, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CONV_CARD))
def test_conv_stem_kernel_matches_plain_and_fp64(cuda, shape):
    b, t, c, o, k, pad, pool = CONV_CARD[shape]
    x, w, scale, shift = (a.to(cuda) for a in _conv_case(13, b, t, c, o, k))
    before = conv_stem.KERNEL.launches
    got = conv_stem.fused_conv_bn_gelu_pool(x, w, scale, shift, pad, pool)
    assert conv_stem.KERNEL.launches == before + 1
    want = conv_stem.fused_conv_bn_gelu_pool_plain(x, w, scale, shift, pad, pool)
    ref = conv_stem.fused_conv_bn_gelu_pool_plain(*(a.double() for a in (x, w, scale, shift)),
                                                  pad, pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got.double() - ref).abs().max().item() <= FP64_REL * ref.abs().max().item()

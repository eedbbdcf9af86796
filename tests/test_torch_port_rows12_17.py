"""Rows 12 and 17 of the kernel table: the stem tail's backward
(``csrc/stem_tail.cu::stem_tail_bwd_kernel``) and the ME-MHACL fused head
(``csrc/fusion_head.cu::fusion_head_kernel``).

On the CPU:

- row 12's plain version, whose ``dy`` now has the conv's full length,
  against JAX ``_bwd_call`` in interpret mode under ``jax.vmap`` (the
  trainer's form: one S-wide call), at S 1 and 3, pools 2 and 4, C a
  multiple of 4 and not, fp32 and bf16, the code of a p 0.4 forward: ``dy``
  within 1e-5 (JAX's covered rows, the tail rows 0), the partials' sums
  within 1e-5 of their largest entry; the stem Function's ``dconv``,
  ``dgamma`` and ``dbeta`` at T = 585, pool 4 against ``jax.vjp`` of the
  JAX stage (1e-5 of the largest entry); the layout of the kernel's
  partials (``conv_stem_train.bwd_plan``: whole passes a tile, the tiles
  cover each batch row's pooled rows once, the per-chunk sums add up to
  the plain version's) and the new refusals;
- row 17's tensor-core arithmetic written out in torch
  (:func:`head_emulated`): the cluster's CTAs each take their heads, out
  projection columns and shared units; every product in k-chunks (32
  features a chunk in TF32, 64 for bf16 x bf16), each k-step's passes
  summed in fp64 and rounded to fp32 as the tensor cores sum a fragment,
  the fragments and the chunks added in fp32 (3xTF32: hi rounded, lo
  truncated, lo.hi + hi.lo + hi.hi; an fp32 intermediate times a bf16
  weight: lo.w + hi.w); the logits' shares added in rank order. Against fp64 at 1e-5 of the largest |logit| (the bar
  ``chip_smoke.py`` holds the kernel to), a bar one TF32 pass misses; and
  against JAX ``fused_mha_fusion_head`` in interpret mode, fp32 at 1e-5
  plus 1e-5 of the value, bf16 at ``BF16_RTOL`` of the value plus 1e-5
  (its logits are bf16). Also the cluster size the wrapper picks, bf16
  accepted and the shapes the kernel refuses, with their reasons.

The ``gpu``-marked tests hold each kernel against its plain version on the
card (row 12 at S = 1 and 24, both stages, fp32 and bf16, and the scalar
and any-pool forms; row 17 at every ``HEAD_SHAPES`` shape of
``test_torch_port_memhacl.py`` and the engines' tiny one, fp32 and bf16,
fp32 also against fp64). They skip without a card and import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_rows12_17.py``.
"""

import math

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem_train, fusion_head
from multimodal_sentiment_aanalysis_tpu_torch.kernels._build import MAX_MODELS
from torch_flash_emulation import split, tf32
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BF16 = torch.bfloat16
BF16_RTOL = 2.0 ** -7  # chip_smoke.py's BF16_RTOL: one ulp of a bf16 value
FP64_REL = 1e-5        # the fused head against fp64, of the largest |logit|
P = 0.4


# --------------------------------------------------------------------------
# row 12: the stem tail's backward
# --------------------------------------------------------------------------


def _bwd_case(seed, s, b, t, c, pool, dtype=torch.float32):
    """Seeded ``(S, B, T, C)`` conv, its batch statistics, gamma and beta, a
    p 0.4 forward's code under ``keep_mask_plain``, and ``dpool``: the
    backward's operands in ``dtype``, per-channel values in fp32."""
    rng = np.random.default_rng(seed)
    conv = torch.from_numpy(rng.normal(size=(s, b, t, c)).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy((rng.normal(size=(s, c)) * 0.3 + 1).astype(np.float32))
    beta = torch.from_numpy((rng.normal(size=(s, c)) * 0.1).astype(np.float32))
    mean = conv.float().mean((1, 2))
    var = (conv.float() ** 2).mean((1, 2)) - mean ** 2
    keep = conv_stem_train.keep_mask_plain(torch.arange(s) * 131 + 2 ** 34, conv.shape, P)
    _, code = conv_stem_train.fused_stage_train_plain(conv, gamma, beta, mean, var, pool, 1e-5,
                                                      P, keep, with_code=True)
    dpool = torch.from_numpy(rng.normal(size=tuple(code.shape)).astype(np.float32)).to(dtype)
    inv = torch.rsqrt(var + 1e-5)
    scale = gamma * inv
    return conv, dpool, code, scale, beta - mean * scale, mean, inv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 6])
@pytest.mark.parametrize("pool", [2, 4])
@pytest.mark.parametrize("s", [1, 3])
def test_bwd_plain_matches_jax_bwd_call(s, pool, c, dtype):
    """The plain backward against JAX ``_bwd_call`` (interpret mode) under
    ``jax.vmap`` of the stage's batched backward, fed the same code: ``dy``
    over JAX's covered rows (its full-lane rows unfolded) within 1e-5 and 0
    in the tail row, the dgamma / dbeta partials' sums within 1e-5 of their
    largest entry plus 1e-5."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import conv_stem_train as jcst

    dt = getattr(torch, dtype)
    b, t = 8, 3 * pool + 1  # B a multiple of JAX's batch tile; one tail row
    args = _bwd_case(7 + s + pool + c, s, b, t, c, pool, dt)
    dy, dg, db = conv_stem_train.stem_tail_bwd(*args, P, pool)
    assert dy.shape == (s, b, t, c) and dy.dtype == torch.float32
    jdt = jnp.bfloat16 if dt == BF16 else jnp.float32
    conv, dpool, code, *per = args
    ops = (jnp.asarray(conv.float().numpy(), jdt), jnp.asarray(dpool.float().numpy(), jdt),
           jnp.asarray(code.numpy()), *(jnp.asarray(v.numpy()) for v in per))
    vm_bwd = jcst._make_vm(P, pool, True)[1]
    ref_dy, ref_dg, ref_db = jax.vmap(vm_bwd)(*ops)
    t_cov = (t // pool) * pool
    ref_dy = np.asarray(ref_dy).reshape(s, b, t_cov, c)
    np.testing.assert_allclose(dy[:, :, :t_cov].numpy(), ref_dy, rtol=0, atol=1e-5)
    assert not dy[:, :, t_cov:].any()
    for got, ref in ((dg, ref_dg), (db, ref_db)):
        ref = np.asarray(ref).sum((1, 2))
        assert np.abs(got.sum(1).numpy() - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-5


def test_plain_dy_routes_to_the_winner_only():
    """Each (cell, channel) of ``dy`` has at most one nonzero row, the
    winner's, and none where the code's keep bit is off."""
    pool = 4
    conv, dpool, code, *per = _bwd_case(3, 2, 3, 4 * 5 + 3, 8, pool)
    dy, _, _ = conv_stem_train.stem_tail_bwd_plain(conv, dpool, code, *per, P, pool)
    cells = dy[:, :, :20].reshape(2, 3, 5, pool, 8)
    nonzero = (cells != 0).sum(3)
    assert (nonzero <= 1).all() and not nonzero[code < pool].any()
    rows = cells.abs().argmax(3)
    assert torch.equal(rows[nonzero == 1], (code % pool).long()[nonzero == 1])


def test_stem_function_gradients_match_jax_vjp_at_585():
    """The stem Function at stage 1's T = 585, pool 4, p 0 (584 rows
    pooled, one tail row): ``dconv``, ``dgamma`` and ``dbeta`` through the
    plain backward's full-length ``dy`` and the BN combine, against
    ``jax.vjp`` of the JAX fused stage (interpret mode), within 1e-5 of each
    one's largest entry."""
    import jax
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import conv_stem_train as jcst

    b, t, c, pool = 8, 585, 8, 4
    rng = np.random.default_rng(11)
    conv = rng.normal(size=(b, t, c)).astype(np.float32)
    gamma = (rng.normal(size=c) * 0.3 + 1).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    w = rng.normal(size=(b, t // pool, c)).astype(np.float32)

    def jax_stage(conv, gamma, beta):
        mean = conv.mean((0, 1))
        var = (conv ** 2).mean((0, 1)) - mean ** 2
        seeds = jnp.zeros((8, 128), jnp.int32)
        return jcst.fused_stage_train(conv, gamma, beta, jax.lax.stop_gradient(mean),
                                      jax.lax.stop_gradient(var), seeds, 0.0, pool, 1e-5, True)

    ref_out, vjp = jax.vjp(jax_stage, *map(jnp.asarray, (conv, gamma, beta)))
    ref_g = vjp(jnp.asarray(w))
    tc, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (conv, gamma, beta))
    with torch.no_grad():
        mean = tc.mean((0, 1))
        var = (tc * tc).mean((0, 1)) - mean * mean
    out = conv_stem_train.fused_stage_train(tc, tg, tb, mean, var, 0.0, pool)
    out.backward(torch.from_numpy(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)
    for got, ref in zip((tc.grad, tg.grad, tb.grad), ref_g):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert tc.grad[:, -1].abs().max() > 0  # the tail row's gradient: the BN combine's


PLANS = {"stage1_s24": ((24, 64, 585, 64), 4), "stage2_s24": ((24, 64, 146, 256), 2),
         "stage1_s1": ((1, 64, 585, 64), 4), "stage2_s1": ((1, 64, 146, 256), 2),
         "pool3_c12": ((3, 5, 37, 12), 3), "pool1_c5": ((2, 3, 13, 5), 1)}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_bwd_partials_layout(case):
    """``bwd_plan``: a tile is whole passes of a block (its thread rows
    times the cells each holds: 2 at pool 4, 4 at pool 2, else 1); the
    tiles cover each batch row's pooled rows once; a launch has at least
    ``_BWD_BLOCKS`` blocks unless every tile is one pass; and the chunk
    sums of the per-cell terms (chunk ``b row_tiles + r``: rows ``[r
    tile_rows, (r + 1) tile_rows)`` of batch row ``b``) add up to the
    plain version's one chunk."""
    shape, pool = PLANS[case]
    s, b, t, c = shape
    tile_rows, row_tiles = conv_stem_train.bwd_plan(shape, pool)
    t_out = t // pool
    groups = -(-c // 4)
    gx = min(1 << (groups - 1).bit_length(), 32)
    per_pass = 128 // gx * (8 // pool if pool in (2, 4) else 1)
    assert tile_rows % per_pass == 0
    assert (row_tiles - 1) * tile_rows < t_out <= row_tiles * tile_rows
    blocks = s * b * row_tiles * -(-groups // gx)
    assert blocks >= conv_stem_train._BWD_BLOCKS or tile_rows == per_pass
    if s * b * t * c > 2 ** 22:
        return  # the emulation below at the small shapes only
    conv, dpool, code, scale, shift, mean, inv = _bwd_case(1, s, b, t, c, pool)
    _, dg, db = conv_stem_train.stem_tail_bwd_plain(conv, dpool, code, scale, shift, mean, inv,
                                                    P, pool)
    x = conv[:, :, : t_out * pool].reshape(s, b, t_out, pool, c).gather(
        3, (code.long() % pool)[:, :, :, None]).squeeze(3)
    y = x * scale[:, None, None] + shift[:, None, None]
    grad = 0.5 * (1 + torch.erf(y / math.sqrt(2))) + y * torch.exp(-0.5 * y * y) / math.sqrt(
        2 * math.pi)
    g = torch.where(code >= pool, dpool * grad / (1 - P), 0.0)
    terms = torch.stack([g * (x - mean[:, None, None]) * inv[:, None, None], g]).double()
    pad = torch.zeros(2, s, b, row_tiles * tile_rows - t_out, c, dtype=torch.float64)
    chunks = torch.cat([terms, pad], 3).reshape(2, s, b * row_tiles, tile_rows, c).sum(3)
    # the plain version sums in fp32: within 1e-5 of the sum of |terms|
    bounds = 1e-5 * terms.abs().sum((2, 3)) + 1e-6
    for got, want, bound in zip(chunks.sum(2), (dg.sum(1), db.sum(1)), bounds):
        assert ((got - want.double()).abs() <= bound).all()


def test_bwd_plan_refuses_what_the_grid_cannot_hold():
    """B above the grid's y extent, B T C past 32-bit offsets within a
    model, more models than grid z: refused before any launch."""
    for shape in ((1, 65536, 4, 4), (1, 64, 2 ** 20, 32), (MAX_MODELS + 1, 1, 4, 4)):
        with pytest.raises(ValueError, match="backward kernel takes"):
            conv_stem_train.bwd_plan(shape, 2)


BWD_REFUSALS = {
    "dpool shape": lambda a: (a[0], a[1][..., :1, :], *a[2:]),
    "dpool dtype": lambda a: (a[0], a[1].double(), *a[2:]),
    "code int64": lambda a: (*a[:2], a[2].long(), *a[3:]),
    "code shape": lambda a: (*a[:2], a[2][:1], *a[3:]),
    "scale shape": lambda a: (*a[:3], a[3][:, :1], *a[4:]),
}


@pytest.mark.parametrize("case", sorted(BWD_REFUSALS))
def test_bwd_refuses_mismatched_operands(case):
    """Operands that do not match conv's shape or type raise on either
    device, before the plain version or the kernel runs."""
    args = BWD_REFUSALS[case](_bwd_case(2, 2, 3, 9, 8, 2))
    with pytest.raises(ValueError):
        conv_stem_train.stem_tail_bwd(*args, P, 2)


# --------------------------------------------------------------------------
# row 17: the fused head
# --------------------------------------------------------------------------


def _head_case(seed, b, f, heads, hidden, ncls=2):
    """Seeded embeddings and :func:`fusion_head.head_weights`-ordered
    weights (torch layouts), as numpy fp32."""
    rng = np.random.default_rng(seed)
    n = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    xs = [n(b, f) for _ in range(3)]
    weights = [n(3 * f, f, s=f ** -0.5), n(3 * f, s=0.1), n(f, f, s=f ** -0.5), n(f, s=0.1),
               n(hidden, f, s=f ** -0.5), n(hidden, s=0.1), n(ncls, hidden, s=hidden ** -0.5),
               n(ncls, s=0.1), n(ncls, hidden, s=hidden ** -0.5), n(ncls, s=0.1)]
    return xs, weights


def _chunked(a: torch.Tensor, w: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ w.T`` as ``tile_gemm`` sums it at the reference shape (one n8
    tile a warp: four fragments a chunk): per k-chunk (64 features for bf16
    x bf16, else 32) each k-step's passes summed in fp64 and rounded to fp32
    as the tensor cores sum a fragment, the four fragments then the chunks
    added in fp32. A k-step of a 32-feature chunk holds features 8t + 2s and
    8t + 2s + 1 (t < 4); of a 64-feature bf16 chunk, 16t + 4s .. 16t + 4s +
    3. bf16 x bf16: the exact products. Else an fp32 operand split into TF32
    words (hi rounded, lo truncated), a bf16 one exact: three passes (lo.hi
    + hi.lo + hi.hi) for fp32 x fp32, two (lo.w + hi.w) for fp32 x bf16;
    ``passes`` 1 is one TF32 pass on operands rounded once (what the fp64
    bar rules out). (A product the kernel splits across its warps by chunk
    adds the parts' sums in part order: the same fragments in another
    order.)"""
    both = a.dtype == BF16 and w.dtype == BF16
    chunk = 64 if both else 32
    if both:
        steps = [[16 * t + 4 * s + e for t in range(4) for e in range(4)] for s in range(4)]
    else:
        steps = [[8 * t + 2 * s + e for t in range(4) for e in range(2)] for s in range(4)]
    acc = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], chunk):
        for cols in steps:
            idx = [k0 + c for c in cols if k0 + c < a.shape[1]]
            if not idx:
                continue
            ac, wc = a[:, idx], w[:, idx]
            if both:
                part = ac.double() @ wc.double().T
            elif passes == 1:
                part = tf32(ac.float()).double() @ tf32(wc.float()).double().T
            else:
                (ah, al) = split(ac.float())
                (wh, wl) = split(wc.float()) if wc.dtype == torch.float32 else (wc.float(), None)
                part = al.double() @ wh.double().T + ah.double() @ wh.double().T
                if wl is not None:
                    part = part + ah.double() @ wl.double().T
            acc = acc + part.float()
    return acc


def head_emulated(xs, weights, num_heads: int, passes: int = 3):
    """The kernel's arithmetic: per cluster CTA r (K = ``cluster_size``),
    its heads r, r + K, ... (their q, k, v columns of in_proj), its out
    projection columns [r F/K, (r + 1) F/K) and its shared units [r u, (r +
    1) u), u = ceil(hidden / K); the head logits summed per CTA over its
    units, then across the CTAs in rank order, plus the bias. Every
    intermediate fp32; the logits in the embeddings' dtype."""
    dtype = xs[0].dtype
    in_w, in_b, out_w, out_b, sh_w, sh_b, a_w, a_b, v_w, v_b = weights
    f, hidden = xs[0].shape[1], sh_w.shape[0]
    k = fusion_head.cluster_size(num_heads)
    dh, fk, units = f // num_heads, f // k, -(-hidden // k)
    x = torch.cat(xs)  # (3B, F): modality-major
    bsz = xs[0].shape[0]
    att = torch.zeros(3 * bsz, f)
    for r in range(k):
        for h in range(r, num_heads, k):
            cols = [p * f + h * dh + d for p in range(3) for d in range(dh)]
            qkv = _chunked(x, in_w[cols], passes) + in_b[cols].float()
            q, kk, v = (qkv[:, i * dh:(i + 1) * dh].reshape(3, bsz, dh) for i in range(3))
            s = torch.einsum("ibd,jbd->bij", q, kk) * (1.0 / math.sqrt(dh))
            p = torch.softmax(s, -1)
            att[:, h * dh:(h + 1) * dh] = torch.einsum("bij,jbd->ibd", p, v).reshape(3 * bsz, dh)
    mean = torch.zeros(bsz, f)
    for r in range(k):
        cols = slice(r * fk, (r + 1) * fk)
        o = (_chunked(att, out_w[cols], passes) + out_b[cols].float()).reshape(3, bsz, fk)
        mean[:, cols] = (o[0] + o[1] + o[2]) / 3.0
    logits = torch.zeros(bsz, 2 * a_w.shape[0])
    heads = torch.cat([a_w, v_w]).float()
    for r in range(k):
        u = slice(r * units, min(hidden, (r + 1) * units))
        sh = torch.relu(_chunked(mean, sh_w[u], passes) + sh_b[u].float())
        logits = logits + sh @ heads[:, u].T  # rank order
    logits = logits + torch.cat([a_b, v_b]).float()
    ncls = a_w.shape[0]
    return logits[:, :ncls].to(dtype), logits[:, ncls:].to(dtype)


# (B, F, heads, hidden): test_torch_port_memhacl.py's HEAD_SHAPES and the
# engines' tiny head (F 32, 4 heads, hidden 16)
HEAD_SHAPES = {"ref": (32, 256, 8, 128), "ragged": (37, 256, 8, 128),
               "tiny": (3, 64, 8, 32), "b5": (5, 64, 4, 32), "b37": (37, 128, 8, 64),
               "engines": (8, 32, 4, 16)}
EMULATED = ("ref", "b5", "b37", "engines")


def _fp64_logits(xs, weights, heads):
    return fusion_head.fusion_head_plain(*(t.double() for t in xs),
                                         *(t.double() for t in weights), num_heads=heads)


@pytest.mark.parametrize("shape", EMULATED)
def test_head_emulation_meets_fp64_bar_one_pass_misses(shape):
    """fp32: the emulated kernel within 1e-5 of the largest |logit| of the
    fp64 head; one TF32 pass on operands rounded once misses that bar."""
    b, f, heads, hidden = HEAD_SHAPES[shape]
    xs, weights = (list(map(torch.from_numpy, a)) for a in _head_case(5, b, f, heads, hidden))
    ref = _fp64_logits(xs, weights, heads)
    scale = max(r.abs().max().item() for r in ref)
    for passes, meets in ((3, True), (1, False)):
        got = head_emulated(xs, weights, heads, passes)
        err = max((g.double() - r).abs().max().item() for g, r in zip(got, ref))
        assert (err <= FP64_REL * scale) == meets, (passes, err / scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EMULATED)
def test_head_emulation_matches_plain_and_jax(shape, dtype):
    """The emulated kernel against the plain version and JAX
    ``fused_mha_fusion_head`` (interpret mode) on the same values: fp32
    within 1e-5 + 1e-5 of the value; bf16 (embeddings and weights bf16,
    logits bf16) within ``BF16_RTOL`` of the value + 1e-5, and its fp32
    arithmetic within 1e-5 of the plain version's on the same bf16
    values."""
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import fused_mha_fusion_head as jax_head

    dt = getattr(torch, dtype)
    b, f, heads, hidden = HEAD_SHAPES[shape]
    xs, weights = (list(map(torch.from_numpy, a)) for a in _head_case(6, b, f, heads, hidden))
    xs, weights = [t.to(dt) for t in xs], [t.to(dt) for t in weights]
    got = head_emulated(xs, weights, heads)
    want = fusion_head.fusion_head_plain(*xs, *weights, num_heads=heads)
    assert all(g.dtype == dt and g.shape == (b, 2) for g in got + want)
    jdt = jnp.bfloat16 if dt == BF16 else jnp.float32
    j = lambda t: jnp.asarray(t.float().numpy(), jdt)
    in_w, in_b, out_w, out_b, sh_w, sh_b, a_w, a_b, v_w, v_b = weights
    mha = {"in_proj_weight": j(in_w), "in_proj_bias": j(in_b), "out_proj_weight": j(out_w),
           "out_proj_bias": j(out_b)}
    clf = {"shared": {"kernel": j(sh_w.T.contiguous()), "bias": j(sh_b)},
           "fc_arousal": {"kernel": j(a_w.T.contiguous()), "bias": j(a_b)},
           "fc_valence": {"kernel": j(v_w.T.contiguous()), "bias": j(v_b)}}
    ref = jax_head(*map(j, xs), mha, clf, num_heads=heads, block_b=8, interpret=True)
    rtol = BF16_RTOL if dt == BF16 else 1e-5
    for g, w, r in zip(got, want, ref):
        r = torch.from_numpy(np.array(r.astype(jnp.float32)))
        torch.testing.assert_close(g.float(), r, rtol=rtol, atol=1e-5)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=1e-5)
    if dt == BF16:  # the arithmetic before the logits' rounding
        up = [t.float() for t in xs], [t.float() for t in weights]
        fp32 = fusion_head.fusion_head_plain(*up[0], *up[1], num_heads=heads)
        for g, w in zip(got, fp32):
            torch.testing.assert_close(g, w.to(BF16), rtol=BF16_RTOL, atol=1e-5)


@pytest.mark.parametrize("heads, k", [(4, 4), (6, 6), (8, 8), (16, 8), (12, 6), (5, 5), (1, 1)])
def test_cluster_size_is_the_largest_divisor_up_to_8(heads, k):
    assert fusion_head.cluster_size(heads) == k


def test_plain_bf16_computes_in_fp32():
    """A bf16 call of the plain version: the fp32 head on the bf16 values,
    rounded to bf16 once at the logits."""
    xs, weights = (list(map(torch.from_numpy, a)) for a in _head_case(8, 5, 32, 4, 16))
    xb, wb = [t.to(BF16) for t in xs], [t.to(BF16) for t in weights]
    got = fusion_head.fusion_head(*xb, *wb, num_heads=4)  # the CPU path: the plain version
    want = fusion_head.fusion_head_plain(*(t.float() for t in xb), *(t.float() for t in wb),
                                         num_heads=4)
    for g, w in zip(got, want):
        assert g.dtype == BF16 and torch.equal(g, w.to(BF16))


def test_check_accepts_bf16_operands():
    """``_check`` (the launch's validation) takes bf16 operands of one dtype
    at the reference shape (tiles of 4 rows); mixed dtypes raise."""
    xs, weights = (list(map(torch.from_numpy, a)) for a in _head_case(9, 32, 256, 8, 128))
    xb, wb = [t.to(BF16) for t in xs], [t.to(BF16) for t in weights]
    assert fusion_head._check(*xb, wb, 8) == (32, 256, 128, 2, 4)
    with pytest.raises(TypeError):
        fusion_head._check(*xb, [wb[0].float(), *wb[1:]], 8)


HEAD_REFUSALS = {
    # (F, heads, hidden, dtype, reason)
    "heads_do_not_divide_f": (100, 8, 32, torch.float32, "F % heads"),
    "f_not_16_byte_rows_bf16": (36, 4, 16, BF16, "multiple of 8"),
    "one_head_too_wide": (256, 1, 128, torch.float32, "weight rows"),
    "shared_memory": (640, 8, 128, torch.float32, "shared memory"),
}


@pytest.mark.parametrize("case", sorted(HEAD_REFUSALS))
def test_check_refuses_shapes_out_of_range(case):
    """Shapes the cluster kernel cannot take at any batch tile raise with
    the reason."""
    f, heads, hidden, dtype, reason = HEAD_REFUSALS[case]
    xs, weights = (list(map(torch.from_numpy, a)) for a in _head_case(10, 4, f, heads, hidden))
    with pytest.raises(ValueError, match=reason):
        fusion_head._check(*(t.to(dtype) for t in xs), [t.to(dtype) for t in weights], heads)


@pytest.mark.parametrize("tile_rows, f, heads, dtype, smem", [
    (4, 256, 8, torch.float32, 120768), (4, 256, 8, BF16, 112576),
    (16, 256, 8, torch.float32, 200128), (4, 256, 4, torch.float32, 182144),
    (8, 256, 4, torch.float32, 227968), (16, 256, 4, torch.float32, 273792)])
def test_plan_smem(tile_rows, f, heads, dtype, smem):
    """A CTA's shared memory (hidden 128, 2 classes): the ring, the
    embeddings, the pushed attention output, q | k | v, the pushed mean and
    logit shares, the column tables, the split products' partial sums; the
    reference head at tiles of 4 rows 120,768 bytes."""
    assert fusion_head.plan_smem(tile_rows, f, heads, 128, 2, dtype) == smem


@pytest.mark.parametrize("b, heads, tile_rows", [(32, 8, 4), (37, 8, 4), (64, 8, 4), (200, 8, 16),
                                                  (512, 8, 16), (512, 4, 8), (3, 4, 4)])
def test_plan_spreads_small_batches_over_the_sms(b, heads, tile_rows):
    """The smallest tile whose clusters (K CTAs each) fit 132 SMs, else the
    largest that fits a block's shared memory (4 heads at F 256: 8 rows)."""
    assert fusion_head.plan(b, 256, heads, 128, 2, torch.float32)[0] == tile_rows


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


# (S, B, T, C, pool): both LOSO stages at S = 1 and 24, and the scalar
# (C % 4 != 0) and any-pool forms on ragged shapes
BWD_CARD = {"stage1_s1": (1, 64, 585, 64, 4), "stage2_s1": (1, 64, 146, 256, 2),
            "stage1_s24": (24, 64, 585, 64, 4), "stage2_s24": (24, 64, 146, 256, 2),
            "scalar_c6": (3, 5, 37, 6, 2), "pool3_c12": (2, 7, 40, 12, 3),
            "pool9": (2, 3, 40, 20, 9)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(BWD_CARD))
def test_bwd_kernel_matches_plain_on_card(cuda, shape, dtype):
    """Row 12 on a p 0.4 forward's code: one launch; ``dy`` at the full
    length (tail rows 0) within 1e-5 of the plain version's, the partials
    in ``bwd_plan``'s chunks, their sums within 1e-4 relative + 1e-3 (B T
    rows summed in another order)."""
    s, b, t, c, pool = BWD_CARD[shape]
    dt = getattr(torch, dtype)
    args = [a.to(cuda) for a in _bwd_case(4, s, b, t, c, pool, dt)]
    kernel = conv_stem_train.BWD_KERNELS[dt]
    with torch.no_grad():
        before = kernel.launches
        dy, dg, db = conv_stem_train.stem_tail_bwd(*args, P, pool)
        assert kernel.launches == before + 1
        want = conv_stem_train.stem_tail_bwd_plain(*args, P, pool)
    torch.cuda.synchronize()
    _, row_tiles = conv_stem_train.bwd_plan((s, b, t, c), pool)
    assert dy.shape == (s, b, t, c) and dg.shape == db.shape == (s, b * row_tiles, c)
    torch.testing.assert_close(dy, want[0], rtol=0, atol=1e-5)
    assert not dy[:, :, (t // pool) * pool:].any()
    for g, w in zip((dg, db), want[1:]):
        torch.testing.assert_close(g.sum(1), w.sum(1), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(HEAD_SHAPES))
def test_head_kernel_matches_plain_on_card(cuda, shape, dtype):
    """Row 17: one launch of the dtype's form; logits in the embeddings'
    dtype within 1e-4 of the plain version's (bf16: plus ``BF16_RTOL`` of
    the value); fp32 also within 1e-5 of the largest |logit| of fp64."""
    b, f, heads, hidden = HEAD_SHAPES[shape]
    dt = getattr(torch, dtype)
    xs, weights = (list(map(torch.from_numpy, a)) for a in _head_case(12, b, f, heads, hidden))
    xd, wd = [t.to(cuda, dt) for t in xs], [t.to(cuda, dt) for t in weights]
    kernel = fusion_head.KERNELS[dt]
    with torch.no_grad():
        before = kernel.launches
        got = fusion_head.fusion_head(*xd, *wd, num_heads=heads)
        assert kernel.launches == before + 1
        want = fusion_head.fusion_head_plain(*xd, *wd, num_heads=heads)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == (b, 2)
        torch.testing.assert_close(g.float(), w.float(), rtol=BF16_RTOL if dt == BF16 else 0.0,
                                   atol=1e-4)
    if dt == torch.float32:
        ref = _fp64_logits([t.double() for t in xd], [t.double() for t in wd], heads)
        scale = max(r.abs().max().item() for r in ref)
        err = max((g.double() - r).abs().max().item() for g, r in zip(got, ref))
        assert err <= FP64_REL * scale

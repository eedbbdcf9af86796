"""Row 13, the supervised InfoNCE forward on the tensor cores
(``csrc/infonce.cu::infonce_tile_kernel``), emulated on the CPU.

The kernel cannot run here, so this file writes its arithmetic out in
torch: the features in chunks of 128 bytes (32 fp32 or 64 bf16 of each
row); in fp32 each chunk's products as three TF32 passes (the high word
rounded to TF32, to nearest with ties away, the low word ``v - hi``
truncated, as the tensor cores read an operand's upper 19 bits; the
tensor cores' own sum of a chunk taken in fp64 and rounded to fp32,
``tests/torch_flash_emulation.py``), in bf16 the exact products of a chunk
summed the same way; the chunks added in fp32; then each 64-key tile's two
halves of 32 keys folded into two sets of running row statistics in fp32
(the row max, sum e and sum e * pos, rescaled by exp(m_old - m_new)),
merged at the end, with each group of problems reading one row of labels
and validity and one temperature.

- The emulation against the plain version, at B in {12, 37, 64, 512}
  (one key tile and a ragged one, one exactly, eight), D in {19, 48, 256}
  (a partial chunk, one and a half, eight), rows with no positive (a label
  that occurs once), a wrap-padded model (its last rows invalid), two models
  of G = 3 problems sharing their rows, and a per-problem case (each problem
  its own labels, validity and temperature): within 1e-5 of each loss's
  magnitude (at least 1), fp32 sums in other orders.
- The emulation against the JAX package's ``_infonce_core`` (Pallas in
  interpret mode off the TPU, JAX ``contrastive.py:102``) and, for the
  whole loss, ``fused_supervised_infonce``, at the same bar.
- The fp64 bar ``chip_smoke.py`` holds the kernel to, 1e-5 of each loss
  (``INFONCE_FP64_REL``), at temperature 0.01 and the LOSO step's shape:
  three passes meet it, one TF32 pass misses it, so the bar tells the two
  apart.
- The wrapper: shared rows against repeated ones on the CPU, its
  refusals, the shared memory it plans.

The ``gpu``-marked tests hold the kernel to fp64 (1e-5 of each loss) and
to the plain version (1e-4) in fp32 and bf16 at B in {37, 64, 512}, and
shared rows to per-problem rows bit for bit. They skip without a card and
import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_port_infonce_tc.py``.
"""

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu_torch.kernels import contrastive
from torch_flash_emulation import product, tf32
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BF16 = torch.bfloat16
FP64_REL = 1e-5  # chip_smoke.py's INFONCE_FP64_REL: of each loss
PLAIN_REL = 1e-5  # emulation against the plain version: of each loss, at least 1
TILE = 64  # kKeys in csrc/infonce.cu
CHUNK_BYTES = 128  # kChunkBytes
EPS = 1e-12


def emulate(n1, n2, labels, valid, temp, passes: int = 3) -> torch.Tensor:
    """``(P,)`` losses of normalised ``n1, n2 (P, B, D)`` (fp32 or bf16) with
    ``labels (Q, B)``, ``valid (Q, B)``, ``temp (Q,)``, Q dividing P, in the
    kernel's order of operations."""
    p, b, d = n1.shape
    group = p // temp.shape[0]
    per = lambda t: t.repeat_interleave(group, 0)
    labels, valid, temp = per(labels), per(valid).float(), per(temp).float()
    chunk = CHUNK_BYTES // n1.element_size()
    acc = torch.zeros(p, b, b)
    for c0 in range(0, d, chunk):
        a, k = n1[..., c0:c0 + chunk], n2[..., c0:c0 + chunk].transpose(1, 2)
        if n1.dtype == BF16:  # exact products, the chunk's sum rounded once
            part = (a.double() @ k.double()).float()
        else:
            part = product(a, k, passes)
        acc = acc + part
    rows = torch.arange(b)
    # each 64-key tile's two halves of 32 keys go to two warps, which keep
    # running statistics of their own and merge them at the end
    m = torch.full((2, p, b), -torch.inf)
    sum_e, sum_pos = torch.zeros(2, p, b), torch.zeros(2, p, b)
    for j0 in range(0, b, TILE):
        for kh in range(2):
            cols = slice(j0 + 32 * kh, min(j0 + 32 * kh + 32, b))
            if cols.start >= b:
                continue  # no real key in this half yet: its statistics stay
            vj = valid[:, None, cols]
            s = torch.where(vj > 0, acc[..., cols] / temp[:, None, None], torch.tensor(-1e30))
            mx = torch.maximum(m[kh], s.amax(-1))
            alpha = torch.exp(m[kh] - mx)
            e = torch.exp(s - mx[..., None])
            pos = ((labels[:, :, None] == labels[:, None, cols])
                   & (rows[:, None] != rows[None, cols])).float() * (valid[:, :, None] * vj)
            sum_e[kh] = sum_e[kh] * alpha + e.sum(-1)
            sum_pos[kh] = sum_pos[kh] * alpha + (e * pos).sum(-1)
            m[kh] = mx
    mm = torch.maximum(m[0], m[1])  # half 0 holds key 0: finite
    a0, a1 = torch.exp(m[0] - mm), torch.exp(m[1] - mm)
    sum_e, sum_pos = sum_e[0] * a0 + sum_e[1] * a1, sum_pos[0] * a0 + sum_pos[1] * a1
    row_loss = -torch.log((sum_pos + EPS) / (sum_e + EPS)) * valid
    return row_loss.sum(-1) / valid.sum(-1).clamp_min(1.0)


def make_case(seed, models, g, b, d, temps=(0.05, 0.1, 0.2), dtype=torch.float32):
    """Two independent sets of normalised features ``n1, n2 (P, B, D)`` of
    ``models`` x ``g`` problems and each model's ``labels (models, B)``,
    ``valid`` and ``temp``: label 7 occurs once (its row has no positive),
    the last model is wrap-padded (its last third of rows invalid). With
    ``n1`` as ``n2`` (the model's own call) a row's diagonal similarity, 1
    / temp, outweighs the rest at temperature 0.01 and every loss sits at
    -log(1e-12) whatever the products; independent sets keep the loss
    sensitive to them."""
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(2, models * g, b, d)).astype(np.float32))
    n1, n2 = torch.nn.functional.normalize(feats, dim=-1, eps=EPS).to(dtype)
    labels = torch.from_numpy(rng.integers(0, 3, (models, b)))
    labels[:, 0] = 7
    valid = torch.ones(models, b)
    valid[-1, b - b // 3:] = 0.0
    temp = torch.tensor([temps[i % len(temps)] for i in range(models)], dtype=torch.float32)
    return n1, n2, labels, valid, temp


# name: (models, G, B, D, dtype); G = 1 is the per-problem case
CASES = {
    "b12 d19 groups": (2, 3, 12, 19, torch.float32),
    "b37 d48 groups": (2, 3, 37, 48, torch.float32),
    "b64 d256 groups": (2, 3, 64, 256, torch.float32),
    "b512 d48 groups": (2, 3, 512, 48, torch.float32),
    "b37 d48 per problem": (3, 1, 37, 48, torch.float32),
    "b37 d48 bf16 groups": (2, 3, 37, 48, BF16),
    "b512 d256 bf16 groups": (2, 3, 512, 256, BF16),
    "b12 d19 bf16 per problem": (3, 1, 12, 19, BF16),
}


def _close(got, ref, rel):
    bar = rel * ref.abs().clamp_min(1.0)
    assert ((got.double() - ref.double()).abs() <= bar).all(), (got, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_matches_plain(case):
    """The kernel's arithmetic against :func:`contrastive.infonce_plain` on
    the same shared rows (through :func:`contrastive.infonce` on the CPU)."""
    models, g, b, d, dtype = CASES[case]
    n1, n2, labels, valid, temp = make_case(1, models, g, b, d, dtype=dtype)
    for a, b_ in ((n1, n2), (n1, n1)):  # two views, and the model's own call
        got = emulate(a, b_, labels, valid, temp)
        want = contrastive.infonce(a, b_, labels, valid, temp)
        assert got.shape == want.shape == (models * g,)
        _close(got, want, PLAIN_REL)


@pytest.mark.parametrize("case", ["b12 d19 groups", "b37 d48 groups", "b37 d48 bf16 groups",
                                  "b37 d48 per problem"])
def test_emulation_matches_jax(case):
    """Each problem's loss against the JAX ``_infonce_core`` (Pallas,
    interpret mode) on the same normalised features; the first model's
    problems also through the JAX entry point ``fused_supervised_infonce``
    from the features before normalisation."""
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.kernels import contrastive as jc

    models, g, b, d, dtype = CASES[case]
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(2, models * g, b, d)).astype(np.float32)
    n1, n2 = torch.nn.functional.normalize(torch.from_numpy(raw), dim=-1, eps=EPS).to(dtype)
    *_, labels, valid, temp = make_case(2, models, g, b, d)
    got = emulate(n1, n2, labels, valid, temp)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    for p in range(models * g):
        q = p // g
        j1, j2 = (jnp.asarray(n[p].float().numpy()).astype(jdt) for n in (n1, n2))
        ref = jc._infonce_core(j1, j2, jnp.asarray(labels[q].numpy()),
                               jnp.asarray(valid[q].numpy()), jnp.float32(float(temp[q])))
        _close(got[p:p + 1], torch.tensor([float(ref)]), PLAIN_REL)
        if q == 0 and dtype == torch.float32:
            whole = jc.fused_supervised_infonce(jnp.asarray(raw[0, p]), jnp.asarray(raw[1, p]),
                                                jnp.asarray(labels[q].numpy()), temp[q].item(),
                                                jnp.asarray(valid[q].numpy()))
            _close(got[p:p + 1], torch.tensor([float(whole)]), PLAIN_REL)


@pytest.mark.parametrize("shape", [(24, 64, 256), (2, 512, 256)])
def test_one_pass_misses_the_fp64_bar(shape):
    """At temperature 0.01 (the model's) three TF32 passes stay within
    FP64_REL of each fp64 loss and one pass does not: the bar chip_smoke.py
    holds the kernel to tells the two apart, at the LOSO step's shape (24
    models of 3 problems) and at B = 512."""
    models, b, d = shape
    n1, n2, labels, valid, temp = make_case(3, models, 3, b, d, temps=(0.01,))
    ref = contrastive.infonce(n1.double(), n2.double(), labels, valid.double(), temp.double())
    three, one = (emulate(n1, n2, labels, valid, temp, passes) for passes in (3, 1))
    worst = lambda got: ((got.double() - ref).abs() / ref.abs()).max().item()
    assert worst(three) <= FP64_REL < worst(one), (worst(three), worst(one))
    assert worst(contrastive.infonce(n1, n2, labels, valid, temp)) <= FP64_REL
    # one pass is what the TF32-rounded operands give, summed exactly
    exact_one = contrastive.infonce(tf32(n1).double(), tf32(n2).double(), labels,
                                    valid.double(), temp.double())
    assert worst(exact_one) > FP64_REL


def test_shared_rows_equal_repeated_rows():
    """On the CPU, rows shared by G problems give what the rows repeated
    per problem give, values and the order of problems."""
    n1, n2, labels, valid, temp = make_case(4, 3, 3, 20, 16)
    shared = contrastive.infonce(n1, n2, labels, valid, temp)
    per = lambda t: t.repeat_interleave(3, 0)
    torch.testing.assert_close(shared, contrastive.infonce(n1, n2, per(labels), per(valid),
                                                           per(temp)), rtol=0, atol=0)
    torch.testing.assert_close(shared, contrastive.infonce_plain(n1, n2, per(labels), per(valid),
                                                                 per(temp)), rtol=0, atol=0)


REFUSALS = {
    "rows not dividing the problems": lambda n, l, v, t: (n, n, l[:2], v[:2], t[:2]),
    "labels and temperature disagree": lambda n, l, v, t: (n, n, l, v, t[:1]),
    "scalar temperature": lambda n, l, v, t: (n, n, l, v, t[0]),
    "labels of one row, 1-D": lambda n, l, v, t: (n, n, l[0], v, t),
    "features not 3-D": lambda n, l, v, t: (n[0], n[0], l, v, t),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_infonce_refusals(case):
    """Rows that do not divide the problems raise before any arithmetic, on
    the CPU as on the card."""
    n, _, labels, valid, temp = make_case(5, 3, 3, 10, 8)
    with pytest.raises(ValueError):
        contrastive.infonce(*REFUSALS[case](n, labels, valid, temp))


@pytest.mark.parametrize("d, dtype, smem", [
    (256, torch.float32, (8 + 4) * 64 * 144 + 4 * 64 * 12),
    (256, BF16, (4 + 4) * 64 * 144 + 4 * 64 * 12),
    (19, torch.float32, (1 + 4) * 64 * 144 + 4 * 64 * 12),
    (640, torch.float32, (20 + 4) * 64 * 144 + 4 * 64 * 12),
    (1280, BF16, (20 + 4) * 64 * 144 + 4 * 64 * 12),
])
def test_plan_smem(d, dtype, smem):
    """The query tile whole, the 4-deep ring and four tiles' labels and
    validity, in 144-byte rows of 128-byte chunks; no term in B."""
    assert contrastive.plan_smem(d, dtype) == smem <= 227 * 1024


@pytest.mark.parametrize("d, dtype", [(641, torch.float32), (1281, BF16)])
def test_plan_smem_refuses_wide_features(d, dtype):
    with pytest.raises(ValueError):
        contrastive.plan_smem(d, dtype)


# --------------------------------------------------------------------------
# card: the kernel against fp64 and the plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# (models, G, B, D): the LOSO step, its B = 512 form, and ragged B and D
CARD_SHAPES = {"loso_step": (24, 3, 64, 256), "b512": (24, 3, 512, 256), "ragged": (2, 3, 37, 19)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_matches_fp64_and_plain(cuda, shape, dtype):
    """One launch over shared rows at temperature 0.01: within FP64_REL of
    each fp64 loss and 1e-4 of the plain version; the same rows repeated
    per problem give the same losses bit for bit."""
    models, g, b, d = CARD_SHAPES[shape]
    dt = BF16 if dtype == "bf16" else torch.float32
    n1, n2, labels, valid, temp = (t.to(cuda)
                                   for t in make_case(6, models, g, b, d, (0.01,), dt))
    before = contrastive.KERNELS[dt].launches
    got = contrastive.infonce(n1, n2, labels, valid, temp)
    assert contrastive.KERNELS[dt].launches == before + 1
    per = lambda t: t.repeat_interleave(g, 0)
    repeated = contrastive.infonce(n1, n2, per(labels), per(valid), per(temp))
    ref = contrastive.infonce_plain(n1.double(), n2.double(), per(labels), per(valid).double(),
                                    per(temp).double())
    plain = contrastive.infonce_plain(n1, n2, per(labels), per(valid), per(temp))
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, repeated)
    assert ((got.double() - ref).abs() <= FP64_REL * ref.abs()).all()
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4)

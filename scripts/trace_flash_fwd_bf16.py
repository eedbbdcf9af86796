"""Where the bf16 flash forward's time goes, phase by phase, on one CUDA card.

Copies the port of ``--root`` (default: this checkout) into
``build/trace_flash_fwd/`` with ``csrc/flash_attn_bf16.cu`` patched to
read ``clock64()`` at the edges of each phase of one warp's walk over the
key tiles (thread 0 of each CTA; the sums go to device counters once a
CTA), builds it, runs the forward ten times at the attention phase's (BH
512, T 585, D 32) in bf16 at the default tiles and prints the cycles a CTA
spends in each phase, and per key tile.

- the ``mma.sync`` body (the parent of the wgmma one): ``wait`` (the ``cp.async`` ring's wait and
  the block barrier), ``issue`` (the next tile's copies), ``S`` (Q Kᵀ),
  ``max`` (the mask, the row max and its shuffles, the rescale factors),
  ``exp`` (P and its row sums), ``rescale`` (the O accumulator) and ``PV``;
- the ``wgmma`` body (thread 0 of the CTA, its first consumer warpgroup's
  items): ``wait`` (for a stage the producer has not filled), ``issue S``
  (the next sub-tile's S), ``softmax`` (the mask, the max, the exps, the row
  sums and the rescale of O), ``pack`` (P to bf16 and the fences), ``PV``
  (issuing P V) and ``retire`` (the wait for all of it); per item and per
  64-key sub-tile.

An ``mma.sync`` result is waited for where it is first read, so part of
``S`` shows under ``max``: read the split, not the sum, against
``scripts/bench_flash_bwd.py --dtype bf16``'s ``fwd_ms``.

    python3 scripts/trace_flash_fwd_bf16.py [--root DIR]
"""

import argparse
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "trace_flash_fwd"
HEAD = """__device__ unsigned long long g_trace[10];
extern "C" int msa_trace_read(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
    const unsigned long long zero[10] = {};
    cudaMemcpyToSymbol(g_trace, zero, sizeof(g_trace));
    return e;
}
namespace {
"""
STAMP = "        c1 = clock64(); tr[{}] += c1 - c0; c0 = c1;\n"
RESCALE = ("#pragma unroll\n        for (int nd = 0; nd < kDSteps; ++nd)\n#pragma unroll\n"
           "            for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];\n")

# the mma.sync body: (phase names, patches)
MMA_SYNC = (("wait", "issue", "S", "max", "exp", "rescale", "PV"), [
    ("namespace {\n\nusing bf16", HEAD + "\nusing bf16"),
    ("    float acc[kDSteps][4] = {};           // O of rows r0, r0 + 8, as C fragments\n",
     "    float acc[kDSteps][4] = {};           // O of rows r0, r0 + 8, as C fragments\n"
     "    long long tr[8] = {}, c0 = 0, c1;\n"),
    ("        cp_async_wait<kStages - 2>();  // key tile kt has landed (this thread's copies)\n",
     "        c0 = clock64();\n"
     "        cp_async_wait<kStages - 2>();  // key tile kt has landed (this thread's copies)\n"),
    ("        const int next = kt + kStages - 1;\n",
     STAMP.format(0) + "        const int next = kt + kStages - 1;\n"),
    ("        const bf16* ks = ring + (kt % kStages) * Tile::kStage;\n",
     STAMP.format(1) + "        const bf16* ks = ring + (kt % kStages) * Tile::kStage;\n"),
    ("        const int j0 = kt * kBk;\n", STAMP.format(2) + "        const int j0 = kt * kBk;\n"),
    ("        // P = exp(S - m) = 2^(S log2 e - m log2 e) in fp32, summed into l\n",
     STAMP.format(3) + "        // P = exp(S - m) = 2^(S log2 e - m log2 e) in fp32, summed into l\n"),
    (RESCALE, STAMP.format(4) + RESCALE + STAMP.format(5)),
    ("        }\n    }\n    cp_async_wait<0>();  // no copy outlives the block\n",
     "        }\n" + STAMP.format(6) + "    }\n    cp_async_wait<0>();  // no copy outlives the block\n"),
    ("    store_rows(o + static_cast<size_t>(bh) * tq * D, acc, tq, q0, r0, t, inv);\n}\n",
     "    store_rows(o + static_cast<size_t>(bh) * tq * D, acc, tq, q0, r0, t, inv);\n"
     "    if (threadIdx.x == 0) {\n"
     "        for (int e = 0; e < 7; ++e) atomicAdd(&g_trace[e], static_cast<unsigned long long>(tr[e]));\n"
     "        atomicAdd(&g_trace[8], 1ull);\n"
     "        atomicAdd(&g_trace[9], static_cast<unsigned long long>(nk));\n"
     "    }\n}\n"),
])


# the wgmma body (a consumer warpgroup's walk, thread 0 of the CTA): the sums
# go to the counters once an item, with the item's sub-tiles
QSTAMP = "        {} = clock64();\n"
WGMMA = (("wait", "issue S", "softmax", "pack", "PV", "retire"), [
    ("namespace {\n\nusing namespace flash_sm90;", HEAD + "\nusing namespace flash_sm90;"),
    ("    float mrow[2], lrow[2];                 // their running max, this thread's share of l\n",
     "    float mrow[2], lrow[2];                 // their running max, this thread's share of l\n"
     "    long long tr[8] = {};\n"),
    ("        if constexpr (kNext) {\n            const int tile = it0 + (i + 1) / kSpt;\n"
     "            if ((i + 1) % kSpt == 0) sm90::mbar_wait(m.full + tile % kStages, (tile / kStages) & 1);\n"
     "            issue(i + 1, sn);\n        }\n",
     "        long long c0 = clock64(), c1 = c0, c2 = c0;\n"
     "        if constexpr (kNext) {\n            const int tile = it0 + (i + 1) / kSpt;\n"
     "            if ((i + 1) % kSpt == 0) sm90::mbar_wait(m.full + tile % kStages, (tile / kStages) & 1);\n"
     "            c1 = clock64();\n            issue(i + 1, sn);\n            c2 = clock64();\n        }\n"
     "        tr[0] += c1 - c0;\n        tr[1] += c2 - c1;\n"),
    ("        softmax_pv<!kNext>(i, s);\n        sm90::wgmma_wait<0>();\n",
     "        softmax_pv<!kNext>(i, s);\n        const long long c3 = clock64();\n"
     "        sm90::wgmma_wait<0>();\n        tr[5] += clock64() - c3;\n"),
    ("        const int t = lane % 4;\n        if constexpr (kEdge) {",
     "        const long long q0 = clock64();\n        const int t = lane % 4;\n        if constexpr (kEdge) {"),
    ("        acc_as_a(s, pa);\n        sm90::fence_regs(pa);\n        sm90::fence_regs(acc);\n"
     "        sm90::wgmma_fence();\n",
     "        const long long q1 = clock64();\n        acc_as_a(s, pa);\n        sm90::fence_regs(pa);\n"
     "        sm90::fence_regs(acc);\n        sm90::wgmma_fence();\n        const long long q2 = clock64();\n"),
    ("        for (int kk = 0; kk < N / 16; ++kk) rs_product<D>(acc, pa[kk], v, kBk, row + 16 * kk);\n"
     "        sm90::wgmma_commit();\n",
     "        for (int kk = 0; kk < N / 16; ++kk) rs_product<D>(acc, pa[kk], v, kBk, row + 16 * kk);\n"
     "        sm90::wgmma_commit();\n        const long long q3 = clock64();\n"
     "        tr[2] += q1 - q0;\n        tr[3] += q2 - q1;\n        tr[4] += q3 - q2;\n"),
    ("        c.run(nsub);\n",
     "        c.run(nsub);\n        if (threadIdx.x == 0) {\n"
     "            for (int e = 0; e < 6; ++e) atomicAdd(&g_trace[e], static_cast<unsigned long long>(c.tr[e]));\n"
     "            atomicAdd(&g_trace[8], 1ull);\n"
     "            atomicAdd(&g_trace[9], static_cast<unsigned long long>(nsub));\n        }\n"
     "        for (int e = 0; e < 8; ++e) c.tr[e] = 0;\n"),
])


def patched(src: str) -> tuple[str, tuple]:
    """The kernel source with per-phase counters, and its phase names."""
    names, patches = MMA_SYNC if "mma.sync.aligned.m16n8k16" in src else WGMMA
    for a, b in patches:
        if src.count(a) != 1:
            raise SystemExit(f"trace_flash_fwd_bf16: no single patch point for {a[:60]!r}")
        src = src.replace(a, b)
    return src, names


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    args = parser.parse_args()
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(pathlib.Path(args.root) / "multimodal_sentiment_aanalysis_tpu_torch",
                    COPY / "multimodal_sentiment_aanalysis_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    kernel = COPY / "multimodal_sentiment_aanalysis_tpu_torch" / "csrc" / "flash_attn_bf16.cu"
    src, names = patched(kernel.read_text())
    kernel.write_text(src)
    sys.path.insert(0, str(COPY))
    import ctypes

    import torch

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import _build, attention

    if not torch.cuda.is_available():
        print("trace_flash_fwd_bf16: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lib = ctypes.CDLL(str(_build.build("flash_attn_bf16")))
    counts = (ctypes.c_ulonglong * 10)()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(512, 585, 32, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    q = attention.scale_q(q)
    for calls in (3, 10):  # warm-up, then the counted calls
        lib.msa_trace_read(counts)
        for _ in range(calls):
            attention.flash_fwd(q, k, v)
        torch.cuda.synchronize()
    lib.msa_trace_read(counts)
    units, parts = counts[8], counts[9]
    unit, part = ("CTA", "tile") if "S" in names else ("item", "sub-tile")
    print(f"fwd: {units // 10} {unit}s a call, {parts / units:.1f} {part}s a {unit}; cycles a "
          f"{unit}: " + ", ".join(f"{p} {counts[e] / units:.0f}" for e, p in enumerate(names))
          + f"; a {part}: " + ", ".join(f"{p} {counts[e] / parts:.0f}"
                                         for e, p in enumerate(names)))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

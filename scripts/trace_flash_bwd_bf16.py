"""Where the bf16 flash backward's time goes, phase by phase, on one CUDA card.

Copies the port into ``build/trace_flash_bwd/`` with ``csrc/flash_bwd_bf16.cu``
patched to read ``clock64()`` around each phase of a consumer warpgroup's
work (thread 0 of each CTA; the sums go to device counters once per work
item), builds it, runs dQ and dK/dV ten times at the attention phase's
(BH 512, T 585, D 32) in bf16 at the default tiles, and prints the cycles
per item and per sub-tile body:

- ``startup``: waiting for the item's first stage and its first S / dP;
- ``wait_full``: waiting for a stage the producer has not filled yet;
- ``issue_S``: issuing the next sub-tile's S and dP;
- ``exp/dS``, ``pack+fences``, ``wgmma.fence``, ``rs``: the sub-tile's
  exp and dS arithmetic, its packing into A fragments, the fence and the
  issue of the accumulating products;
- ``wait0``: what is left of the wait for all of them.

The counters cost a little time themselves, so read the split, not the sum,
against ``scripts/bench_flash_bwd.py``'s times.

    python3 scripts/trace_flash_bwd_bf16.py
"""

import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "trace_flash_bwd"
PHASES = ("startup", "wait_full", "issue_S", "exp/dS", "pack+fences", "wgmma.fence", "rs",
          "wait0")


def patched(src: str) -> str:
    """The kernel source with per-phase counters."""

    def sub(a: str, b: str) -> None:
        nonlocal src
        if src.count(a) != 1:
            raise SystemExit(f"trace_flash_bwd_bf16: no single patch point for {a[:60]!r}")
        src = src.replace(a, b)

    sub("namespace {\n\nusing bf16 = __nv_bfloat16;", """__device__ unsigned long long g_trace[2][10];
extern "C" int msa_trace_read(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
    const unsigned long long zero[20] = {};
    cudaMemcpyToSymbol(g_trace, zero, sizeof(g_trace));
    return e;
}
namespace {

using bf16 = __nv_bfloat16;""")
    for op, member in (("DqOp", "    int tk, t;\n"), ("DkvOp", "    int tq, t;\n")):
        sub(member, member + "    static constexpr int kTrace = %d;\n"
            "    unsigned long long tr[8] = {};  // PHASES\n" % (op == "DkvOp"))
    sub("""        if constexpr (kNext) {
            const int tile = it0 + (i + 1) / kSpt;
            if ((i + 1) % kSpt == 0) sm90::mbar_wait(m.full + tile % kStages, (tile / kStages) & 1);
            issue(i + 1, sn, pn);
        }""", """        long long c0 = clock64(), c1 = c0, c2 = c0;
        if constexpr (kNext) {
            const int tile = it0 + (i + 1) / kSpt;
            if ((i + 1) % kSpt == 0) sm90::mbar_wait(m.full + tile % kStages, (tile / kStages) & 1);
            c1 = clock64();
            issue(i + 1, sn, pn);
            c2 = clock64();
        }
        op.tr[1] += c1 - c0;
        op.tr[2] += c2 - c1;""")
    sub("""        sm90::wgmma_wait<0>();
        op.retired();""", """        long long c3 = clock64();
        sm90::wgmma_wait<0>();
        op.retired();
        op.tr[7] += clock64() - c3;""")
    sub("""        float s0[kRegs], p0[kRegs], s1[kRegs], p1[kRegs];
        sm90::mbar_wait(m.full + it0 % kStages, (it0 / kStages) & 1);""", """        float s0[kRegs], p0[kRegs], s1[kRegs], p1[kRegs];
        const long long a0 = clock64();
        sm90::mbar_wait(m.full + it0 % kStages, (it0 / kStages) & 1);""")
    sub("""        sm90::fence_regs(p0);
        int i = 0;""", """        sm90::fence_regs(p0);
        op.tr[0] += clock64() - a0;
        int i = 0;""")
    sub("""        } else {
            body<false>(i, s0, p0, s1, p1);
        }
    }""", """        } else {
            body<false>(i, s0, p0, s1, p1);
        }
        if (threadIdx.x == 0) {
            for (int e = 0; e < 8; ++e) atomicAdd(&g_trace[Op::kTrace][e], op.tr[e]);
            atomicAdd(&g_trace[Op::kTrace][8], 1ull);
            atomicAdd(&g_trace[Op::kTrace][9], static_cast<unsigned long long>(nsub));
        }
        for (int e = 0; e < 8; ++e) op.tr[e] = 0;
    }""")
    for first, mid, last in (
            ("        const int keys = tk - i * kSub - 2 * t;", """            p[r] = pr * (p[r] - dl[h]);
        }
        acc_as_a(p, da);""", """            rs_product<D>(acc, da[kk], stage, kBk, row + 16 * kk);
        sm90::wgmma_commit();"""),
            ("        const int queries = tq - i * kSub - 2 * t;", """        acc_as_a(s, pa);""",
             """            rs_product<D>(dka, sa[kk], stage, kBq, row + 16 * kk);
        }
        sm90::wgmma_commit();""")):
        sub(first, "        const long long q0 = clock64();\n" + first)
        sub(mid, mid.replace("        acc_as_a(", "        const long long q1 = clock64();\n"
                             "        acc_as_a(", 1))
        sub(last, last + """
        const long long q4 = clock64();
        tr[3] += q1 - q0;
        tr[4] += q2 - q1;
        tr[5] += q3 - q2;
        tr[6] += q4 - q3;""")
    sub("""        sm90::fence_regs(da);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();""", """        sm90::fence_regs(da);
        sm90::fence_regs(acc);
        const long long q2 = clock64();
        sm90::wgmma_fence();
        const long long q3 = clock64();""")
    sub("""        sm90::fence_regs(dka);
        sm90::fence_regs(dva);
        sm90::wgmma_fence();""", """        sm90::fence_regs(dka);
        sm90::fence_regs(dva);
        const long long q2 = clock64();
        sm90::wgmma_fence();
        const long long q3 = clock64();""")
    return src


def main() -> int:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "multimodal_sentiment_aanalysis_tpu_torch",
                    COPY / "multimodal_sentiment_aanalysis_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    kernel = COPY / "multimodal_sentiment_aanalysis_tpu_torch" / "csrc" / "flash_bwd_bf16.cu"
    kernel.write_text(patched(kernel.read_text()))
    sys.path.insert(0, str(COPY))
    import ctypes

    import torch

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import _build, attention

    if not torch.cuda.is_available():
        print("trace_flash_bwd_bf16: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lib = ctypes.CDLL(str(_build.build("flash_bwd_bf16")))
    counts = (ctypes.c_ulonglong * 20)()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(512, 585, 32, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    q = attention.scale_q(q)
    o, lse = attention.flash_fwd(q, k, v)
    args = (q, k, v, do, lse, attention.flash_delta(do, o))
    for calls in (3, 10):  # warm-up, then the counted calls
        lib.msa_trace_read(counts)
        for _ in range(calls):
            attention.flash_bwd_dq(*args)
            attention.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
    lib.msa_trace_read(counts)
    for name, row in (("dq", counts[0:10]), ("dkv", counts[10:20])):
        items, bodies = row[8], row[9]
        print(f"{name}: {items} items, {bodies / items:.1f} sub-tiles an item; cycles an item: "
              + ", ".join(f"{p} {row[e] / items:.0f}" for e, p in enumerate(PHASES))
              + "; a sub-tile: "
              + ", ".join(f"{p} {row[e] / bodies:.0f}" for e, p in enumerate(PHASES) if e))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase times of row 17's kernel (``csrc/fusion_head.cu``) on one CUDA
card, from ``clock64()`` stamps inside the kernel.

Builds a copy of ``csrc/fusion_head.cu`` under ``build/`` with a stamp at
each phase boundary (a CTA-wide barrier, then thread 0 of each CTA of the
first cluster records ``clock64()``), launches it at the reference head (F
256, 8 heads, hidden 128, 2 classes) at B=32 in fp32 and bf16, and prints
the SM cycles of each phase for ranks 0 and 5 of the first cluster, with
the card's name, power limit and SM clock. The phases: the embeddings'
staging with the column tables and the ring's prologue; the q | k | v
products and their epilogue; the barrier's wait; the attention and its
pushes; the cluster barrier; the out projection; the mean, its pushes and
the barrier; the shared layer; the logit shares, their pushes and the
barrier; CTA 0's sum. The stamps' barriers add a little to each phase.

    python3 scripts/profile_fusion_head.py

Each stamp sits at a line of the kernel that the script finds by its text;
it stops where a line has moved.
"""

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("staging", "products q|k|v", "wait", "attention + push", "barrier", "out projection",
          "mean + push + barrier", "shared layer", "shares + push + barrier", "CTA 0 sum")


def instrumented(src: str) -> str:
    """The kernel with STAMP(i) at the start of phase i (10 ends the last)."""
    src = src.replace("namespace {\n\nconstexpr int kThreads",
                      "__device__ long long g_clk[8][16];\n"
                      "#define STAMP(i) do { __syncthreads(); if (blockIdx.x < (unsigned)K && "
                      "threadIdx.x == 0) g_clk[r][i] = clock64(); } while (0)\n"
                      "namespace {\n\nconstexpr int kThreads", 1)
    marks = [("    // 1. the tile's embeddings", 0), ("    // 2. q | k | v of the own heads;", 1),
             ("    // 3. per (row, own head)", 2), ("    {\n        const float scale", 3),
             ("    cluster.sync();\n\n    // 4. the out projection", 4),
             ("    // 4. the out projection's own columns", 5),
             ("    for (int idx = threadIdx.x; idx < R * fk; idx += kThreads) {", 6),
             ("    // 5. the own shared units", 7), ("    // 6. the own units' share", 8),
             ("    if (r == 0) {\n        for (int idx", 9)]
    for anchor, i in marks:
        if src.count(anchor) != 1:
            raise SystemExit(f"profile_fusion_head: the kernel line {anchor!r} has moved")
        src = src.replace(anchor, f"    STAMP({i});\n" + anchor)
    end = "        }\n    }\n}\n\n// n8 tiles a warp"
    if src.count(end) != 1:
        raise SystemExit("profile_fusion_head: the kernel's end has moved")
    src = src.replace(end, "        }\n    }\n    STAMP(10);\n}\n\n// n8 tiles a warp")
    return src + ('\nextern "C" int msa_head_clocks(long long* out) '
                  '{ return cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)); }\n')


def main() -> int:
    import torch

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import fusion_head as fh
    from multimodal_sentiment_aanalysis_tpu_torch.kernels._build import (CSRC, NVCC_FLAGS, _nvcc,
                                                                          ptr)

    if not torch.cuda.is_available():
        print("profile_fusion_head: no CUDA device", file=sys.stderr)
        return 1
    work = ROOT / "build" / "profile_fusion_head"
    work.mkdir(parents=True, exist_ok=True)
    (work / "fusion_head_stamped.cu").write_text(instrumented((CSRC / "fusion_head.cu").read_text()))
    lib = work / "fusion_head_stamped.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib),
                           str(work / "fusion_head_stamped.cu")], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout, proc.stderr, file=sys.stderr)
        return 1
    so = ctypes.CDLL(str(lib))
    so.msa_head_clocks.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, device=dev, generator=gen)
    b, f, heads, hidden = 32, 256, 8, 128
    for dtype, name in ((torch.float32, "msa_fusion_head"), (torch.bfloat16, "msa_fusion_head_bf16")):
        fn = getattr(so, name)
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        xs = [randn(b, f).to(dtype) for _ in range(3)]
        ws = [t.to(dtype) for t in (randn(3 * f, f) / 16, randn(3 * f), randn(f, f) / 16, randn(f),
                                    randn(hidden, f) / 16, randn(hidden), randn(2, hidden),
                                    randn(2), randn(2, hidden), randn(2))]
        oa = torch.empty(b, 2, device=dev, dtype=dtype)
        ov = torch.empty_like(oa)
        k, tile = fh.cluster_size(heads), fh.plan(b, f, heads, hidden, 2, dtype)[0]
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(5):  # the last launch's stamps stay
            err = fn(*map(ptr, xs + ws), ptr(oa), ptr(ov), b, tile, f, heads, hidden, 2, k, 0,
                     stream)
            if err:
                print(f"profile_fusion_head: CUDA error {err}", file=sys.stderr)
                return 1
        torch.cuda.synchronize()
        want = fh.fusion_head_plain(*xs, *ws, num_heads=heads)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip((oa, ov), want))
        buf = (ctypes.c_longlong * (8 * 16))()
        so.msa_head_clocks(ctypes.cast(buf, ctypes.c_void_p))
        for rank in (0, 5):
            stamps = buf[rank * 16:rank * 16 + 11]
            cycles = [stamps[i + 1] - stamps[i] for i in range(10)]
            print(f"fusion_head {str(dtype)[6:]} B={b} F={f} tile {tile} rows, cluster {k}, rank "
                  f"{rank}: {stamps[10] - stamps[0]} cycles; "
                  + ", ".join(f"{p} {c}" for p, c in zip(PHASES, cycles))
                  + f" (max |err| against the plain version {err:.2e})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the zero-phase IIR filter's time goes, phase by phase, on one CUDA card.

Copies the port of ``--root`` (default: this checkout) into
``build/trace_iir/`` with ``csrc/iir.cu`` patched to read ``clock64()``
at the edges of each phase of a warp's walk (lane 0 of every warp; the sums
go to device counters once a warp), builds it, runs the fp32 and fp64
forms ten times at the ``dsp`` phase's band-pass (480 x 32 series of 585
samples, the order-4 1-70 Hz band-pass at 256 Hz: 4 sections, padlen 27;
``--order`` another order, so that the chain's share shows)
and prints the cycles a warp spends in each phase and per time step:

- the one-thread-per-series body (the parent of the coalesced design):
  ``forward`` (the odd extension and the series through the cascade, each
  step loading its own sample and storing to the time-major scratch) and
  ``reverse`` (the reverse pass over the scratch, storing ``y``);
- the coalesced body: ``fwd wait`` (waiting for a chunk of ``x`` in the
  shared-memory ring), ``fwd steps`` (the cascade over a chunk, with its
  scratch stores and the copies of a later chunk of ``x``), ``rev wait``
  (waiting for the scratch steps copied back into the ring), ``rev steps``
  (the cascade, with the copies back and the last chunk's ``y`` stores) and
  ``y out`` (the final chunk's ``y`` stores).

The counters cost a little time themselves, so read the split, not the
sum, against ``scripts/bench_iir.py``'s times. ``--define NAME=VALUE``
(repeatable) rewrites ``constexpr int NAME = ...;`` in the copy, to try
another block shape or copy distance (``kWarps``, ``kAhead``); each run
also prints the traced kernel's time (CUDA events, median of 20 calls).

    python3 scripts/trace_iir.py [--root DIR] [--define NAME=VALUE ...]
"""

import argparse
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "trace_iir"
N, T, BAND, FS, ORDER = 15360, 585, (1, 70), 256, 4

HEAD = """__device__ unsigned long long g_trace[2][8];
extern "C" int msa_trace_read(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
    const unsigned long long zero[16] = {};
    cudaMemcpyToSymbol(g_trace, zero, sizeof(g_trace));
    return e;
}
"""
# lane 0 of each warp adds its phases' cycles (e < 6) and one to the warp
# count (slot 7) of its form's row (fp32 0, fp64 1)
FLUSH = """
    if (threadIdx.x % 32 == 0) {
        const int form = sizeof(T) == 8;
        for (int e = 0; e < 6; ++e) atomicAdd(&g_trace[form][e], static_cast<unsigned long long>(tr[e]));
        atomicAdd(&g_trace[form][7], 1ull);
    }
"""

# the one-thread-per-series body: (phase names, patches)
SERIAL = (("forward", "reverse"), [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + HEAD),
    ("    // forward pass: the left extension, the series, the right extension\n",
     "    long long tr[6] = {};\n    const long long c0 = clock64();\n"
     "    // forward pass: the left extension, the series, the right extension\n"),
    ("    // reverse pass from the last forward output; the central T samples out\n",
     "    const long long c1 = clock64();\n    tr[0] = c1 - c0;\n"
     "    // reverse pass from the last forward output; the central T samples out\n"),
    ("        ys[j] = cascade<T, S>(fwd[static_cast<size_t>(j + padlen) * n + s], sos, z0, z1);\n"
     "    }\n}\n",
     "        ys[j] = cascade<T, S>(fwd[static_cast<size_t>(j + padlen) * n + s], sos, z0, z1);\n"
     "    }\n    tr[1] = clock64() - c1;\n" + FLUSH + "}\n"),
])

# the coalesced body (a warp of series, a shared-memory ring of time steps):
# a stamp at the top of each chunk closes the last chunk's steps (or y out)
STAMP = "        c1 = clock64(); tr[{}] += c1 - c0; c0 = c1;\n"
COALESCED = (("fwd wait", "fwd steps", "rev wait", "rev steps", "y out"), [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + HEAD),
    ("    // ---- forward ----\n", "    long long tr[6] = {}, c0 = clock64(), c1;\n"),
    ("        cp_async_wait<kAhead - 1>();  // chunk c has landed (this lane's copies)\n",
     STAMP.format(1) + "        cp_async_wait<kAhead - 1>();  // chunk c has landed (this lane's copies)\n"),
    ("        __syncwarp();                 // (everyone's), and chunk c - 1 is consumed\n",
     "        __syncwarp();                 // (everyone's), and chunk c - 1 is consumed\n"
     + STAMP.format(0)),
    ("    cp_async_wait<0>();\n", STAMP.format(1) + "    cp_async_wait<0>();\n"),
    ("        cp_async_wait<kAhead - 1>();  // chunk c's scratch steps have landed (this lane's)\n",
     STAMP.format(3)
     + "        cp_async_wait<kAhead - 1>();  // chunk c's scratch steps have landed (this lane's)\n"),
    ("        __syncwarp();                 // every lane's chunk c + 1 outputs are in the ring\n",
     "        __syncwarp();                 // every lane's chunk c + 1 outputs are in the ring\n"
     + STAMP.format(2)),
    ("    __syncwarp();  // every lane's last outputs are in the ring\n",
     STAMP.format(3) + "    __syncwarp();  // every lane's last outputs are in the ring\n"),
    ("    store_chunk(bottom);\n}\n", "    store_chunk(bottom);\n" + STAMP.format(4) + FLUSH + "}\n"),
])


def patched(src: str) -> tuple[str, tuple]:
    """The kernel source with per-phase counters, and its phase names."""
    names, patches = SERIAL if "one thread per series" in src.split("#include")[0] else COALESCED
    for a, b in patches:
        if src.count(a) != 1:
            raise SystemExit(f"trace_iir: no single patch point for {a[:60]!r}")
        src = src.replace(a, b)
    return src, names


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--define", action="append", default=[], metavar="NAME=VALUE")
    parser.add_argument("--order", type=int, default=ORDER,
                        help="the band-pass's order: its number of sections (1 to 8)")
    args = parser.parse_args()
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(pathlib.Path(args.root) / "multimodal_sentiment_aanalysis_tpu_torch",
                    COPY / "multimodal_sentiment_aanalysis_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    kernel = COPY / "multimodal_sentiment_aanalysis_tpu_torch" / "csrc" / "iir.cu"
    src, names = patched(kernel.read_text())
    for define in args.define:
        name, value = define.split("=")
        src, hits = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if hits != 1:
            raise SystemExit(f"trace_iir: no single constexpr int {name}")
    kernel.write_text(src)
    sys.path.insert(0, str(COPY))
    import ctypes

    import torch
    from scipy import signal

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import _build, iir

    if not torch.cuda.is_available():
        print("trace_iir: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lib = ctypes.CDLL(str(_build.build("iir")))
    counts = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda", 0)
    b, a = signal.butter(args.order, [2 * BAND[0] / FS, 2 * BAND[1] / FS], "bandpass")
    sos, padlen = signal.tf2sos(b, a), 3 * max(len(a), len(b))
    length = T + 2 * padlen
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn(N, T, device=dev, generator=gen)
    for dtype, row in ((torch.float32, 0), (torch.float64, 8)):
        x = x32.to(dtype)
        s_t = torch.as_tensor(sos, dtype=dtype, device=dev)
        z_t = torch.as_tensor(signal.sosfilt_zi(sos), dtype=dtype, device=dev)
        for calls in (3, 10):  # warm-up, then the counted calls
            lib.msa_trace_read(counts)
            for _ in range(calls):
                iir.sos_filtfilt(x, s_t, z_t, padlen)
            torch.cuda.synchronize()
        lib.msa_trace_read(counts)
        warps = counts[row + 7]
        times = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            iir.sos_filtfilt(x, s_t, z_t, padlen)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        steps = (length, length - padlen)
        per = [counts[row + e] / warps for e in range(len(names))]
        print(f"{dtype} order {args.order} {' '.join(args.define)}: {sorted(times)[10]:.4f} ms; "
              f"{warps // 10} warps a call; cycles a warp: "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(names, per))
              + f"; a time step (forward {steps[0]}, reverse {steps[1]}): "
              + ", ".join(f"{p} {c / steps[0 if p.startswith('f') else 1]:.1f}"
                          for p, c in zip(names, per)))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

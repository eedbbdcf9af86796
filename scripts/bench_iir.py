"""Time the zero-phase IIR filter kernel (csrc/iir.cu), fp32 and fp64, on one
CUDA card, and hold it to its plain version.

At the ``dsp`` phase's band-pass (480 x 32 series of 585 samples, order-4
1-70 Hz at 256 Hz: 4 sections, padlen 27), and at the shapes of
``tests/test_torch_port_dsp.py``'s ``KERNEL_SHAPES`` (the 60 Hz notch, an
order-8 band-pass, three series of an order-3 one) and one long recording
(one series of 100,000 samples, order 4), seeded. For each shape and
form: the kernel's time (the median over ``--reps`` CUDA-event pairs, each
around 10 back-to-back calls, as ``chip_smoke.py`` times a kernel), its
bound (x read once and y written once at 3.35 TB/s) and, where the plain
version is quick enough to run (all but the long recording), its largest
error against the plain version over the plain output's largest entry.

    python3 scripts/bench_iir.py [--root DIR] [--label NAME] [--reps N]

``--root`` is the checkout whose port is imported (default: this one), so
that two trees can be compared on one card, in turns; each shape and form
prints as one line.
"""

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name -> (series, length, order, band in Hz, fs); order None: the notch (freq, Q)
SHAPES = {"stack": (15360, 585, 4, (1, 70), 256), "notch": (77, 300, None, (60, 5), 250),
          "order8": (65, 200, 8, (4, 30), 256), "order3": (3, 41, 3, (1, 4), 256),
          "long": (1, 100000, 4, (1, 70), 256)}
PLAIN = ("stack", "notch", "order8", "order3")  # shapes held to the plain version
PEAK_BYTES_PER_S = 3.35e12


def time_ms(fn, reps: int, calls: int = 10) -> float:
    """The median over ``reps`` of one event pair around ``calls``
    back-to-back calls, over ``calls``."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def sections(order, band, fs):
    """scipy's sections, steady-state initial conditions and padlen, as
    ``ops.dsp.filtfilt`` designs them."""
    from scipy import signal

    if order is None:
        b, a = signal.iirnotch(band[0] / (fs / 2), band[1])
    else:
        b, a = signal.butter(order, [2 * band[0] / fs, 2 * band[1] / fs], "bandpass")
    sos = signal.tf2sos(b, a)
    return sos, signal.sosfilt_zi(sos), 3 * max(len(a), len(b))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import iir

    if not torch.cuda.is_available():
        print("bench_iir: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, (n, t, order, band, fs) in SHAPES.items():
            sos, zi, padlen = sections(order, band, fs)
            x32 = torch.randn(n, t, device=dev, generator=gen)
            for dtype in (torch.float32, torch.float64):
                x = x32.to(dtype)
                s_t = torch.as_tensor(sos, dtype=dtype, device=dev)
                z_t = torch.as_tensor(zi, dtype=dtype, device=dev)
                call = lambda: iir.sos_filtfilt(x, s_t, z_t, padlen)  # noqa: E731
                ms = time_ms(call, args.reps)
                nbytes = 2 * x.numel() * x.element_size()
                row = {"shape": name, "n": n, "t": t, "sections": len(sos), "padlen": padlen,
                       "dtype": str(dtype).removeprefix("torch."), "ms": ms,
                       "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
                if name in PLAIN:
                    got, want = call(), iir.sos_filtfilt_plain(x, s_t, z_t, padlen)
                    row["err_of_max"] = ((got.double() - want.double()).abs().max()
                                         / want.double().abs().max()).item()
                    row["bit_equal"] = torch.equal(got, call())
                print(f"{args.label} {name}: " + ", ".join(
                    f"{key} {val:.4f}" if key.endswith("_ms") or key == "ms" else
                    f"{key} {val:.2e}" if key.endswith("_max") else f"{key} {val}"
                    for key, val in row.items()), flush=True)
                torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

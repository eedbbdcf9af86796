"""Time rows 13 and 10 of the port's kernel table (the supervised InfoNCE
forward, ``csrc/infonce.cu``, and v9.1's c checkpoints,
``kernels/lstm.py::bilstm_cbndk``) on one CUDA card, splitting host from
device time.

Row 13 through ``contrastive.infonce`` with per-problem rows (the contract
every tree of the port takes) at P=3 and P=72 with (B, D) = (64, 256), and
at P=72 with (512, 256), fp32 and bf16, on two independent sets of
normalised features at temperature 0.01; and in the LOSO step's form:
``torch.func.vmap`` over 24 models of ``fused_supervised_infonce_multi``
(the normalisation, any copies of the shared rows, the kernels) at
(64, 256), fp32. Row 10 at the flagship layer (B=64, T=73, I=256, H=128),
one model and the LOSO step's 24. Per case:

- the time per call by CUDA events over ``--reps`` back-to-back calls after
  3 warm-up calls, as ``chip_smoke.py`` times a kernel line;
- the wrapper's host time per call (``perf_counter`` over ``--reps`` calls
  with no sync inside);
- under ``torch.profiler``, the device time per call of each device kernel
  the call launches, and the launches per call.

    python3 scripts/bench_infonce.py [--root DIR] [--label NAME] [--reps N]

``--root`` is the checkout whose port is imported (default: this one), so
that two trees can be compared in one run on the card (a ``git archive`` of the
other under ``build/``); the last line is the cases as one JSON object.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def measure(fn, reps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels = {e.key[:80]: round(e.self_device_time_total / reps, 3) for e in device}
    return {"events_ms": events_ms, "host_us": host_us,
            "device_us": sum(e.self_device_time_total for e in device) / reps,
            "launches": sum(e.count for e in device) / reps, "kernels_us": kernels}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import build_all, contrastive, lstm

    if not torch.cuda.is_available():
        print("bench_infonce: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build_all()
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, device=dev, generator=gen)
    out = {}

    def record(case: str, fn) -> None:
        r = measure(fn, args.reps)
        out[case] = r
        top = ", ".join(f"{k} {v:.2f}" for k, v in sorted(r["kernels_us"].items(),
                                                         key=lambda kv: -kv[1]))
        print(f"{args.label}: {case}: {r['events_ms']:.4f} ms by CUDA events; host "
              f"{r['host_us']:.1f} us/call; device {r['device_us']:.2f} us/call over "
              f"{r['launches']:.1f} launches ({top})")

    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for p, b in ((3, 64), (72, 64), (72, 512)):
                n1, n2 = F.normalize(randn(2, p, b, 256), dim=3, eps=1e-12).to(dtype)
                labels = torch.randint(0, 3, (p, b), device=dev, generator=gen)
                valid = torch.ones(p, b, device=dev)
                valid[1::2, b - b // 5:] = 0.0
                temp = torch.full((p,), 0.01, device=dev)
                name = "bf16" if dtype == torch.bfloat16 else "fp32"
                record(f"row 13 {name} P={p} ({b}, 256)",
                       lambda a=(n1, n2, labels, valid, temp): contrastive.infonce(*a))

    # the LOSO step's form: each model's 3 losses sharing its rows, under vmap
    s_n, b = 24, 64
    feats = randn(s_n, 3, b, 256)
    labels = torch.randint(0, 3, (s_n, b), device=dev, generator=gen)
    valid = torch.ones(s_n, b, device=dev)
    valid[1::2, 12:] = 0.0
    temp = torch.full((s_n,), 0.01, device=dev)
    step = torch.func.vmap(lambda f, l, v, t: contrastive.fused_supervised_infonce_multi(
        f, f, l, t, v))
    with torch.no_grad():
        record(f"row 13 fp32 step form, vmap over {s_n} models of 3 losses ({b}, 256)",
               lambda: step(feats, labels, valid, temp))

        for s in (1, 24):
            x = randn(s, 64, 73, 256)
            w_ih, w_hh = 0.06 * randn(s, 2, 512, 256), 0.06 * randn(s, 2, 512, 128)
            bias = 0.1 * randn(s, 2, 512)
            h_seq = lstm.bilstm_fwd(x, w_ih, w_hh, bias)
            record(f"row 10 S={s} (64, 73, 256), H 128",
                   lambda a=(x, h_seq, w_ih, w_hh, bias): lstm.bilstm_cbndk(*a))
    print(json.dumps({"label": args.label, "device": torch.cuda.get_device_name(0),
                      "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

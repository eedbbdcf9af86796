"""Time rows 2 and 3 of the port's kernel table (the EEG stem tail's
forward, ``csrc/stem_tail.cu``, and the serving conv stem,
``csrc/conv_stem.cu``) on one CUDA card, splitting host from device time;
with ``--bwd``, row 12 (the stem tail's backward) and row 17 (the ME-MHACL
fused head, ``csrc/fusion_head.cu``) instead.

Row 2 at its paths' shapes, stage 1 (T=585, C=64, pool 4) and stage 2
(T=146, C=256, pool 2), B=64, fp32 and bf16: the eval form
(``fused_stage_train`` under ``no_grad`` on running statistics, p 0, as the
eval model forward calls it) and the train form (``stem_tail_fwd`` on batch
statistics, writing the code) at one model, and the train form at the LOSO
step's S=24, each at p 0 and 0.4 (the seeds drawn from a generator, as the
trainers draw them). Row 3 at both serving stages. Per case:

- the time per call by CUDA events over ``--reps`` back-to-back calls after
  3 warm-up calls, as ``chip_smoke.py`` times a kernel line;
- the wrapper's host time per call (``perf_counter`` over ``--reps`` calls
  with no sync inside: the rate at which the host issues them);
- the device time per call, under ``torch.profiler``, of the case's kernel
  and of every other launch the call makes.

With ``--stage-profile`` it also profiles one LOSO stem stage as the
vectorized trainer runs it: ``vmap`` over S=24 models of ``grad_and_value``
of a loss through ``models/eeg.py``'s stage (the conv, the NLC transpose,
the batch statistics, ``fused_stage_train`` at p 0.4), for each stage, and
prints the device time by kernel: the stem tail's two kernels beside the
transposes, statistic passes and the backward's BN combine around them.

With ``--bwd`` it times row 12 through ``conv_stem_train.stem_tail_bwd``
at both stages, S=1 and S=24, fp32 and bf16, on the code of a p 0.4
forward, and row 17 through ``fusion_head.fusion_head`` at the ME-MHACL
validation batch (B=32) and a ragged B=37 (F=256, 8 heads, hidden 128),
fp32 and bf16 (a tree whose head has no bf16 form prints the refusal). Each
case's device time is the profiler's for the case's kernel, beside the
bytes bound of row 12 (each input read once, each output written once, at
3.35 TB/s).

With ``--serve`` it times only the serving entry points that reach the
stem instead: the flagship's eval forward (row 2 twice a request) and
``build_serving_forward(use_pallas=True)`` (row 3 twice), at B=64 on
random weights from a seed, ``--windows`` windows of 100 requests each on
the host clock around synchronised runs, as ``chip_smoke.py`` serves.

    python3 scripts/bench_stem.py [--root DIR] [--label NAME] [--reps N] [--stage-profile]
    python3 scripts/bench_stem.py --serve [--root DIR] [--label NAME] [--windows N]
    python3 scripts/bench_stem.py --bwd [--root DIR] [--label NAME] [--reps N]

``--root`` is the checkout whose port is imported (default: this one), so
that two trees can be compared in one session (a ``git archive`` of the
other under ``build/``); the last line is the cases as one JSON object.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def measure(fn, kernel: str, reps: int) -> dict:
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
    kernel_us = sum(e.self_device_time_total for e in device if kernel in e.key) / reps
    other_us = sum(e.self_device_time_total for e in device) / reps - kernel_us
    return {"events_ms": events_ms, "host_us": host_us, "kernel_us": kernel_us,
            "other_us": other_us}


def stage_profile(label: str, dev, gen, models: int = 24, batch: int = 64) -> None:
    """Device time by kernel of one stem stage's forward and backward for
    ``models`` models, as ``VectorizedLOSOTrainer`` runs it (``vmap`` of
    ``grad_and_value``; ``models/eeg.py``'s ``_stage`` body)."""
    import torch
    import torch.nn.functional as F
    from torch.func import grad_and_value, vmap
    from torch.profiler import ProfilerActivity, profile

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem_train

    def stage(w, bias, gamma, beta, h, dpool, pad, pool):
        y = F.conv1d(h.transpose(1, 2), w, bias, padding=pad).transpose(1, 2).contiguous()
        with torch.no_grad():
            mean = y.mean((0, 1))
            var = (y * y).mean((0, 1)) - mean * mean
        out = conv_stem_train.fused_stage_train(y, gamma, beta, mean, var, 0.4, pool)
        return (out * dpool).sum()

    for t, c, o, k, pad, pool in ((585, 32, 64, 15, 7, 4), (146, 64, 256, 5, 2, 2)):
        randn = lambda *shape: torch.randn(shape, device=dev, generator=gen)
        args = (randn(models, o, c, k) / (c * k) ** 0.5, 0.1 * randn(models, o),
                1 + 0.3 * randn(models, o), 0.1 * randn(models, o), randn(models, batch, t, c),
                randn(models, batch, t // pool, o))
        step = vmap(grad_and_value(lambda *a: stage(*a, pad, pool), argnums=(0, 1, 2, 3, 4)),
                    randomness="different")
        for _ in range(3):
            step(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                step(*args)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        total = sum(e.self_device_time_total for e in device) / 10
        print(f"stage {label} S={models} T={t} C={c}->{o} pool {pool}: {total / 1e3:.4f} ms of "
              f"device time a forward + backward")
        for e in sorted(device, key=lambda e: -e.self_device_time_total):
            print(f"stage {label} {e.self_device_time_total / 10 / 1e3:9.4f} ms "
                  f"{e.count // 10:4d}x {e.key[:110]}")


def serve(label: str, dev, windows: int, batch: int = 64, requests: int = 100) -> int:
    """ms per batch of the eval forward and of the fused-stem serving
    forward, each window of ``requests`` batches timed on the host clock
    around a synchronised run; prints every window and the median."""
    import torch

    from multimodal_sentiment_aanalysis_tpu_torch import (MultimodalTransformerModel,
                                                          build_serving_forward)

    gen = torch.Generator().manual_seed(0)
    model = MultimodalTransformerModel(feat_dim=256, device=dev, generator=gen).eval()
    pool = [torch.randn(batch, *shape, generator=gen).to(dev)
            for shape in ((32, 585), (38,), (230,))]
    paths = {"model_forward": model,
             "serving_use_pallas": build_serving_forward(model, use_pallas=True)}
    for name, fwd in paths.items():
        for _ in range(3):
            fwd(*pool)
        times = []
        for _ in range(windows):
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(requests):
                fwd(*pool)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3 / requests)
        print(f"serve {label} {name}: {sorted(times)[len(times) // 2]:.4f} ms/batch median of "
              f"{windows} windows of {requests} x {batch} ("
              + ", ".join(f"{t:.4f}" for t in times) + ")", flush=True)
    return 0


def backward_cases(record, randn, gen) -> None:
    """Row 12 at the LOSO stages (S=1 and 24, fp32 and bf16) on a p 0.4
    forward's code, and row 17 at B=32 and 37 (fp32 and bf16)."""
    import torch

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem_train, fusion_head

    for t, c, pool in ((585, 64, 4), (146, 256, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            for s in (1, 24):
                conv = randn(s, 64, t, c).to(dtype)
                gamma, beta = 1 + 0.3 * randn(s, c), 0.1 * randn(s, c)
                mean = conv.float().mean((1, 2))
                var = (conv.float() ** 2).mean((1, 2)) - mean * mean
                out, code = conv_stem_train.stem_tail_fwd(conv, gamma, beta, mean, var, 0.4, pool,
                                                          generator=gen)
                inv = torch.rsqrt(var + 1e-5)
                args = (conv, randn(*out.shape).to(dtype), code, gamma * inv,
                        beta - mean * gamma * inv, mean, inv, 0.4, pool)
                # the operands and the full-length fp32 dy (the partials aside)
                nbytes = sum(a.numel() * a.element_size() for a in args[:7]) + conv.numel() * 4
                bound_us = nbytes / 3.35e12 * 1e6
                record(f"row12 S={s} {str(dtype)[6:]} pool {pool} {tuple(conv.shape)} "
                       f"(bytes bound {bound_us:.2f} us)",
                       lambda a=args: conv_stem_train.stem_tail_bwd(*a), "stem_tail_bwd")
    for b in (32, 37):
        xs = [randn(b, 256) for _ in range(3)]
        weights = [randn(768, 256) / 16, 0.1 * randn(768), randn(256, 256) / 16, 0.1 * randn(256),
                   randn(128, 256) / 16, 0.1 * randn(128), randn(2, 128) / 11.3, 0.1 * randn(2),
                   randn(2, 128) / 11.3, 0.1 * randn(2)]
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in xs + weights]
            label = f"row17 B={b} F=256 8 heads hidden 128 {str(dtype)[6:]}"
            try:
                fusion_head.fusion_head(*args, num_heads=8)
            except TypeError as err:  # a tree whose head takes fp32 only
                print(f"stem {label}: refused ({err})", flush=True)
                continue
            record(label, lambda a=args: fusion_head.fusion_head(*a, num_heads=8), "fusion_head")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--stage-profile", action="store_true")
    parser.add_argument("--serve", action="store_true")
    parser.add_argument("--bwd", action="store_true")
    parser.add_argument("--windows", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem, conv_stem_train

    if not torch.cuda.is_available():
        print("bench_stem: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, device=dev, generator=gen)
    rows = []
    if args.serve:
        return serve(args.label, dev, args.windows)

    def record(case: str, fn, kernel: str) -> None:
        r = {"case": case, **measure(fn, kernel, args.reps)}
        rows.append(r)
        print(f"stem {args.label} {case}: {r['events_ms']:.4f} ms by CUDA events; host "
              f"{r['host_us']:.1f} us/call; device {r['kernel_us']:.2f} us/call in {kernel}, "
              f"{r['other_us']:.2f} us/call in other launches", flush=True)

    if args.bwd:
        backward_cases(record, randn, gen)
    for t, c, pool in ((585, 64, 4), (146, 256, 2)) if not args.bwd else ():
        for dtype in (torch.float32, torch.bfloat16):
            name = "fp32" if dtype == torch.float32 else "bf16"
            for s in (1, 24):
                lead = (s,) if s > 1 else ()
                conv = randn(*lead, 64, t, c).to(dtype)
                gamma, beta = 1 + 0.3 * randn(*lead, c), 0.1 * randn(*lead, c)
                mean = conv.float().mean((-3, -2))
                var = (conv.float() ** 2).mean((-3, -2)) - mean * mean
                stats = (gamma, beta, mean, var)
                if s == 1:
                    running = (gamma, beta, 0.1 * randn(c), 1 + 0.2 * randn(c).abs())
                    record(f"eval S=1 {name} pool {pool} {tuple(conv.shape)}",
                           lambda a=(conv, *running), p=pool:
                           conv_stem_train.fused_stage_train(*a, 0.0, p), "stem_tail_fwd")
                for p in (0.0, 0.4):
                    record(f"train S={s} {name} pool {pool} {tuple(conv.shape)} p {p}",
                           lambda a=(conv, *stats), p=p, pool=pool: conv_stem_train.stem_tail_fwd(
                               *a, p, pool, generator=gen), "stem_tail_fwd")
    for b, t, c, o, k, pad, pool in (((64, 585, 32, 64, 15, 7, 4), (64, 146, 64, 256, 5, 2, 2))
                                     if not args.bwd else ()):
        x = randn(b, t, c)
        w = randn(o, c, k) / (c * k) ** 0.5
        scale, shift = 1 + 0.3 * randn(o), 0.1 * randn(o)
        record(f"conv k {k} pool {pool} {tuple(x.shape)}",
               lambda a=(x, w, scale, shift, pad, pool): conv_stem.fused_conv_bn_gelu_pool(*a),
               "conv_stem")
    if args.stage_profile:
        stage_profile(args.label, dev, gen)
    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"stem {args.label}: {smi}")
    print(json.dumps({"label": args.label, "device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

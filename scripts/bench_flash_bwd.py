"""Time the flash-attention kernels (csrc/flash_attn.cu, or with --dtype
bf16 their bf16 forms, csrc/flash_attn_bf16.cu and csrc/flash_bwd_bf16.cu)
on one CUDA card, the backward pair beside SDPA's backward, and hold the
backward to fp64.

At the shapes ``chip_smoke.py``'s attention cases use, seeded: the
attention phase's (BH 512, T 585, D 32), 200 queries over 100 keys, and 9
over 9. For each: the time (CUDA events, below) of the forward, dQ and
dK/dV kernels at the default tiles
(64/64), and of one ``scaled_dot_product_attention`` backward (dQ, dK and dV
in one call; timed only, the port never calls it); each wrapper's host time
a call (``*_host_us``: ``perf_counter`` over 100 calls, no synchronisation
inside, so that the tensor maps' encoding shows); and the backward's
largest error against the fp64 plain versions on the same inputs, over
each output's scale (``attention.flash_bwd_magnitudes``, where the tree has
it) and over its largest entry.

    python3 scripts/bench_flash_bwd.py [--root DIR] [--label NAME] [--reps N] [--pairs]
                                       [--dtype {fp32,bf16}]

``--root`` is the checkout whose port is imported (default: this one), so
that two trees can be compared on one card, in turns; each shape's
results print as one line. ``--pairs`` also times dQ and dK/dV at the
first shape under every (block_q, block_k) pair of 32, 64 and 128. Each
time is the median of --reps event pairs, each around 10 back-to-back
calls (``chip_smoke.py``'s way, so host time hides behind the device's
where it can). In bf16 q is scaled in bf16 (``attention.scale_q``, as ``flash_mha`` scales it),
delta is ``attention.flash_delta``'s (where the tree has it) and SDPA runs
in bf16; each backward output's largest error against its bf16 plain
version is printed too, and two calls are compared bit for bit.
"""

import argparse
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"mha": (512, 585, 585, 32), "200q_100k": (512, 200, 100, 32), "9_9": (512, 9, 9, 32)}


def time_ms(fn, reps: int, calls: int = 10) -> float:
    """The median over ``reps`` of one event pair around ``calls``
    back-to-back calls, over ``calls``: as ``chip_smoke.py`` times a kernel,
    so that the wrappers' host time overlaps the device work before it."""
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


def host_us(fn, calls: int = 100) -> float:
    """The wrapper's host time a call: ``perf_counter`` over ``calls`` calls
    with no synchronisation inside (the device runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds * 1e6 / calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--pairs", action="store_true")
    parser.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    args = parser.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import attention

    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    bf16 = args.dtype == "bf16"
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (bh, tq, tk, d) in SHAPES.items():
        q = torch.randn(bh, tq, d, device=dev, generator=gen)
        k, v = (torch.randn(bh, tk, d, device=dev, generator=gen) for _ in range(2))
        do = torch.randn(bh, tq, d, device=dev, generator=gen)
        if bf16:
            q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
            q = attention.scale_q(q)
        else:
            q = q / math.sqrt(d)
        o, lse = attention.flash_fwd(q, k, v)
        delta = (attention.flash_delta(do, o) if hasattr(attention, "flash_delta")
                 else (do.float() * o.float()).sum(-1))
        bwd = (q, k, v, do, lse, delta)
        with torch.no_grad():
            row = {"shape": name, "bh": bh, "tq": tq, "tk": tk, "d": d,
                   "fwd_ms": time_ms(lambda: attention.flash_fwd(q, k, v), args.reps),
                   "dq_ms": time_ms(lambda: attention.flash_bwd_dq(*bwd), args.reps),
                   "dkv_ms": time_ms(lambda: attention.flash_bwd_dkv(*bwd), args.reps)}
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg[None], kg[None], vg[None], scale=1.0)
        row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do[None], retain_graph=True), args.reps)
        row["pair_ms"] = row["dq_ms"] + row["dkv_ms"]
        with torch.no_grad():
            for key, fn in (("fwd", lambda: attention.flash_fwd(q, k, v)),
                            ("dq", lambda: attention.flash_bwd_dq(*bwd)),
                            ("dkv", lambda: attention.flash_bwd_dkv(*bwd))):
                row[f"{key}_host_us"] = host_us(fn)
        with torch.no_grad():
            got = [attention.flash_bwd_dq(*bwd), *attention.flash_bwd_dkv(*bwd)]
            b64 = [t.double() for t in bwd]
            want = [attention.flash_bwd_dq_plain(*b64), *attention.flash_bwd_dkv_plain(*b64)]
            scales = (attention.flash_bwd_magnitudes(*b64)
                      if hasattr(attention, "flash_bwd_magnitudes") else [None] * 3)
            for out_name, g, w, scale in zip(("dq", "dk", "dv"), got, want, scales):
                err = (g.double() - w).abs().max().item()
                row[f"{out_name}_err_of_max"] = err / w.abs().max().item()
                if scale is not None:
                    row[f"{out_name}_err_of_scale"] = err / scale.item()
            if bf16:
                plain = [attention.flash_bwd_dq_plain(*bwd), *attention.flash_bwd_dkv_plain(*bwd)]
                again = [attention.flash_bwd_dq(*bwd), *attention.flash_bwd_dkv(*bwd)]
                for out_name, g, w in zip(("dq", "dk", "dv"), got, plain):
                    row[f"{out_name}_plain_err_of_max"] = ((g.double() - w.double()).abs().max()
                                                           / w.double().abs().max()).item()
                row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
                del plain, again
            del b64, want
        if args.pairs and name == "mha":
            with torch.no_grad():
                for bq in (32, 64, 128):
                    for bk in (32, 64, 128):
                        row[f"dq_ms_{bq}_{bk}"] = time_ms(
                            lambda: attention.flash_bwd_dq(*bwd, bq, bk), args.reps)
                        row[f"dkv_ms_{bq}_{bk}"] = time_ms(
                            lambda: attention.flash_bwd_dkv(*bwd, bq, bk), args.reps)
        torch.cuda.empty_cache()
        print(f"{args.label} {name}: " + ", ".join(
            f"{key} {val:.4f}" if key.endswith("_ms") else
            f"{key} {val:.1f}" if key.endswith("_us") else
            f"{key} {val:.2e}" if key.endswith(("_max", "_scale")) else f"{key} {val}"
            for key, val in row.items()))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its trainer entry
(``entries/<entry>.py``). Set-up (imports, kernel libraries, data and
weights from the seed, the trainer, its first three steps captured through
the window's own call, warm calls) ends at the first timed call. The
window repeats whole calls for ``--seconds``. With ``--trace 0`` the result
carries the end-to-end metrics; with ``--trace 1`` a fixed number of calls
after the window is profiled and the per-layer metrics are read from that
trace (``metrics/<name>.py``). Either way the program's state is then
freed and the plain reference follows the same first three steps; the
numbers compared and their limits are printed on standard error and
under ``checks``, the last key of the result, the last line of standard
output.

Exit codes: 0 with a result; 2 without the CUDA devices the cell needs; 3
when a JAX module is loaded once the window has closed.
"""

import time

START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prebuild(sources: list[str]) -> None:
    """Build the cell's kernel libraries together (each loads from the
    checkout's build directory once built)."""
    from multimodal_sentiment_aanalysis_tpu_torch.kernels._build import build

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        list(pool.map(build, sources))


def end_to_end(metrics: list, rate: float, setup_s: float, peak: int) -> dict:
    """The cell's end-to-end metrics: its rate (examples over the window's
    seconds), the peak device memory and the set-up time."""
    values = {"train_samples_per_s": rate, "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in metrics}


def per_layer(harness, entry, cfg, wl, rate: float, metrics: list):
    """Profile ``trace_calls`` calls of device activity and read the cell's
    per-layer metrics; then as many calls again with the host's operators,
    whose trace names what the host did in each idle gap."""
    trace = harness.profile(entry.call, wl["trace_calls"])
    info = {"encoder_rows_per_step": entry.encoder_rows_per_step,
            "steps_per_call": entry.steps_per_call}
    ctx = harness.Context(cfg, wl, trace, wl["trace_calls"] * entry.steps_per_call, rate,
                          entry.flops_per_example(), info)
    out = {}
    for m in metrics:
        value = harness.load_metric(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    host = harness.profile(entry.call, wl["trace_calls"], host_ops=True)
    breakdown = {"device_ops": trace.top_ops(), "idle_gaps": host.idle_gaps()}
    return out, {"busy_s": trace.busy_s, "window_s": trace.window_s}, breakdown


def checks(entry, wl: dict) -> dict:
    """The reference's first steps against the program's: each number with
    its limit (None until the cell's limits are set)."""
    from benchmark import training

    gaps = training.compare(entry.program, entry.reference_readings("float32"), wl)
    limits = wl.get("limits") or {}
    return {f"{k}_gap": {"value": v, "limit": limits.get(k)} for k, v in gaps.items()}


def run(args, wl: dict, cfg: dict, device, fault: str | None = None, start: float = START):
    """Everything after the look for the devices: returns the result dict,
    or None when a JAX module is loaded."""
    import torch

    from benchmark import harness

    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        prebuild(wl["prebuild"])
    stages = [("imports and kernel libraries", time.time())]
    entry = harness.load_entry(wl["entry"]).Entry(cfg, wl, args.seed, device, fault)
    stages.append(("data, weights, trainer", time.time()))
    entry.setup()
    harness.sync(device)
    stages.append(("capture and warm calls", time.time()))
    setup_s = time.time() - start
    if device.type == "cuda":
        print("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                                     in zip([("start", start)] + stages, stages))
              + f"; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", file=sys.stderr)
    calls, window_s = harness.window(entry.call, args.seconds, device)
    examples = calls * entry.examples_per_call
    failed = entry.failed_examples()
    print(f"window: {calls} calls in {window_s:.3f} s", file=sys.stderr)
    rate = examples / window_s
    dev = harness.device_info(wl["chips"]) if device.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": False, "attempted": examples, "failed": failed}
    if args.trace:
        metrics, busy, breakdown = per_layer(harness, entry, cfg, wl, rate,
                                             harness.cell_metrics("per_layer", wl["name"]))
        dev.update(busy)
        result.update(metrics=metrics, device=dev, breakdown=breakdown)
    else:
        result.update(metrics=end_to_end(harness.cell_metrics("end_to_end", wl["name"]), rate,
                                         setup_s, dev["memory_peak_bytes"]), device=dev)
    entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = checks(entry, wl)
    result["correct"] = failed == 0 and all(
        c["limit"] is not None and harness.finite(c["value"]) and c["value"] <= c["limit"]
        for c in result["checks"].values())
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: JAX modules loaded in the measured process: {loaded}",
              file=sys.stderr)
        return None
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    wl, cfg = harness.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < wl["chips"]:
        print(f"benchmark: {args.workload} needs {wl['chips']} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = run(args, wl, cfg, torch.device("cuda", 0))
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

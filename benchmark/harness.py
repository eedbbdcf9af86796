"""What every cell's run shares: finding a cell's files by name, the
synthetic data and weights drawn from the seed, the measured window, the
traced stretch and its reduction, the check that no JAX module is loaded,
and the result line."""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_sentiment_aanalysis_tpu")


# --------------------------------------------------------------------------
# the cell's files
# --------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> tuple[dict, dict]:
    """``(workload, configuration)`` of a cell, from
    ``workloads/<name>.json`` and the ``configs/<config>.json`` it names."""
    wl = load_json(root / "workloads" / f"{name}.json")
    return wl, load_json(root / "configs" / f"{wl['config']}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(name: str, root: Path = ROOT):
    """``entries/<name>.py``: the set-up and the window's call of one trainer."""
    return _module(root / "entries" / f"{name}.py", f"benchmark_entry_{name}")


def load_metric(name: str, root: Path = ROOT):
    """One per-layer metric's reader, ``read(ctx)``: ``metrics/<name>.py``."""
    return _module(root / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def kernel_patterns(metric: str, root: Path = ROOT) -> tuple[list[str], list[str]]:
    """The kernel-name substrings listed for a metric, one per line of the
    files under ``metrics/<metric>.d/``: ``(included, excluded)``, a line
    starting with ``!`` excluding; ``#`` starts a comment."""
    inc, exc = [], []
    for path in sorted((root / "metrics" / f"{metric}.d").glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                (exc if line.startswith("!") else inc).append(line.lstrip("!"))
    return inc, exc


def manifest(root: Path = ROOT) -> dict:
    return load_json(root.parent / "BENCHMARK.json")


def cell_metrics(section: str, cell_name: str, root: Path = ROOT) -> list[dict]:
    """The manifest's metrics of ``section`` that this cell reports: those
    that list it under ``workloads``; of those that list no cells, every
    end-to-end metric, and every per-layer metric whose ``moves`` the cell
    reports."""
    m = manifest(root)
    e2e = [x for x in m["end_to_end"] if cell_name in x.get("workloads", [cell_name])]
    if section == "end_to_end":
        return e2e
    reported = {x["name"] for x in e2e}
    return [x for x in m["per_layer"]
            if cell_name in x.get("workloads", [cell_name] if x["moves"] in reported else [])]


# --------------------------------------------------------------------------
# inputs from the seed
# --------------------------------------------------------------------------


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed of its own for stream ``k`` of a run's ``seed``."""
    return int(np.random.SeedSequence([seed % 2 ** 64, k]).generate_state(1, np.uint64)[0] >> 1)


def labels(cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Every subject's arousal and valence labels ``(N,)`` int64: the same
    count of trials in each (arousal, valence) class for every subject and
    seed (``dataset.class_counts``), the classes and the trial order drawn
    from the seed, so that every seed gives the same pair counts."""
    d = cfg["dataset"]
    classes = cfg["classes"]
    counts = d["class_counts"]
    rng = np.random.default_rng(sub_seed(seed, 1))
    a, v = [], []
    for _ in range(d["subjects"]):
        cls = rng.permutation(classes * classes)[:len(counts)]
        trial = rng.permutation(np.repeat(cls, counts))
        a.append(trial // classes)
        v.append(trial % classes)
    return np.concatenate(a).astype(np.int64), np.concatenate(v).astype(np.int64)


def dataset(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The synthetic recordings with the dataset's shapes, drawn on
    ``device`` in one call per modality: standard normal, the arousal label
    shifting the EEG and eye features and the valence label the PPS."""
    d = cfg["dataset"]
    n = d["subjects"] * d["trials"]
    arousal, valence = labels(cfg, seed)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    a = torch.as_tensor(arousal, device=device)
    v = torch.as_tensor(valence, device=device)
    shift = d["label_shift"]
    eeg = torch.randn((n, cfg["eeg"]["channels"], cfg["eeg"]["time"]), generator=g,
                      device=device)
    eye = torch.randn((n, cfg["eye_dim"]), generator=g, device=device)
    pps = torch.randn((n, cfg["pps_dim"]), generator=g, device=device)
    return {"eeg": eeg + shift * (a - 1).float()[:, None, None],
            "eye": eye + shift * (a - 1).float()[:, None],
            "pps": pps + shift * (v - 1).float()[:, None],
            "arousal": a, "valence": v}


# --------------------------------------------------------------------------
# window, trace
# --------------------------------------------------------------------------


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(call, seconds: float, device: torch.device) -> tuple[int, float]:
    """Whole calls until ``seconds`` have passed on the host's clock, then
    the device drained: ``(calls, seconds from the first call to the end
    of the last one's work)``.

    Python's cyclic garbage is collected after each call, inside the
    window, with the automatic collector off: the trainers' steps leave
    cycles that hold device memory, which the automatic collector frees at
    points that differ from run to run (the peak moved by 1.2 GiB between
    runs of one seed), while collected at each call's end the peak holds
    one call's garbage in every run."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        sync(device)
        start = time.perf_counter()
        calls = 0
        while True:
            call()
            gc.collect()
            calls += 1
            if time.perf_counter() - start >= seconds:
                break
        sync(device)
        return calls, time.perf_counter() - start
    finally:
        gc.enable()
        gc.unfreeze()


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A traced stretch reduced from the profiler's Chrome trace: every
    kernel ``(name, start_us, dur_us)``, the device's busy intervals
    (kernels, copies, fills) and the host operation behind each idle gap."""

    def __init__(self, events: list[dict], window_s: float):
        self.window_s = window_s
        device_cats = ("kernel", "gpu_memcpy", "gpu_memset")
        self.kernels = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                        for e in events if e.get("cat") == "kernel"]
        dev = [e for e in events if e.get("cat") in device_cats]
        self.busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                            for e in dev])
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6
        self._events = events
        self._dev = dev

    def kernel_seconds(self, included: list[str], excluded: list[str]) -> tuple[float, int]:
        """Seconds and count of the kernels whose names contain an included
        substring and no excluded one."""
        t = n = 0
        for name, _, dur in self.kernels:
            if any(s in name for s in included) and not any(s in name for s in excluded):
                t += dur
                n += 1
        return t / 1e6, n

    def top_ops(self, k: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for e in self._dev:
            name = e["name"][:160]
            tot[name] = tot.get(name, 0.0) + float(e.get("dur", 0.0)) / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The idle time between busy intervals, summed by the host operation
        that launched the device work that ended each gap (the innermost
        operator around its launch call)."""
        launch = {e["args"]["correlation"]: e for e in self._events
                  if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        ops: dict = {}
        for e in self._events:
            if e.get("cat") == "cpu_op":
                ops.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
        starts = {tid: [o[0] for o in sorted(v)] for tid, v in ops.items()}
        ops = {tid: sorted(v) for tid, v in ops.items()}
        first = {}
        for e in self._dev:
            first.setdefault(float(e["ts"]), e)
        tot: dict[str, float] = {}
        for (_, end), (nxt, _) in zip(self.busy, self.busy[1:]):
            label = "unattributed"
            ev = first.get(nxt)
            rt = launch.get(ev.get("args", {}).get("correlation")) if ev else None
            if rt is not None:
                ts, tid = float(rt["ts"]), rt.get("tid")
                label = f"launch:{rt['name']}"
                lst = ops.get(tid, [])
                i = bisect.bisect_right(starts.get(tid, []), ts) - 1
                for j in range(i, max(i - 400, -1), -1):
                    if lst[j][1] >= ts:
                        label = lst[j][2]
                        break
            tot[label] = tot.get(label, 0.0) + (nxt - end) / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def profile(call, n_calls: int, host_ops: bool = False) -> Trace:
    """Trace ``n_calls`` calls and reduce the trace: the device's activity,
    and with ``host_ops`` the host's operators too (which slows the host
    several times over, so the busy share is read without them). The
    Chrome trace goes to a temporary file that is removed."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - start
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, window_s)


class Context:
    """What a per-layer metric's reader reads: the cell, the trace of
    ``steps`` train steps, and the window's rate."""

    def __init__(self, cfg: dict, wl: dict, trace: Trace, steps: int, rate: float,
                 flops_per_example: float, info: dict, root: Path = ROOT):
        self.cfg, self.wl, self.trace, self.steps = cfg, wl, trace, steps
        self.rate, self.flops_per_example, self.info = rate, flops_per_example, info
        self.root = root

    def kernel_seconds(self, metric: str) -> tuple[float, int]:
        return self.trace.kernel_seconds(*kernel_patterns(metric, self.root))


# --------------------------------------------------------------------------
# the run's end
# --------------------------------------------------------------------------


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)

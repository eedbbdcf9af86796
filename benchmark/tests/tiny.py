"""Tiny forms of the benchmark's cells, for runs on the CPU: the real
workload and configuration files with the dataset, the widths the port lets
vary, and the batch cut down."""

from __future__ import annotations

import copy
from types import SimpleNamespace

from benchmark import harness


def tiny_cell(name: str) -> tuple[dict, dict]:
    wl, cfg = harness.cell(name)
    wl, cfg = copy.deepcopy(wl), copy.deepcopy(cfg)
    cfg["dataset"].update(subjects=4, trials=8, class_counts=[3, 2, 1, 1, 1])
    cfg["eeg"].update(channels=4, time=48)
    cfg["feat_dim"] = 16
    if "proj_hidden" in cfg:
        cfg.update(proj_hidden=16, proj_out=8, clf_hidden=8)
    wl.update(models=4, batch=8, warm_calls=1, reference_block=2)
    return wl, cfg


def args(seed: int, seconds: float = 0.0, trace: int = 0) -> SimpleNamespace:
    return SimpleNamespace(seed=seed, seconds=seconds, trace=trace)


def run_module():
    """``benchmark/run.py`` as a module (its ``run`` skips the look for a
    chip)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "run.py"
    spec = importlib.util.spec_from_file_location("benchmark_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

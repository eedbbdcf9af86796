"""A configuration, a cell and a per-layer metric are added as new files
alone: the harness finds each by its name in a copy of the benchmark."""

import json
import shutil
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[1]


def test_new_files_are_found(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "flagship_mtm.json").read_text())
    cfg["name"] = "flagship_wide"
    (root / "configs" / "flagship_wide.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "workloads" / "loso_fp32_b64.json").read_text())
    wl.update(name="loso_wide_b32", config="flagship_wide", batch=32)
    (root / "workloads" / "loso_wide_b32.json").write_text(json.dumps(wl))
    (root / "metrics" / "rows_per_step.py").write_text(
        "def read(ctx):\n    return ctx.info['encoder_rows_per_step']\n")
    (root / "metrics" / "bilstm_roofline_pct.d" / "later.txt").write_text("new_lstm_kernel\n")

    got_wl, got_cfg = harness.cell("loso_wide_b32", root)
    assert got_wl["batch"] == 32 and got_cfg["name"] == "flagship_wide"
    assert harness.load_entry(got_wl["entry"], root).Entry.__name__ == "Entry"
    ctx = harness.Context(got_cfg, got_wl, None, 1, 0.0, 0.0, {"encoder_rows_per_step": 7},
                          root)
    assert harness.load_metric("rows_per_step", root).read(ctx) == 7
    inc, exc = harness.kernel_patterns("bilstm_roofline_pct", root)
    assert "new_lstm_kernel" in inc and "bilstm_sweep_kernel" in inc and not exc

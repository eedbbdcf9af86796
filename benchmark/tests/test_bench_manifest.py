"""BENCHMARK.json against the limits a manifest keeps to on names, units and keys,
and every name it gives found as a file of the benchmark."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries(section, keys):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(set(names)) == len(names)
    for e in MANIFEST[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert LINE.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["name"]
            assert e["better"] in ("lower", "higher")


def test_metrics_rules():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert harness.load_metric(m["name"]).read


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_reports_enough(cell):
    e2e = {m["name"] for m in harness.cell_metrics("end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert "train_samples_per_s" in e2e
    per_layer = harness.cell_metrics("per_layer", cell)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files(cell):
    w = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    wl, cfg = harness.cell(cell)
    assert wl["config"] == w["config"] == cfg["name"] and wl["chips"] == w["chips"] == 1
    assert w["traffic"] == cell and NAME.match(w["traffic"])
    assert (ROOT / "benchmark" / "entries" / f"{wl['entry']}.py").exists()
    assert set(wl["limits"]) == {"loss", "grad", "update", "update_median", "stats"}
    c = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert c["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert c["reduced"] == cfg["reduced"] == []

"""A run's result line and its refusals: no result without the CUDA devices
a cell needs or without the program beside the benchmark, and the result's
keys in order, ``checks`` last."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.tests.tiny import args, run_module, tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def test_no_result_without_cuda_or_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "loso_fp32_b64",
                              "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                             cwd=cwd, capture_output=True, text=True)
        assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", ["loso_bf16_b512", "simclr_pretrain_b128"])
def test_result_keys(cell):
    wl, cfg = tiny_cell(cell)
    result = run_module().run(args(2 ** 31 + 9), wl, cfg, torch.device("cpu"),
                              start=time.time())
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    assert {"metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "update_gap",
                                     "update_median_gap", "stats_gap"}
    assert isinstance(result["correct"], bool)
    json.dumps(result)


def test_sound_tiny_run_is_correct():
    wl, cfg = tiny_cell("loso_fp32_b64")
    result = run_module().run(args(2 ** 31 + 9), wl, cfg, torch.device("cpu"),
                              start=time.time())
    assert result["correct"] is True, result["checks"]

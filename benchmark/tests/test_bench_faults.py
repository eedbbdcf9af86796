"""A run with the timed path broken underneath comes out not correct: the
look for a chip skipped, the rest of a run driven on the CPU at a tiny size
with each fault a training cell can have on one chip planted in the
program (a step that leaves the parameters unchanged; one that leaves the
BatchNorm running statistics unchanged; the learning rate 1.25 times too
large; half of each batch left out of the mean). Some number compared has
to pass its limit: a limit not yet set would fail every run alike."""

import time

import pytest
import torch

from benchmark.tests.tiny import args, run_module, tiny_cell


@pytest.mark.parametrize("cell", ["loso_fp32_b64", "simclr_pretrain_b128"])
@pytest.mark.parametrize("fault", ["frozen", "stats_frozen", "lr_scaled", "half_batch"])
def test_fault_is_not_correct(cell, fault):
    wl, cfg = tiny_cell(cell)
    result = run_module().run(args(2 ** 31 + 21), wl, cfg, torch.device("cpu"), fault=fault,
                              start=time.time())
    checks = result["checks"]
    assert result["correct"] is False, checks
    assert any(c["limit"] is not None and c["value"] > c["limit"] for c in checks.values()), checks

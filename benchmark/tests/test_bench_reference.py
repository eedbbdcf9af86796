"""The frozen references and rules against the port's CPU path, at tiny
sizes: the dropout bits, the plans and pairs, and three training steps of
each configuration."""

import numpy as np
import pytest
import torch

from benchmark import harness, training
from benchmark.reference import rules
from benchmark.tests.tiny import tiny_cell


def test_stem_keep_mask_is_the_kernels_philox():
    from multimodal_sentiment_aanalysis_tpu_torch.kernels.conv_stem_train import keep_mask_plain

    for seed in (1, 2 ** 61 + 12345, 2 ** 62 - 1):
        want = keep_mask_plain(torch.tensor([seed]), (1, 3, 7, 8), 0.4)[0]
        assert torch.equal(rules.stem_keep_mask(seed, (3, 7, 8), 0.4, "cpu"), want)


def test_device_plan_rule():
    from multimodal_sentiment_aanalysis_tpu_torch.data.pipeline import epoch_plan_on_device

    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = rules.device_epoch_plan(a, 23, 8)
    want = epoch_plan_on_device(b, 23, 8)
    assert torch.equal(got[0], want[0].long()) and torch.equal(got[1], want[1])


def test_pair_rule():
    from multimodal_sentiment_aanalysis_tpu_torch.data.pairs import build_contrastive_pairs

    rng = np.random.default_rng(0)
    a, v = rng.integers(0, 3, 60), rng.integers(0, 3, 60)
    sid = np.repeat(np.arange(3), 20)
    got = rules.contrastive_pairs(a, v, sid, 9)
    want = build_contrastive_pairs(a, v, sid, seed=9)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("cell,limits", [
    ("loso_fp32_b64", {"loss": 1e-5, "grad": 1e-3, "update": 1e-2, "update_median": 1e-3,
                       "stats": 1e-4}),
    ("simclr_pretrain_b128", {"loss": 1e-5, "grad": 1e-3, "update": 0.2, "update_median": 2e-2,
                              "stats": 1e-2}),
])
def test_reference_follows_the_port(cell, limits):
    wl, cfg = tiny_cell(cell)
    entry = harness.load_entry(wl["entry"]).Entry(cfg, wl, 2 ** 31 + 5, torch.device("cpu"))
    entry.setup()
    gaps = training.compare(entry.program, entry.reference_readings(), wl)
    assert all(gaps[k] <= limits[k] for k in limits), gaps

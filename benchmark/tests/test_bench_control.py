"""The control on the card: the plain reference computed in the precision
below the one the configuration states (TF32 for float32, float8 operands
for bfloat16), put in the program's place, fails at least one of the
cell's numbers. At 4 models and a batch of 16 at the published widths.
Run on a card: ``python -m pytest -m gpu benchmark/tests``."""

import copy

import pytest
import torch

from benchmark import harness, training


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["loso_fp32_b64", "loso_bf16_b512", "simclr_pretrain_b128"])
def test_control_fails(card, cell):
    wl, cfg = harness.cell(cell)
    wl = copy.deepcopy(wl)
    cfg = copy.deepcopy(cfg)
    cfg["dataset"]["subjects"] = wl["models"] = 4
    wl["batch"] = 16
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    entry = harness.load_entry(wl["entry"]).Entry(cfg, wl, 2 ** 31 + 77, card)
    entry.release()
    ref = entry.reference_readings("float32")
    gaps = training.compare(entry.reference_readings(wl["control"]), ref, wl)
    assert any(gaps[k] > wl["limits"][k] for k in gaps), gaps

"""The port's serving slice against the JAX package's eval forward.

Both entry points of the port — the eval model forward and
:func:`build_serving_forward` (conv stem plain or through the fused
conv-stem kernel's module) — must reproduce JAX ``model.apply(variables,
eeg, eye, pps)`` on the same weights (carried by ``jax_import``, with
non-trivial BN running stats) and inputs, rtol/atol 1e-4 (fp32 summation
order through the whole model, and BN folded into the trunk Linears). Once
at the CLI's ``--tiny`` dims and once at full width.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset, epoch_batch_indices
from multimodal_sentiment_aanalysis_tpu_torch.eval import build_serving_forward
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MultimodalTransformerModel,
    state_dict_from_jax_variables,
)

from test_torch_port_models import inputs, jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DIMS = {"tiny": (32, 64, 5), "full": (256, 585, 4)}  # feat_dim, eeg_time, batch


@pytest.fixture(scope="module", params=sorted(DIMS))
def case(request):
    feat_dim, eeg_time, b = DIMS[request.param]
    v = jax_variables(feat_dim, eeg_time, seed=11)
    x = inputs(b, eeg_time, seed=12)
    model = jmodels.MultimodalTransformerModel(feat_dim=feat_dim, eeg_time=eeg_time)
    ref = tuple(np.asarray(o) for o in model.apply(v, *x))
    port = MultimodalTransformerModel(feat_dim=feat_dim, eeg_time=eeg_time).eval()
    port.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    return feat_dim, port, x, ref


ENTRY_POINTS = {
    "model_forward": lambda port, f: port,
    "serving": lambda port, f: build_serving_forward(port, f),
    "serving_use_pallas": lambda port, f: build_serving_forward(port, f, use_pallas=True),
    "serving_from_state_dict": lambda port, f: build_serving_forward(
        port.state_dict(), feat_dim=f, use_pallas=True),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_slice_matches_jax_model_apply(case, entry):
    feat_dim, port, x, (ref_a, ref_v) = case
    with torch.no_grad():  # the model forward records gradients otherwise
        a, v = ENTRY_POINTS[entry](port, feat_dim)(*map(torch.from_numpy, x))
    for got, ref in ((a, ref_a), (v, ref_v)):
        assert got.shape == ref.shape == (len(x[0]), 3)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_serving_refuses_bf16():
    """bf16 serving runs, but not through the fused conv-stem kernel, which
    has no bf16 form: ``use_pallas=True`` with bf16 raises rather than
    switch paths."""
    port = MultimodalTransformerModel(feat_dim=32, eeg_time=64).eval()
    with pytest.raises(ValueError, match="use_pallas=True serves fp32 only"):
        build_serving_forward(port, 32, use_pallas=True, compute_dtype=torch.bfloat16)


def test_port_imports_no_jax():
    """Importing the port and every submodule leaves jax, flax and the JAX
    package out of ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multimodal_sentiment_aanalysis_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    print(m.name[len(p.__name__) + 1:])\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'multimodal_sentiment_aanalysis_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert {"config", "data.features", "data.pipeline", "data.raw", "data.splits",
            "eval.serving", "kernels._build", "kernels.contrastive", "kernels.conv_stem_train",
            "kernels.lstm", "models.jax_import", "ops.losses", "ops.rnn", "train.engine",
            "train.state", "utils.schedule", "data.memhacl", "data.augment",
            "kernels.attention", "kernels.fusion_head", "models.memhacl", "models.simclr",
            "train.memhacl"} <= walked


@pytest.mark.parametrize("n,batch,shuffle", [(480, 64, True), (10, 4, False)])
def test_epoch_batch_indices_matches_jax(n, batch, shuffle):
    from multimodal_sentiment_aanalysis_tpu.data.pipeline import (
        epoch_batch_indices as jax_plan,
    )

    got = epoch_batch_indices(n, batch, np.random.default_rng(3), shuffle)
    want = jax_plan(n, batch, np.random.default_rng(3), shuffle)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_device_dataset_gather_and_subset():
    rng = np.random.default_rng(4)
    arrays = {"eeg": rng.normal(size=(10, 2, 3)).astype(np.float32),
              "arousal": rng.integers(0, 3, 10)}
    ds = DeviceDataset(arrays, "cpu")
    idx = np.array([3, 3, 9, 0])
    batch = ds.gather(idx)
    for k, a in arrays.items():
        np.testing.assert_array_equal(batch[k].numpy(), a[idx])
    sub = ds.subset(np.array([1, 4]))
    assert len(sub) == 2 and sub.device == ds.device
    np.testing.assert_array_equal(sub.gather([1])["eeg"].numpy(), arrays["eeg"][[4]])
    with pytest.raises(ValueError):
        DeviceDataset({"a": np.zeros(3), "b": np.zeros(4)}, "cpu")

"""The port's evaluation of a saved model against the JAX package on the CPU.

- reporting: ``accumulate_confusion``, ``normalize_cm``, ``Myreport``,
  ``parse_cm``, ``history2df`` and ``save_history`` (the CSV read back)
  equal to JAX's on the same arrays, several seeds; the plot writers write
  non-empty files; the per-class report's precision, recall, F1 and
  support equal to sklearn's ``precision_recall_fscore_support`` and its
  text to sklearn's ``classification_report`` (``zero_division=0``);
- ``Tester``: the port's ``evaluate`` against JAX ``Tester.evaluate`` on the
  same weights (``state_dict_from_jax_variables``, random BatchNorm stats)
  over 37 rows in batches of 16 (a tail batch): loss and probabilities
  within 1e-4 (the serving bar against JAX on the CPU), accuracy and
  predictions equal on inputs whose top-two logits lie more than 1e-3
  apart; ``predict_single`` against JAX's and against ``evaluate``'s rows;
  the verbose report and the confusion-matrix files; the checkpoint
  formats (``state_dict``, ``{"state_dict": ...}``, ``module.``-prefixed;
  a partly prefixed file left as it is and refused by the strict load; a
  ``.msgpack`` path refused);
- a ``.pt`` that the port's ``Trainer`` wrote, loaded by JAX's
  ``Tester.load_model``, evaluates as the port's ``Tester`` evaluates it
  (``Trainer.test_with_loaded_model`` against the JAX ``Trainer``'s is in
  ``tests/test_torch_port_train.py``, beside the JAX trainer it needs);
- the port's packages import without sklearn, matplotlib, pandas or JAX.

The flagship at feat_dim 16 with 16 EEG steps; inputs from seeded numpy.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
from multimodal_sentiment_aanalysis_tpu.eval import Tester as JaxTester
from multimodal_sentiment_aanalysis_tpu.eval import reporting as jrep
from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
    variables_from_torch_state_dict,
)
from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset
from multimodal_sentiment_aanalysis_tpu_torch.eval import Tester as PortTester
from multimodal_sentiment_aanalysis_tpu_torch.eval import reporting as rep
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MultimodalTransformerModel,
    state_dict_from_jax_variables,
)
from multimodal_sentiment_aanalysis_tpu_torch.train import Trainer
from multimodal_sentiment_aanalysis_tpu_torch.utils import save_checkpoint

from test_torch_port_models import inputs
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FEAT, T_EEG, N_ROWS, EVAL_BATCH = 16, 16, 37, 16
SEEDS = (0, 1, 2)
TIE_MARGIN = 1e-3


def _port_model(**kw) -> MultimodalTransformerModel:
    return MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG, **kw)


def _arrays(n: int, seed: int) -> dict:
    eeg, eye, pps = inputs(n, T_EEG, seed=seed)
    rng = np.random.default_rng(seed + 100)
    return {"eeg": eeg, "eye": eye, "pps": pps,
            "arousal": rng.integers(0, 3, n).astype(np.int64),
            "valence": rng.integers(0, 3, n).astype(np.int64)}


def _variables(seed: int) -> dict:
    """JAX variables of a seeded port model with BatchNorm running stats
    drawn away from their init (``variables_from_torch_state_dict``: no
    JAX init, whose trace takes ~20 s)."""
    model = _port_model(generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return jax.tree.map(np.asarray, variables_from_torch_state_dict(model.state_dict()))


@pytest.fixture(scope="module")
def tester_pair():
    """One JAX and one port ``Tester`` on the same weights and test set,
    and both ``evaluate`` results."""
    v = _variables(0)
    arrays = _arrays(N_ROWS, 1)
    jt = JaxTester(jmodels.MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                   JaxDataset(arrays), variables=v)
    model = _port_model()
    pt = PortTester(model, DeviceDataset(arrays, "cpu"),
                    state_dict=state_dict_from_jax_variables(v))
    want = jt.evaluate(verbose=False, batch_size=EVAL_BATCH)
    got = pt.evaluate(verbose=False, batch_size=EVAL_BATCH)
    return jt, pt, arrays, want, got


def _margins(probabilities: np.ndarray) -> np.ndarray:
    top2 = np.sort(np.log(probabilities), axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def assert_results_match(got: dict, want: dict, atol: float = 1e-4) -> None:
    for head in ("arousal", "valence"):
        g, w = got[head], want[head]
        assert g.keys() == w.keys()
        assert _margins(np.asarray(w["probabilities"])).min() > TIE_MARGIN, head
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0, atol=atol)
        np.testing.assert_allclose(g["probabilities"], w["probabilities"], rtol=0, atol=atol)
        np.testing.assert_array_equal(g["predictions"], w["predictions"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["accuracy"] == w["accuracy"]


# --------------------------------------------------------------------------
# Tester
# --------------------------------------------------------------------------


def test_tester_evaluate_matches_jax(tester_pair):
    _, _, arrays, want, got = tester_pair
    assert_results_match(got, want)
    assert got["arousal"]["probabilities"].shape == (N_ROWS, 3)
    assert got["arousal"]["predictions"].dtype == np.int64


def test_predict_single_matches_jax_and_evaluate(tester_pair):
    jt, pt, arrays, _, got = tester_pair
    for row in (0, 17, N_ROWS - 1):
        sample = {k: arrays[k][row] for k in ("eeg", "eye", "pps")}
        p, j = pt.predict_single(sample), jt.predict_single(sample)
        for head in ("arousal", "valence"):
            assert p[head]["prediction"] == j[head]["prediction"] == got[head]["predictions"][row]
            np.testing.assert_allclose(p[head]["probabilities"], j[head]["probabilities"],
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(p[head]["probabilities"],
                                       got[head]["probabilities"][row], rtol=0, atol=1e-5)


def test_verbose_evaluate_prints_the_report_and_writes_figures(tester_pair, tmp_path, capsys):
    from sklearn.metrics import classification_report

    _, pt, _, _, got = tester_pair
    pt.evaluate(verbose=True, batch_size=EVAL_BATCH, plot_dir=str(tmp_path))
    out = capsys.readouterr().out
    for head in ("arousal", "valence"):
        r = got[head]
        names = [f"Class {i}" for i in range(len(np.unique(r["labels"])))]
        assert classification_report(r["labels"], r["predictions"], target_names=names,
                                     zero_division=0) in out
        assert f"[{head}] loss {r['loss']:.4f} accuracy {r['accuracy']:.2%}" in out
        assert (tmp_path / f"confusion_{head}.png").stat().st_size > 0
    pt.evaluate(verbose=True, batch_size=EVAL_BATCH, plot_dir=None)
    assert sorted(os.listdir(tmp_path)) == ["confusion_arousal.png", "confusion_valence.png"]


def test_load_model_formats(tester_pair, tmp_path):
    """A ``state_dict``, one under ``"state_dict"`` and one with the
    ``module.`` prefix load strictly and evaluate alike; a partly prefixed
    file keeps its keys, so the strict load refuses it; ``.msgpack``
    raises."""
    _, pt, arrays, _, got = tester_pair
    sd = pt.model.state_dict()
    files = {"plain.pt": sd, "nested.pth": {"state_dict": sd},
             "prefixed.pt": {f"module.{k}": t for k, t in sd.items()}}
    data = DeviceDataset(arrays, "cpu")
    for name, obj in files.items():
        save_checkpoint(str(tmp_path / name), obj)
        fresh = PortTester(_port_model(generator=torch.Generator().manual_seed(9)), data)
        res = fresh.run(str(tmp_path / name), verbose=False, batch_size=EVAL_BATCH)
        for head in ("arousal", "valence"):
            np.testing.assert_array_equal(res[head]["probabilities"],
                                          got[head]["probabilities"])
    first = next(iter(sd))
    partly = {(f"module.{k}" if k == first else k): t for k, t in sd.items()}
    save_checkpoint(str(tmp_path / "partly.pt"), partly)
    with pytest.raises(RuntimeError, match=f"module.{first}"):
        PortTester(_port_model(), data).load_model(str(tmp_path / "partly.pt"))
    with pytest.raises(ValueError, match="msgpack"):
        PortTester(_port_model(), data).load_model(str(tmp_path / "x.msgpack"))


def test_port_checkpoint_evaluates_alike_in_the_jax_tester(tester_pair, tmp_path):
    """The ``best_model.pt`` the port's ``Trainer`` writes, loaded by JAX's
    ``Tester.load_model`` (``load_torch_checkpoint``), evaluates as the
    port's ``Tester`` evaluates it."""
    jt, _, arrays, _, _ = tester_pair
    model = _port_model()
    model.load_state_dict(state_dict_from_jax_variables(_variables(3)))
    data = DeviceDataset(arrays, "cpu")
    trainer = Trainer(model, data, data, batch_size=EVAL_BATCH, checkpoint_dir=str(tmp_path),
                      verbose=False)
    trainer._save("best_model.pt")
    path = str(tmp_path / "best_model.pt")
    variables = jt.variables
    try:
        jt.load_model(path)
        want = jt.evaluate(verbose=False, batch_size=EVAL_BATCH)
    finally:
        jt.variables = variables
    got = PortTester(_port_model(), data).run(path, verbose=False, batch_size=EVAL_BATCH)
    assert_results_match(got, want)


# --------------------------------------------------------------------------
# reporting
# --------------------------------------------------------------------------


def _history(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {s: {"epoch": int(rng.integers(1, 50)), "acc": float(rng.random()),
                "loss": float(rng.random()), "f1-score": float(rng.random()),
                "cm": rng.integers(0, 9, (3, 3))} for s in range(4)}


def _config(log_dir: str) -> dict:
    return {"seed": 42, "logging": {"log_dir": log_dir},
            "training": {"dependent": False, "n_folds": 5, "lr": 1e-4},
            "data": {"HCI": {"subject_lists": [1, 2, 4, 5], "modalities": ["eeg", "eye"]}}}


@pytest.mark.parametrize("seed", SEEDS)
def test_reporting_matches_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    labels, preds = rng.integers(0, 3, 40), rng.integers(0, 3, 40)
    preds[:3] = 2 if seed == 1 else preds[:3]
    for fn in (lambda m: m.accumulate_confusion(preds, labels, np.zeros((3, 3), int)),
               lambda m: m.normalize_cm(m.accumulate_confusion(preds, labels,
                                                               np.zeros((3, 3), int))),
               lambda m: m.Myreport().report(labels, preds, ["a", "b", "c"]),
               lambda m: m.Myreport().report_f1score(rng.integers(0, 9, (3, 3))),
               lambda m: m.parse_cm("[[1, 2], [3, -4]]")):
        state = rng.bit_generator.state
        want = fn(jrep)
        rng.bit_generator.state = state
        np.testing.assert_array_equal(fn(rep), want)
    history = _history(seed)
    assert rep.history2df(history).equals(jrep.history2df(history))
    import pandas as pd

    csv = {}
    for pkg in (rep, jrep):  # in one directory: its path is a column of the row
        log_dir = tmp_path / "logs"
        shutil.rmtree(log_dir, ignore_errors=True)
        for _ in range(2):  # a new file, then a row appended to it
            path = pkg.save_history(_config(str(log_dir)), "hci", f"t{seed}", history)
        csv[pkg] = os.path.basename(path), pd.read_csv(path)
    assert csv[rep][0] == csv[jrep][0] == "history_hci_4_0.csv"
    assert len(csv[rep][1]) == 2
    pd.testing.assert_frame_equal(csv[rep][1], csv[jrep][1])


@pytest.mark.parametrize("seed", SEEDS)
def test_report_matches_sklearn(seed):
    from sklearn.metrics import classification_report, precision_recall_fscore_support

    rng = np.random.default_rng(seed)
    labels, preds = rng.integers(0, 3, 30), rng.integers(0, 3, 30)
    if seed == 1:
        preds[preds == 1] = 0  # a class never predicted: precision 0 by zero_division
    if seed == 2:
        preds[0], labels[labels == 3] = 3, 0  # a predicted class with no true row
    classes, p, r, f1, support = rep.precision_recall_fscore(labels, preds)
    want = precision_recall_fscore_support(labels, preds, zero_division=0)
    np.testing.assert_array_equal(classes, np.union1d(labels, preds))
    for g, w in zip((p, r, f1, support), want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    names = [f"Class {int(c)}" for c in classes]
    assert rep.classification_report(labels, preds) == classification_report(
        labels, preds, target_names=names, zero_division=0)


def test_plot_writers_write_files(tmp_path):
    rng = np.random.default_rng(0)
    metrics = {split: {k: list(rng.random(4)) for k in ("loss", "a_acc", "v_acc")}
               for split in ("train", "test")}
    cm = rng.integers(0, 9, (3, 3))
    paths = [rep.plot_progress(metrics, str(tmp_path / "progress.png")),
             rep.plot_confusion_matrix(cm, str(tmp_path / "cm.png")),
             rep.plot_confusion_matrix(cm, str(tmp_path / "cm_norm.png"), normalize=True),
             rep.plot_subject_accuracies(list(rng.random(5)), str(tmp_path / "subjects.png"))]
    for path in paths:
        assert os.path.getsize(path) > 0


def test_port_imports_without_optional_packages():
    """The port's packages import with sklearn, matplotlib and pandas made
    unimportable, and import no JAX."""
    code = ("import sys\n"
            "for m in ('sklearn', 'matplotlib', 'pandas', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "import multimodal_sentiment_aanalysis_tpu_torch as p\n"
            "import multimodal_sentiment_aanalysis_tpu_torch.eval, "
            "multimodal_sentiment_aanalysis_tpu_torch.utils, "
            "multimodal_sentiment_aanalysis_tpu_torch.train\n"
            "from multimodal_sentiment_aanalysis_tpu_torch.eval import reporting\n"
            "print(reporting.classification_report([0, 1, 1], [0, 1, 0]).split()[0])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "precision"

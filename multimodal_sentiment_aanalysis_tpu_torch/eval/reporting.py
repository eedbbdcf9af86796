"""Metrics reports, plots, and the experiment-history CSV appender.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/eval/reporting.py``
(the reference's reporting toolbox, ``common/utils.py``):

- :func:`accumulate_confusion`, :func:`normalize_cm`, :class:`Myreport`:
  confusion matrices (rows are predictions, columns true labels) and the
  precision / recall / F1 read from them;
- :func:`precision_recall_fscore` and :func:`classification_report`: the
  per-class report the JAX ``Tester`` prints through sklearn, in numpy
  (sklearn's ``zero_division=0`` rule and its text layout);
- :func:`plot_progress`, :func:`plot_confusion_matrix`,
  :func:`plot_subject_accuracies`: figures written to files (Agg backend);
- :func:`parse_cm`, :func:`history2df`, :func:`save_history`: the
  experiment-history CSV appender.

Importing this module needs neither matplotlib nor pandas: the three plot
functions import matplotlib and the CSV functions pandas when called.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np

from ..config import flatten_config


def accumulate_confusion(preds, labels, conf_matrix):
    """In-place CM accumulation, ``conf_matrix[pred, true] += 1``
    (reference ``common/utils.py:19-22``)."""
    for p, t in zip(np.asarray(preds), np.asarray(labels)):
        conf_matrix[p, t] += 1
    return conf_matrix


def normalize_cm(cm: np.ndarray) -> np.ndarray:
    """Transpose (rows become true labels), row-normalise, and zero the
    cells that round to under 1% (reference ``common/utils.py:245-256``)."""
    cm = np.asarray(cm, dtype=float).T
    cm = cm / cm.sum(axis=1, keepdims=True)
    cm[np.floor(cm * 100 + 0.5).astype(int) == 0] = 0.0
    return cm


class Myreport:
    """Confusion-matrix-derived precision/recall/F1 report (reference
    ``common/utils.py:168-212``): rows are predictions, columns true
    labels; precision = diag / row-sum, recall = diag / col-sum."""

    def __init__(self):
        self._confusion: np.ndarray | None = None

    def _statistics_confusion(self, y_true, y_predict, num_cls: int):
        cm = np.zeros((num_cls, num_cls))
        for t, p in zip(np.asarray(y_true), np.asarray(y_predict)):
            cm[p][t] += 1
        self._confusion = cm

    def _acc(self):
        return np.sum(self._confusion.diagonal()) / np.sum(self._confusion)

    def _precision(self):
        return self._confusion.diagonal() / np.sum(self._confusion, axis=1)

    def _recall(self):
        return self._confusion.diagonal() / np.sum(self._confusion, axis=0)

    @staticmethod
    def _f1(pc, rc):
        return 2 * np.multiply(pc, rc) / (pc + rc)

    def report(self, y_true, y_predict, class_names) -> str:
        self._statistics_confusion(y_true, y_predict, num_cls=len(class_names))
        pc, rc = self._precision(), self._recall()
        f1 = self._f1(pc, rc)
        lines = ["Class Name\tprecision\trecall\tf1-score"]
        for i, name in enumerate(class_names):
            lines.append(f"{name}\t{pc[i]:.2f}\t{rc[i]:.2f}\t{f1[i]:.2f}")
        lines.append(f"accuracy is {self._acc():.2f}")
        return "\n".join(lines)

    def report_f1score(self, cm) -> np.ndarray:
        self._confusion = np.asarray(cm)
        pc, rc = self._precision(), self._recall()
        return self._f1(pc, rc)


# ---------------------------------------------------------------------------
# the per-class report (sklearn's, in numpy)
# ---------------------------------------------------------------------------

def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den``, 0 where ``den`` is 0 (sklearn's ``zero_division=0``)."""
    return np.divide(num, den, out=np.zeros(len(num)), where=den > 0)


def precision_recall_fscore(labels, preds) -> tuple[np.ndarray, ...]:
    """``(classes, precision, recall, f1, support)`` per class over the
    sorted union of the true and predicted labels, as sklearn's
    ``precision_recall_fscore_support(..., zero_division=0)``."""
    labels, preds = np.asarray(labels), np.asarray(preds)
    classes = np.union1d(labels, preds)
    tp = np.array([np.sum((preds == c) & (labels == c)) for c in classes], float)
    predicted = np.array([np.sum(preds == c) for c in classes], float)
    support = np.array([np.sum(labels == c) for c in classes], float)
    f1 = _ratio(2 * tp, predicted + support)
    return classes, _ratio(tp, predicted), _ratio(tp, support), f1, support.astype(int)


def classification_report(labels, preds, digits: int = 2) -> str:
    """sklearn's ``classification_report`` text for these labels, the
    classes named ``Class i``: per-class precision, recall, F1 and support,
    then accuracy, the macro and the support-weighted averages."""
    classes, p, r, f1, support = precision_recall_fscore(labels, preds)
    names = [f"Class {int(c)}" for c in classes]
    width = max(len(n) for n in [*names, "weighted avg"])
    headers = ["precision", "recall", "f1-score", "support"]
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    out = ("{:>{width}s} " + " {:>9}" * 4).format("", *headers, width=width) + "\n\n"
    for row in zip(names, p, r, f1, support):
        out += row_fmt.format(*row, width=width, digits=digits)
    total = int(support.sum())
    accuracy = float(np.mean(np.asarray(labels) == np.asarray(preds)))
    out += "\n" + ("{:>{width}s} " + " {:>9}" * 2 + " {:>9.{digits}f} {:>9}\n").format(
        "accuracy", "", "", accuracy, total, width=width, digits=digits)
    weights = support / max(total, 1)
    for name, avg in (("macro avg", lambda v: v.mean()), ("weighted avg", lambda v: v @ weights)):
        out += row_fmt.format(name, avg(p), avg(r), avg(f1), total, width=width, digits=digits)
    return out


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_progress(metrics: dict, save_path: str) -> str:
    """Loss + accuracy curves, two panels (reference
    ``MultiTaskTrainer.py:529-553``)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(15, 6))
    axes[0].plot(metrics["train"]["loss"], label="Train Loss")
    axes[0].plot(metrics["test"]["loss"], label="Test Loss")
    axes[0].set_title("Loss Curves")
    axes[0].set_xlabel("Epoch")
    axes[0].set_ylabel("Loss")
    axes[0].legend()

    axes[1].plot(metrics["train"]["a_acc"], "--", label="Train Arousal Acc")
    axes[1].plot(metrics["train"]["v_acc"], "--", label="Train Valence Acc")
    axes[1].plot(metrics["test"]["a_acc"], label="Test Arousal Acc")
    axes[1].plot(metrics["test"]["v_acc"], label="Test Valence Acc")
    axes[1].set_title("Accuracy Curves")
    axes[1].set_xlabel("Epoch")
    axes[1].set_ylabel("Accuracy")
    axes[1].legend()

    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def plot_confusion_matrix(
    cm: np.ndarray,
    save_path: str,
    class_names: list[str] | None = None,
    normalize: bool = False,
    title: str = "Confusion Matrix",
) -> str:
    """CM heatmap saved to file (reference ``Tester.py:100-110``)."""
    plt = _pyplot()
    cm = np.asarray(cm, dtype=float)
    if normalize:
        cm = cm / cm.sum(axis=1, keepdims=True)
    if class_names is None:
        class_names = [f"Class {i}" for i in range(cm.shape[0])]
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(cm, interpolation="nearest", cmap=plt.cm.Blues)
    fig.colorbar(im)
    ax.set_xticks(range(len(class_names)), class_names, rotation=45)
    ax.set_yticks(range(len(class_names)), class_names)
    fmt = "%.2f" if normalize else "%d"
    thresh = cm.max() / 2.0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, fmt % cm[i, j], ha="center",
                    color="white" if cm[i, j] > thresh else "black")
    ax.set_title(title)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def plot_subject_accuracies(subject_acc: list[float], save_path: str,
                            x_label: str = "Subject Number") -> str:
    """Per-subject accuracy bars with a trailing mean bar (reference
    ``common/utils.py:136-162``)."""
    plt = _pyplot()
    accs = list(subject_acc) + [float(np.mean(subject_acc))]
    labels = [str(i + 1) for i in range(len(subject_acc))] + ["Mean"]
    fig, ax = plt.subplots(figsize=(max(8, len(accs) * 0.7), 5))
    ax.bar(range(len(accs)), accs)
    for i, a in enumerate(accs):
        ax.text(i, a, f"{a:.2f}", ha="center", va="bottom", fontsize=10)
    ax.set_xticks(range(len(accs)), labels)
    ax.set_xlabel(x_label)
    ax.set_ylabel("Acc")
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


# ---------------------------------------------------------------------------
# experiment-history CSV appender
# ---------------------------------------------------------------------------

def parse_cm(cm_str: str) -> np.ndarray:
    """A flattened CM string (comma-joined ints, square) back to an int
    array."""
    values = list(map(int, re.findall(r"-?\d+", cm_str)))
    n = int(round(len(values) ** 0.5))
    return np.array(values).reshape(n, n)


def history2df(history: dict):
    """Per-subject history -> DataFrame with Mean/Std rows (reference
    ``common/utils.py:289-338``)."""
    import pandas as pd

    rows = []
    for subject, d in history.items():
        cm_str = ",".join(map(str, np.asarray(d["cm"]).flatten()))
        rows.append([subject, d["epoch"], d["acc"], d["loss"], d["f1-score"], cm_str])
    for name, fn in (("Mean", np.mean), ("Std", np.std)):
        rows.append([name, fn([d["epoch"] for d in history.values()]),
                     fn([d["acc"] for d in history.values()]),
                     fn([d["loss"] for d in history.values()]),
                     fn([d["f1-score"] for d in history.values()]), None])
    return pd.DataFrame(rows, columns=["subject", "epoch", "acc", "loss", "f1-score", "cm"])


def save_history(config: dict, data_name: str, timestamp: str, history: dict) -> str:
    """Append one experiment row (flattened config + per-subject acc/f1) to
    the history CSV in ``config["logging"]["log_dir"]`` whose columns
    match; create a new file otherwise (reference
    ``common/utils.py:341-412``). ``config`` is a nested dict, or anything
    with ``to_dict()``."""
    import pandas as pd

    if hasattr(config, "to_dict"):
        config = config.to_dict()
    save_dir = Path(config["logging"]["log_dir"])
    os.makedirs(save_dir, exist_ok=True)

    flat = {"timestamp": timestamp, **flatten_config(config)}
    config_df = pd.DataFrame(flat, index=[0])

    metric_df = history2df(history)
    cm_total = np.sum([parse_cm(s) for s in metric_df["cm"].dropna()], axis=0)
    cm_str = np.array2string(cm_total, separator=",")

    fmt = metric_df.drop(columns=["epoch", "loss", "cm"]).set_index("subject").T
    fmt = fmt.map(lambda x: f"{x:.4f}")
    combined = fmt.loc["acc"] + "/" + fmt.loc["f1-score"]
    new_df = pd.DataFrame([combined]).reset_index(drop=True)
    config_df = pd.concat([config_df, new_df], axis=1)

    config_df = config_df.rename(columns={"Mean": "Acc/Std", "Std": "F1/Std"})
    config_df["cm"] = cm_str

    existing = [save_dir / f for f in os.listdir(save_dir) if f.startswith("history")]
    for path in existing:
        old_df = pd.read_csv(path)
        if old_df.columns.astype(str).equals(config_df.columns.astype(str)):
            config_df.to_csv(path, mode="a", header=False, index=False)
            return str(path)

    training = config["training"]
    folds = training["n_folds"] if training["dependent"] else len(
        config["data"]["HCI"]["subject_lists"])
    path = save_dir / f"history_{data_name}_{folds}_{len(existing)}.csv"
    config_df.to_csv(path, index=False)
    return str(path)

"""Evaluation of a saved model.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/eval/tester.py``
(reference ``Tester.py:9-133``), for the dual-head flagship model:

- :meth:`Tester.load_model`: a torch checkpoint (``.pt``/``.pth``: a
  reference ``state_dict``, a dict holding one under ``"state_dict"``, or
  one with the DataParallel ``module.`` prefix) loaded strictly into the
  model;
- :meth:`Tester.evaluate`: the eval-mode forward over the test set in plan
  order (the tail batch wrap-padded and trimmed), on the data's device
  (through the BiLSTM and stem-tail kernels on a card); per head the CE
  loss over every row, the accuracy, the predictions, labels and softmax
  probabilities, all moved to the host once after the loop; with
  ``verbose`` the per-class report (:func:`.reporting.classification_report`,
  no sklearn) and, under ``plot_dir``, each head's confusion matrix as
  ``confusion_{head}.png``;
- :meth:`Tester.predict_single`: one sample at B=1;
- :meth:`Tester.run`: load, then evaluate.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

from ..data.pipeline import DeviceDataset
from ..ops.losses import masked_cross_entropy
from ..utils.checkpoint import load_state_dict, strip_module_prefix
from .reporting import accumulate_confusion, classification_report, plot_confusion_matrix

HEADS = ("arousal", "valence")


class Tester:
    def __init__(self, model: nn.Module, test_data: DeviceDataset,
                 state_dict: dict | None = None):
        if any(p.device != test_data.device for p in model.parameters()):
            raise ValueError(f"the model's parameters must be on the data's device "
                             f"{test_data.device}")
        self.model = model
        self.test_data = test_data
        if state_dict is not None:
            model.load_state_dict(strip_module_prefix(dict(state_dict)), strict=True)

    def load_model(self, model_path: str) -> None:
        """Load a torch checkpoint strictly into the model."""
        if str(model_path).endswith(".msgpack"):
            raise ValueError(f"{model_path} is in the JAX package's msgpack format; the port "
                             f"loads torch .pt/.pth state_dicts")
        self.model.load_state_dict(load_state_dict(model_path, self.test_data.device),
                                   strict=True)
        print(f"Loaded model weights from {model_path}")

    @torch.no_grad()
    def _logits(self, eeg: torch.Tensor, eye: torch.Tensor, pps: torch.Tensor) -> torch.Tensor:
        """``(B, 2, C)``: both heads' logits of the eval-mode forward."""
        self.model.eval()
        return torch.stack(self.model(eeg, eye, pps), 1)

    def evaluate(self, verbose: bool = True, batch_size: int = 64,
                 plot_dir: str | None = ".") -> dict:
        data, n = self.test_data, len(self.test_data)
        plan_idx, _ = data.epoch_plan(batch_size, shuffle=False)
        logits = []
        for idx in plan_idx:
            batch = data.gather(idx)
            logits.append(self._logits(batch["eeg"], batch["eye"], batch["pps"]))
        logits = torch.cat(logits)[:n].float().cpu()  # the one read-back
        results = {}
        for h, head in enumerate(HEADS):
            labels = data.arrays[head][:n].cpu()
            preds = logits[:, h].argmax(1).numpy()
            loss = masked_cross_entropy(logits[:, h], labels, torch.ones(n))
            results[head] = {
                "loss": float(loss),
                "accuracy": float((preds == labels.numpy()).mean()),
                "predictions": preds,
                "labels": labels.numpy(),
                "probabilities": torch.softmax(logits[:, h], 1).numpy(),
            }
        if verbose:
            self._print_metrics(results)
            if plot_dir is not None:
                for head in HEADS:
                    self._plot_confusion_matrix(
                        results[head]["labels"], results[head]["predictions"],
                        logits.shape[-1], os.path.join(plot_dir, f"confusion_{head}.png"))
        return results

    @staticmethod
    def _print_metrics(results: dict) -> None:
        print("=" * 40)
        for head, r in results.items():
            print(f"[{head}] loss {r['loss']:.4f} accuracy {r['accuracy']:.2%}")
            print(classification_report(r["labels"], r["predictions"]))
        print("=" * 40)

    @staticmethod
    def _plot_confusion_matrix(labels, preds, n_classes: int, save_path: str) -> str:
        """Rows true labels, columns predictions (sklearn's layout, which
        the JAX Tester plots)."""
        cm = accumulate_confusion(preds, labels, np.zeros((n_classes, n_classes), np.int64))
        return plot_confusion_matrix(cm.T, save_path)

    def predict_single(self, data_dict: dict[str, np.ndarray]) -> dict:
        """One-sample prediction at B=1 (reference ``Tester.py:112-127``),
        dual-head."""
        device = self.test_data.device
        x = [torch.as_tensor(np.asarray(data_dict[k]), device=device)[None]
             for k in ("eeg", "eye", "pps")]
        logits = self._logits(*x)[0].float().cpu()
        return {head: {"prediction": int(logits[h].argmax()),
                       "probabilities": torch.softmax(logits[h], 0).numpy()}
                for h, head in enumerate(HEADS)}

    def run(self, model_path: str | None = None, **kwargs) -> dict:
        if model_path is not None:
            self.load_model(model_path)
        return self.evaluate(**kwargs)

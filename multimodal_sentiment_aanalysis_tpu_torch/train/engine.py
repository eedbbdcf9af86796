"""Single-subject trainer.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/engine.py::Trainer``
(reference ``Trainer.py:9-263``), the same train step for one model:

- AdamW(lr 1e-4, weight decay 0.01) over the model's parameters, and a
  trainer-level learnable ``contrastive_weight`` in its own param group;
- loss = CE(arousal) + CE(valence) + contrastive_weight * (c_eeg + c_eye +
  c_pps), CE masked to the real rows of a wrap-padded batch, on
  ``nan_to_num``-ed logits;
- global-norm clip 1.0; a non-finite loss skips the batch (params,
  optimizer state and BN running stats stay as they were, and the batch
  adds nothing to the epoch's metrics);
- epoch plans from ``numpy.random.default_rng(seed)`` drawn exactly as the
  JAX trainer draws them, so both packages see the same batches;
- :meth:`run`: ReduceLROnPlateau (patience 3, x0.5) on the test loss and
  early stopping (patience 5), saving the best model as a torch
  ``state_dict`` with the reference names;
- :meth:`save_state` / :meth:`restore_state`: the full state (JAX
  ``engine.py:198-256``), from which training resumes as if it had not
  stopped; :meth:`test_with_loaded_model` re-evaluates a saved model.

Dropout draws from a ``torch.Generator`` on the data's device seeded with
``seed``; the stem tail's dropout seeds come from it too, so its state
covers the kernel's masks.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn as nn

from ..data.pipeline import DeviceDataset
from ..ops.losses import masked_accuracy, masked_cross_entropy
from ..utils.checkpoint import (
    copy_state_,
    generator_state,
    load_checkpoint,
    load_state_dict,
    metrics_checkpoint_name,
    save_checkpoint,
    set_generator_state,
)
from ..utils.schedule import EarlyStopping, ReduceLROnPlateau
from .state import RunningStatsSnapshot, clip_by_global_norm, make_adamw, set_learning_rate

Metrics = tuple[float, float, float, float]  # loss, CE, contrastive, arousal accuracy
HISTORIES = ("train_loss", "test_loss", "train_acc", "test_acc")


class Trainer:
    def __init__(
        self,
        model: nn.Module,
        train_data: DeviceDataset,
        test_data: DeviceDataset,
        lr: float = 1e-4,
        weight_decay: float = 0.01,
        batch_size: int = 64,
        clip_norm: float = 1.0,
        patience: int = 5,
        seed: int = 42,
        checkpoint_dir: str = ".",
        verbose: bool = True,
    ):
        self.device = train_data.device
        if any(p.device != self.device for p in model.parameters()):
            raise ValueError(f"the model's parameters must be on the data's device {self.device}")
        self.model = model
        self.train_data = train_data
        self.test_data = test_data
        self.batch_size = batch_size
        self.clip_norm = clip_norm
        self.checkpoint_dir = checkpoint_dir
        self.verbose = verbose

        self.host_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # trainer-level learnable contrastive weight, its own param group
        # (reference :24-26), on top of the model's own
        self.contrastive_weight = nn.Parameter(torch.ones(1, device=self.device))
        self.params = [*model.parameters(), self.contrastive_weight]
        self.optimizer = make_adamw(
            [{"params": list(model.parameters())}, {"params": [self.contrastive_weight]}],
            lr, weight_decay)
        self.scheduler = ReduceLROnPlateau(lr=lr, patience=3, factor=0.5)
        self.early = EarlyStopping(patience=patience)

        self.train_loss: list[float] = []
        self.test_loss: list[float] = []
        self.train_acc: list[float] = []
        self.test_acc: list[float] = []

    # ------------------------------------------------------------------
    def _loss(self, batch: dict[str, torch.Tensor],
              mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(loss, metric sums)``; the sums are per-sample means times the
        number of real rows: loss, CE, contrastive, arousal and valence
        accuracy, rows."""
        arousal, valence, c1, c2, c3 = self.model(
            batch["eeg"], batch["eye"], batch["pps"],
            labels=(batch["arousal"], batch["valence"], mask), generator=self.generator)
        # NaN-output guard (reference :63-65)
        arousal, valence = torch.nan_to_num(arousal), torch.nan_to_num(valence)
        ce = (masked_cross_entropy(arousal, batch["arousal"], mask)
              + masked_cross_entropy(valence, batch["valence"], mask))
        contrastive = c1 + c2 + c3
        loss = ce + self.contrastive_weight[0] * contrastive
        n = mask.sum()
        sums = torch.stack([loss, ce, contrastive,
                            masked_accuracy(arousal, batch["arousal"], mask),
                            masked_accuracy(valence, batch["valence"], mask)]).detach() * n
        return loss, torch.cat([sums, n[None]])

    def _train_step(self, batch: dict[str, torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
        stats = RunningStatsSnapshot(self.model)
        loss, sums = self._loss(batch, mask)
        if not bool(torch.isfinite(loss)):  # skip the batch (reference :74-76)
            stats.restore()
            return torch.zeros_like(sums)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm(self.params, self.clip_norm)
        self.optimizer.step()
        return sums

    @staticmethod
    def _means(sums: torch.Tensor) -> Metrics:
        loss, ce, con, a_acc, _, n = sums.tolist()
        n = max(n, 1.0)
        return loss / n, ce / n, con / n, a_acc / n

    def train_epoch(self, epoch: int) -> Metrics:
        """One pass over a shuffled plan of the training set; returns the
        per-sample ``(loss, ce, contrastive, arousal accuracy)``."""
        plan_idx, plan_mask = self.train_data.epoch_plan(self.batch_size, self.host_rng,
                                                         shuffle=True)
        self.model.train()
        sums = torch.zeros(6, device=self.device)
        for idx, mask in zip(plan_idx, plan_mask):
            sums += self._train_step(self.train_data.gather(idx), mask)
        out = self._means(sums)
        self.train_loss.append(out[0])
        self.train_acc.append(out[3])
        return out

    @torch.no_grad()
    def _eval_metrics(self) -> Metrics:
        """Per-sample means over the test set in eval mode (the tail batch
        masked, as in the JAX trainer)."""
        plan_idx, plan_mask = self.test_data.epoch_plan(self.batch_size, shuffle=False)
        self.model.eval()
        sums = torch.zeros(6, device=self.device)
        for idx, mask in zip(plan_idx, plan_mask):
            sums += self._loss(self.test_data.gather(idx), mask)[1]
        return self._means(sums)

    def test(self) -> Metrics:
        out = self._eval_metrics()
        self.test_loss.append(out[0])
        self.test_acc.append(out[3])
        return out

    # ------------------------------------------------------------------
    # full-state checkpoint and resume
    def save_state(self, path: str) -> str:
        """Write the model's ``state_dict`` and the trainer-level
        contrastive weight, the AdamW state, the dropout generator's and the
        host generator's states, the plateau and early-stop fields and the
        four histories."""
        return save_checkpoint(path, {
            "model": self.model.state_dict(),
            "contrastive_weight": self.contrastive_weight.detach(),
            "optimizer": self.optimizer.state_dict(),
            "generator": generator_state(self.generator),
            "host_rng": self.host_rng.bit_generator.state,
            "scheduler": dataclasses.asdict(self.scheduler),
            "early": dataclasses.asdict(self.early),
            **{k: list(getattr(self, k)) for k in HISTORIES},
        })

    def restore_state(self, path: str) -> None:
        """Restore :meth:`save_state`'s file, written on either device type,
        into this trainer's tensors in place."""
        state = load_checkpoint(path, "cpu")
        set_generator_state(self.generator, state["generator"], "generator")
        self.model.load_state_dict(state["model"], strict=True)
        copy_state_(self.contrastive_weight, state["contrastive_weight"], "contrastive_weight")
        self.optimizer.load_state_dict(state["optimizer"])
        self.host_rng.bit_generator.state = state["host_rng"]
        self.scheduler = ReduceLROnPlateau(**state["scheduler"])
        self.early = EarlyStopping(**state["early"])
        for k in HISTORIES:
            setattr(self, k, list(state[k]))

    def test_with_loaded_model(self, model_path: str, report: bool = False) -> Metrics:
        """Load a model checkpoint (what :meth:`run` saves: the model's
        ``state_dict``, without the trainer-level contrastive weight) and
        re-evaluate the test set (reference ``Trainer.py:192-243``): returns
        ``(loss, ce, contrastive, arousal accuracy)`` and prints the same
        summary line. ``report=True`` also prints the :class:`..eval.Tester`
        report and writes its confusion matrices to ``checkpoint_dir``."""
        self.model.load_state_dict(load_state_dict(model_path, self.device), strict=True)
        loss, ce, con, acc = self._eval_metrics()
        print(f"Test Loss: {loss:.4f}, CE Loss: {ce:.4f}, "
              f"Contrastive Loss: {con:.4f}, Acc: {acc:.4f}")
        if report:
            from ..eval.tester import Tester

            Tester(self.model, self.test_data).evaluate(verbose=True,
                                                        plot_dir=self.checkpoint_dir)
        return loss, ce, con, acc

    def _save(self, name: str) -> None:
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        torch.save(self.model.state_dict(), os.path.join(self.checkpoint_dir, name))

    def run(self, epochs: int, test_person: int) -> None:
        for epoch in range(1, epochs + 1):
            tr = self.train_epoch(epoch)
            te = self.test()
            if np.isfinite(te[0]):
                set_learning_rate(self.optimizer, self.scheduler.step(te[0]))
            if self.verbose:
                print(f"Epoch {epoch}: Train loss {tr[0]:.4f} CE {tr[1]:.4f} "
                      f"Con {tr[2]:.4f} Acc {tr[3]:.4f} | Test loss {te[0]:.4f} "
                      f"CE {te[1]:.4f} Con {te[2]:.4f} Acc {te[3]:.4f}")
            if self.early.step(te[0]):
                # the model's own state_dict: the trainer-level contrastive
                # weight is a separate param group, as in the reference
                self._save("best_model.pt")
            if self.early.should_stop:
                if self.verbose:
                    print(f"Early stopping triggered at epoch {epoch}")
                self._save(metrics_checkpoint_name(
                    f"TestPerson{test_person}_epoch{epoch}",
                    {"TrainLoss": tr[0], "TrainAcc": tr[3], "TestLoss": te[0],
                     "TestAcc": te[3]}))
                break

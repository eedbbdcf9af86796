"""Training control: plateau LR schedule and early stopping.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/utils/schedule.py``, in
its two forms:

- plain-Python copies of the host dataclasses (torch ReduceLROnPlateau in
  mode 'min' with a relative threshold, and the best-loss/patience early
  stop of the reference ``Trainer.py:107-117``), for the single-subject
  trainer;
- the branchless vectorized transition (:func:`vector_schedule_init`,
  :func:`vector_schedule_step`) for the LOSO trainer: every per-subject
  scalar an ``(S,)`` device tensor and every ``if`` a ``torch.where``, so
  the schedules of all subjects advance on the device with no host sync.
  ``stop_epoch`` keeps JAX's meaning: 0 for a subject that never stopped.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ReduceLROnPlateau:
    lr: float
    patience: int = 3
    factor: float = 0.5
    min_lr: float = 0.0
    threshold: float = 1e-4  # torch default rel threshold
    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        """Feed one epoch's metric; returns the (possibly reduced) LR."""
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr


@dataclass
class EarlyStopping:
    patience: int = 5
    best: float = float("inf")
    counter: int = 0
    should_stop: bool = False

    def step(self, val_loss: float) -> bool:
        """Returns True when the new loss is an improvement (save point)."""
        if val_loss < self.best:
            self.best = val_loss
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.should_stop = True
        return False


def vector_schedule_init(n: int, lr: float, device=None) -> dict[str, torch.Tensor]:
    """Per-subject schedule state of ``n`` models, every lane at the host
    dataclasses' initial values."""
    full = lambda v, dtype: torch.full((n,), v, dtype=dtype, device=device)
    return {
        "lr": full(lr, torch.float32),
        "plateau_best": full(float("inf"), torch.float32),
        "plateau_bad": full(0, torch.int32),
        "es_best": full(float("inf"), torch.float32),
        "es_counter": full(0, torch.int32),
        "stopped": full(False, torch.bool),
        "stop_epoch": full(0, torch.int32),
    }


def vector_schedule_step(state: dict[str, torch.Tensor], te_loss: torch.Tensor, epoch: int, *,
                         es_patience: int = 5, plateau_patience: int = 3,
                         plateau_factor: float = 0.5, plateau_threshold: float = 1e-4,
                         min_lr: float = 0.0) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """One epoch's transition for every subject at once: the body of
    ``Trainer.run``'s epoch loop (ReduceLROnPlateau fed finite losses only, then
    EarlyStopping, where a NaN counts as no improvement). Stopped lanes stay
    frozen. ``epoch`` is 1-based. Returns ``(new state, improved)``, where
    ``improved`` flags the lanes whose early-stop best just improved (the
    best-checkpoint save points)."""
    active = ~state["stopped"]
    te_loss = te_loss.to(torch.float32)
    where = torch.where

    # ReduceLROnPlateau.step, finite-gated like Trainer.run
    pl_act = active & torch.isfinite(te_loss)
    pl_improved = te_loss < state["plateau_best"] * (1.0 - plateau_threshold)
    bad = where(pl_improved, 0, state["plateau_bad"] + 1).to(torch.int32)
    reduce = bad > plateau_patience
    lr = where(pl_act & reduce, torch.clamp(state["lr"] * plateau_factor, min=min_lr),
               state["lr"])
    plateau_best = where(pl_act & pl_improved, te_loss, state["plateau_best"])
    plateau_bad = where(pl_act, where(reduce, 0, bad), state["plateau_bad"]).to(torch.int32)

    # EarlyStopping.step (a NaN te_loss falls into the non-improved branch)
    es_improved = active & (te_loss < state["es_best"])
    counter = where(active, where(es_improved, 0, state["es_counter"] + 1),
                    state["es_counter"]).to(torch.int32)
    newly_stopped = active & (counter >= es_patience)
    return {
        "lr": lr,
        "plateau_best": plateau_best,
        "plateau_bad": plateau_bad,
        "es_best": where(es_improved, te_loss, state["es_best"]),
        "es_counter": counter,
        "stopped": state["stopped"] | newly_stopped,
        "stop_epoch": where(newly_stopped, epoch, state["stop_epoch"]).to(torch.int32),
    }, es_improved

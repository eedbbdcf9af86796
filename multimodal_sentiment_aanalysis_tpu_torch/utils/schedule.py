"""Training control: plateau LR schedule and early stopping.

Plain-Python copies of the host dataclasses in
``multimodal_sentiment_aanalysis_tpu/utils/schedule.py`` (torch
ReduceLROnPlateau in mode 'min' with a relative threshold, and the
best-loss/patience early stop of the reference ``Trainer.py:107-117``).
"""

from __future__ import annotations

from dataclasses import dataclass


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

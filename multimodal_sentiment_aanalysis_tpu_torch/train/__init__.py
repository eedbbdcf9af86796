from .engine import Trainer
from .state import (
    StackedAdamW,
    clip_by_global_norm,
    clip_rows_by_global_norm,
    make_adamw,
    set_learning_rate,
)
from .vloso import VectorizedLOSOTrainer

__all__ = [
    "StackedAdamW",
    "Trainer",
    "VectorizedLOSOTrainer",
    "clip_by_global_norm",
    "clip_rows_by_global_norm",
    "make_adamw",
    "set_learning_rate",
]

from .engine import Trainer
from .memhacl import memhacl_finetune, memhacl_logits, memhacl_pretrain
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
    "memhacl_finetune",
    "memhacl_logits",
    "memhacl_pretrain",
    "set_learning_rate",
]

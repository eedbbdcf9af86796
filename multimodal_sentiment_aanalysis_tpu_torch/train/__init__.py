from .engine import Trainer
from .memhacl import memhacl_finetune, memhacl_logits, memhacl_pretrain
from .multitask import (
    ENCODER_MODULES,
    FUSION_MODULES,
    METRIC_KEYS,
    PHASE_ORDER,
    PHASES,
    MultiTaskTrainer,
    PhaseSpec,
    make_phase_loss,
)
from .simclr import contrastive_pretrain, finetune
from .state import (
    RowLayout,
    StackedAdamW,
    apply_grad_mask,
    clip_by_global_norm,
    clip_rows_by_global_norm,
    make_adamw,
    make_masked_adamw,
    module_mask,
    set_learning_rate,
)
from .vloso import VectorizedLOSOTrainer
from .vphased import VectorizedPhasedTrainer
from .vsimclr import VectorizedSimCLRTrainer

__all__ = [
    "ENCODER_MODULES",
    "FUSION_MODULES",
    "METRIC_KEYS",
    "MultiTaskTrainer",
    "PHASES",
    "PHASE_ORDER",
    "PhaseSpec",
    "RowLayout",
    "StackedAdamW",
    "Trainer",
    "VectorizedLOSOTrainer",
    "VectorizedPhasedTrainer",
    "VectorizedSimCLRTrainer",
    "apply_grad_mask",
    "clip_by_global_norm",
    "clip_rows_by_global_norm",
    "contrastive_pretrain",
    "finetune",
    "make_adamw",
    "make_masked_adamw",
    "make_phase_loss",
    "memhacl_finetune",
    "memhacl_logits",
    "memhacl_pretrain",
    "module_mask",
    "set_learning_rate",
]

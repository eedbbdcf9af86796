from .engine import Trainer
from .state import clip_by_global_norm, make_adamw, set_learning_rate

__all__ = ["Trainer", "clip_by_global_norm", "make_adamw", "set_learning_rate"]

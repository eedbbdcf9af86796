from .losses import (
    masked_accuracy,
    masked_cross_entropy,
    supervised_infonce,
    supervised_infonce_multi,
)
from .rnn import bilstm_layer, bilstm_recurrence, lstm

__all__ = [
    "bilstm_layer",
    "bilstm_recurrence",
    "lstm",
    "masked_accuracy",
    "masked_cross_entropy",
    "supervised_infonce",
    "supervised_infonce_multi",
]

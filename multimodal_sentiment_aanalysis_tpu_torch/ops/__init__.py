from .losses import (
    cross_entropy,
    masked_accuracy,
    masked_cross_entropy,
    ntxent_indexed,
    ntxent_supervised_two_view,
    supervised_infonce,
    supervised_infonce_multi,
)
from .rnn import bilstm_layer, bilstm_recurrence, lstm

__all__ = [
    "bilstm_layer",
    "bilstm_recurrence",
    "cross_entropy",
    "lstm",
    "masked_accuracy",
    "masked_cross_entropy",
    "ntxent_indexed",
    "ntxent_supervised_two_view",
    "supervised_infonce",
    "supervised_infonce_multi",
]

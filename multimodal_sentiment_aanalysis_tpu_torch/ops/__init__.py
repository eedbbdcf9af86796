from .rnn import bilstm_layer, bilstm_recurrence, lstm

__all__ = ["bilstm_layer", "bilstm_recurrence", "lstm"]

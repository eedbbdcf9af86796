from .cross_modal import CrossModalTransformer
from .eeg import BiLSTM, EEGMultiScaleNet
from .fusion_model import MultimodalTransformerModel
from .jax_import import state_dict_from_jax_variables, trainer_state_from_jax
from .layers import (
    MultiheadAttention,
    PositionalEncoding,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from .subnetwork import Subnetwork

__all__ = [
    "BiLSTM",
    "CrossModalTransformer",
    "EEGMultiScaleNet",
    "MultiheadAttention",
    "MultimodalTransformerModel",
    "PositionalEncoding",
    "Subnetwork",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "state_dict_from_jax_variables",
    "trainer_state_from_jax",
]

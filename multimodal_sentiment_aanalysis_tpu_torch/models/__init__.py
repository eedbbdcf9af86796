from .cross_modal import CrossModalTransformer
from .eeg import BiLSTM, EEGMultiScaleNet
from .fusion_model import MultimodalTransformerModel
from .jax_import import (
    classifier_state_dict_from_jax,
    memhacl_encoder_state_dict_from_jax,
    phased_state_from_jax,
    projection_head_state_dict_from_jax,
    state_dict_from_jax_variables,
    trainer_state_from_jax,
)
from .layers import (
    MultiheadAttention,
    PositionalEncoding,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from .memhacl import MEMHACLClassifier, MEMHACLEncoder
from .simclr import ProjectionHead
from .subnetwork import Subnetwork

__all__ = [
    "BiLSTM",
    "CrossModalTransformer",
    "EEGMultiScaleNet",
    "MEMHACLClassifier",
    "MEMHACLEncoder",
    "MultiheadAttention",
    "MultimodalTransformerModel",
    "PositionalEncoding",
    "ProjectionHead",
    "Subnetwork",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "classifier_state_dict_from_jax",
    "memhacl_encoder_state_dict_from_jax",
    "phased_state_from_jax",
    "projection_head_state_dict_from_jax",
    "state_dict_from_jax_variables",
    "trainer_state_from_jax",
]

from .cross_modal import CrossModalTransformer
from .eeg import BiLSTM, EEGMultiScaleNet
from .fusion_model import MultimodalTransformerModel
from .jax_import import (
    classifier_state_dict_from_jax,
    memhacl_encoder_state_dict_from_jax,
    phased_state_from_jax,
    projection_head_state_dict_from_jax,
    simclr_encoder_state_dict_from_jax,
    simclr_state_from_jax,
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
from .simclr import Classifier, EyeMLPNet, MultiModalEncoder, PPSMLPNet, ProjectionHead
from .subnetwork import Subnetwork

__all__ = [
    "BiLSTM",
    "Classifier",
    "CrossModalTransformer",
    "EEGMultiScaleNet",
    "EyeMLPNet",
    "MEMHACLClassifier",
    "MEMHACLEncoder",
    "MultiModalEncoder",
    "MultiheadAttention",
    "MultimodalTransformerModel",
    "PPSMLPNet",
    "PositionalEncoding",
    "ProjectionHead",
    "Subnetwork",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "classifier_state_dict_from_jax",
    "memhacl_encoder_state_dict_from_jax",
    "phased_state_from_jax",
    "projection_head_state_dict_from_jax",
    "simclr_encoder_state_dict_from_jax",
    "simclr_state_from_jax",
    "state_dict_from_jax_variables",
    "trainer_state_from_jax",
]

"""PyTorch + CUDA port of the multimodal sentiment framework, for the H100.

Sits beside the JAX package ``multimodal_sentiment_aanalysis_tpu`` (the
reference, which this package never imports) and mirrors its layout. This
first slice is the serving path of the flagship
:class:`~.models.MultimodalTransformerModel`: the eval model forward and
:func:`~.eval.build_serving_forward`. Its hand-written Hopper kernels live
in ``csrc/`` and are built on first use (:mod:`.kernels`).
"""

from .eval import build_serving_forward
from .kernels import build_all, launch_counts, reset_launch_counts
from .models import MultimodalTransformerModel, state_dict_from_jax_variables

__all__ = [
    "MultimodalTransformerModel",
    "build_all",
    "build_serving_forward",
    "launch_counts",
    "reset_launch_counts",
    "state_dict_from_jax_variables",
]

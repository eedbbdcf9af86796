"""PyTorch + CUDA port of the multimodal sentiment framework, for the H100.

Sits beside the JAX package ``multimodal_sentiment_aanalysis_tpu`` (the
reference, which this package never imports) and mirrors its layout. Ported
so far, for the flagship :class:`~.models.MultimodalTransformerModel`:

- serving: the eval model forward and :func:`~.eval.build_serving_forward`
  (fp32, or bf16 with ``compute_dtype=torch.bfloat16``);
- training: the single-subject :class:`~.train.Trainer` (the JAX
  ``train/engine.py`` step: CE on both heads plus three supervised InfoNCE
  losses, AdamW, global-norm clip, NaN skip) with its data copies, and the
  24-subject :class:`~.train.VectorizedLOSOTrainer`, in fp32 or in bf16
  mixed precision (fp32 master parameters, optionally bf16 AdamW moments);
- the reference's main stack, the 5-phase curriculum: the one-subject
  :class:`~.train.MultiTaskTrainer` and the 24-subject
  :class:`~.train.VectorizedPhasedTrainer` (per-phase grad and update
  masks, per-epoch optimizer reset), in fp32 or bf16.

And the ME-MHACL stack (:mod:`.models.memhacl`, :mod:`.train.memhacl`):
NT-Xent pretrain and joint finetune, its validation forward on the card
through the fused fusion-head kernel. ``MultiheadAttention`` above length 8
runs the flash-attention kernels.

Its hand-written Hopper kernels live in ``csrc/`` and are built on first
use (:mod:`.kernels`).

Users start it from the command line, ``python -m
multimodal_sentiment_aanalysis_tpu_torch.cli`` (:mod:`.cli`: ``inspect``,
``vloso``, ``single``, ``phased``, ``simclr``, ``memhacl``, ``eval``), on the
card unless given ``--device cpu``; the host data layer it reads through
(:class:`~.data.RawData`, the splits, :func:`~.data.load_data`) and
:class:`~.config.Config` are numpy and PyTorch only.
"""

from .eval import build_serving_forward
from .kernels import build_all, launch_counts, reset_launch_counts
from .models import MultimodalTransformerModel, state_dict_from_jax_variables
from .train import Trainer

__all__ = [
    "MultimodalTransformerModel",
    "Trainer",
    "build_all",
    "build_serving_forward",
    "launch_counts",
    "reset_launch_counts",
    "state_dict_from_jax_variables",
]

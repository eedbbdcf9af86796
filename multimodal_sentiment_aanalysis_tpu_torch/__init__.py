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

A trained model leaves the process as a ``state_dict`` or as a
``torch.export`` serving artifact (:mod:`.eval.export`, ``cli export``),
which runs with torch and the op library (:mod:`.kernels.library`) alone;
:mod:`.eval.quantization` builds the int8 serving forward. The names below
import their submodule on first use.
"""

import importlib

# name -> submodule: imported on first use (PEP 562), so that a process that
# loads an exported artifact (``kernels.library``) imports no model code
_LAZY = {
    "MultimodalTransformerModel": "models",
    "Trainer": "train",
    "build_all": "kernels",
    "build_serving_forward": "eval",
    "launch_counts": "kernels",
    "reset_launch_counts": "kernels",
    "state_dict_from_jax_variables": "models",
}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)


__all__ = sorted(_LAZY)

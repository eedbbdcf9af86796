"""Serialized deployment artifacts of the serving forward (``torch.export``).

Counterpart of ``multimodal_sentiment_aanalysis_tpu/eval/export.py``. A
trained model exports to one self-contained artifact: the traced program of
:class:`.serving.ServingModule` with the weights baked in as constants,
written by ``torch.export.save``. :func:`load_serving` calls it from a
process that has imported nothing of this package but its op library
(:mod:`..kernels.library`): no model, trainer or serving code.

- ``batch_size=None`` exports a batch-polymorphic program (the leading
  dimension is ``torch.export.Dim("b")``): one artifact serves any batch,
  batch 1 included. As in the JAX package, a polymorphic export forces
  ``use_pallas=False``: the conv stem then runs ``F.conv1d``, and only the
  BiLSTM's op sits in the graph.
- ``compute_dtype=torch.bfloat16`` bakes the cast-once bf16 weights in; the
  artifact takes fp32 inputs and returns fp32 logits.
- The JAX ``platforms=`` (lowering for several backends at once) is not
  ported. The graph's kernel nodes are the custom ops ``msa_torch::*``,
  which dispatch by device, and the constants live on the device the model
  was on at export: an artifact exported from the card runs on the card
  (its ops launch the kernels, and their counters move), one exported from
  the CPU runs on the CPU (the ops' plain versions).
"""

from __future__ import annotations

import io
import os
from typing import Callable, Mapping

import torch
import torch.nn as nn

from ..kernels import library  # noqa: F401  (registers msa_torch::*, which artifacts call)

#: input schema of the serving forward, (trailing shape, dtype) per argument:
#: the reference's modality shapes (printData.py:27-29)
INPUT_SCHEMA = (
    ((32, 585), torch.float32),  # eeg
    ((38,), torch.float32),      # eye
    ((230,), torch.float32),     # pps
)
# the example batch a polymorphic export traces at: above 1, so that the
# trace does not specialise the batch to 0 or 1
_EXAMPLE_BATCH = 2


def export_serving(state_or_model: nn.Module | Mapping[str, torch.Tensor],
                   path: str | os.PathLike | None = None, *, batch_size: int | None = None,
                   feat_dim: int = 256, use_pallas: bool = False,
                   compute_dtype: torch.dtype | None = None, input_schema=None,
                   lstm_schedule: str = "v9") -> bytes:
    """Export the serving forward of a model (or its ``state_dict``) to a
    ``torch.export`` artifact; returns its bytes and writes them to ``path``
    where given.

    ``batch_size=None`` (the default) exports batch-polymorphic, and then
    ``use_pallas`` is forced off. ``input_schema`` overrides
    :data:`INPUT_SCHEMA` for other model dims (the CLI's ``--tiny``).
    ``feat_dim``, ``use_pallas``, ``compute_dtype`` and ``lstm_schedule``
    are :func:`.serving.build_serving_forward`'s. The artifact runs on the
    device the weights are on."""
    from .serving import ServingModule

    if input_schema is None:
        input_schema = INPUT_SCHEMA
    if batch_size is None:
        use_pallas = False  # a symbolic batch takes the F.conv1d stem, as in JAX
    module = ServingModule(state_or_model, feat_dim, use_pallas, compute_dtype, lstm_schedule)
    b = _EXAMPLE_BATCH if batch_size is None else batch_size
    args = tuple(torch.zeros((b, *shape), dtype=dtype, device=module.device)
                 for shape, dtype in input_schema)
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("b")
        dynamic = tuple({0: batch} for _ in args)
    with torch.no_grad():
        program = torch.export.export(module, args, dynamic_shapes=dynamic, strict=False)
    # the traced zeros would be stored beside the weights (4.9 MB at batch
    # 64); nothing that loads an artifact reads them
    program.example_inputs = None
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    blob = buffer.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_serving(path_or_bytes: str | os.PathLike | bytes | bytearray
                 ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                               tuple[torch.Tensor, torch.Tensor]]:
    """Load an artifact of :func:`export_serving` into ``(eeg, eye, pps) ->
    (arousal, valence)``, run under ``no_grad``. Needs torch and the op
    library, which this module imports, and no model code."""
    source = (io.BytesIO(bytes(path_or_bytes)) if isinstance(path_or_bytes, (bytes, bytearray))
              else path_or_bytes)
    module = torch.export.load(source).module()

    @torch.no_grad()
    def forward(eeg: torch.Tensor, eye: torch.Tensor, pps: torch.Tensor):
        return module(eeg, eye, pps)

    return forward

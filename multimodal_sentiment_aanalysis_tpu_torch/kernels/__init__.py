"""Hand-written Hopper kernels of the port, each beside its plain version.

Each entry: launch-counter name, wrapper, kernel source, the JAX package's
kernel it replaces.

- ``bilstm_fwd``: ``lstm.bilstm_fwd`` (``lstm.fused_bilstm_layer``'s
  forward), ``kernels/lstm.py::_fwd_xproj_kernel``: a call of the wrapper,
  which launches ``bilstm_gemm`` then ``bilstm_rec``
- ``bilstm_cbnd``: ``lstm.bilstm_cbnd``, ``kernels/lstm.py::_cbnd_kernel``: a
  call of the wrapper, which launches ``bilstm_gemm`` (the gate
  activations) then ``bilstm_cscan``
- ``bilstm_segbwd``: ``lstm.bilstm_segbwd``, ``kernels/lstm.py::
  _segbwd_kernel``: a call of the wrapper, which launches ``bilstm_gemm``
  three times and ``bilstm_sweep`` once
- ``bilstm_gemm``: ``lstm.bilstm_gemm``, ``csrc/lstm_gemm.cu``: the
  tensor-core products of the two rows above (projection, gate recompute,
  dx, dW_cat) and the v5 gate recompute from ``xp`` (``"gates_xp"``)
- ``bilstm_rec``: ``lstm.bilstm_rec``, ``csrc/lstm_fwd.cu``: the forward's
  recurrence on a cluster
- ``bilstm_sweep``: ``lstm.bilstm_sweep``, ``csrc/lstm_bwd.cu``: the reverse
  sweep's serial half on a cluster
- ``bilstm_cscan``: ``lstm.bilstm_cscan``, ``csrc/lstm_bwd.cu``: row 9's c
  scan over the gate activations, one form (its input is fp32 in both)

The v9 layer backward (``lstm.bilstm_v9_bwd``) counts one call of
``bilstm_cbnd`` and one of ``bilstm_segbwd`` and launches the gate GEMM once
for both: three ``bilstm_gemm``, one ``bilstm_cscan``, one ``bilstm_sweep``.
- ``stem_tail``: ``conv_stem_train.stem_tail_fwd``, ``csrc/stem_tail.cu``,
  ``kernels/conv_stem_train.py::_fwd_kernel``
- ``stem_tail_bwd``: ``conv_stem_train.stem_tail_bwd``, ``csrc/stem_tail.cu``,
  ``kernels/conv_stem_train.py::_bwd_kernel``
- ``infonce``: ``contrastive.infonce``, ``csrc/infonce.cu``,
  ``kernels/contrastive.py::_infonce_kernel``
- ``conv_stem``: ``conv_stem.fused_conv_bn_gelu_pool``, ``csrc/conv_stem.cu``,
  ``kernels/conv_stem.py::_stage_kernel``
- ``flash_fwd``: ``attention.flash_fwd``, ``csrc/flash_attn.cu``,
  ``kernels/attention.py::_fwd_kernel``
- ``flash_bwd_dq``: ``attention.flash_bwd_dq``, ``csrc/flash_attn.cu``,
  ``kernels/attention.py::_bwd_dq_kernel``
- ``flash_bwd_dkv``: ``attention.flash_bwd_dkv``, ``csrc/flash_attn.cu``,
  ``kernels/attention.py::_bwd_dkv_kernel``
- ``flash_fwd_bf16``, ``flash_bwd_dq_bf16``, ``flash_bwd_dkv_bf16``: the
  three flash kernels' bf16 forms, which the same wrappers launch for bf16
  tensors, ``csrc/flash_attn_bf16.cu`` (forward) and
  ``csrc/flash_bwd_bf16.cu`` (backward, on ``csrc/sm90.cuh``)
- ``fusion_head``: ``fusion_head.fusion_head``, ``csrc/fusion_head.cu``,
  ``kernels/fusion_head.py::_kernel``; its bf16 form ``fusion_head_bf16``
- the BiLSTM's other schedules (``lstm.fused_bilstm_layer(schedule=)``):
  ``bilstm_fwd_xp`` (``csrc/lstm_fwd.cu``, ``kernels/lstm.py::
  _fwd_kernel``; ``bilstm_rec``'s cluster recurrence in its form that also
  stores c, an entry point with its own count); ``bilstm_cbndk``
  (``lstm.bilstm_cbndk``, ``::_cbndk_kernel``, v9.1), a call of the wrapper,
  which launches row 9's pieces, ``bilstm_gemm`` (the gate activations) then
  ``bilstm_cscan``; and four calls of the v9
  rows' pieces at K = 1, each a call of the wrapper: ``bilstm_cseq``
  (``::_cseq_kernel``, v8 and v6), which launches ``bilstm_gemm`` (the gate
  activations) then ``bilstm_cscan``; ``bilstm_bwdc`` (``::_bwd_bwdc_kernel``,
  v8), which launches ``bilstm_gemm`` three times and ``bilstm_sweep`` once
  over the full c of ``bilstm_cseq``; ``bilstm_bwd_split``
  (``::_bwd_xproj_kernel``, v6), ``bilstm_gemm`` (the gate activations) and
  ``bilstm_sweep`` once each; ``bilstm_bwd_xp`` (``::_bwd_kernel``, v5),
  ``bilstm_gemm`` (``"gates_xp"``) and ``bilstm_sweep`` once each, over
  the v5 forward's c

- ``sos_filtfilt``: ``iir.sos_filtfilt`` (``ops.dsp.filtfilt``'s filter),
  ``csrc/iir.cu``, a port-only kernel: the JAX package filters with a
  ``lax.scan`` (``ops/dsp.py::_filtfilt_1d``), no Pallas kernel; its fp64
  form ``sos_filtfilt_f64`` (the suffix ``_f64``, for float64 tensors)

The v9.1 layer backward is the v9 one (``lstm.bilstm_v9_bwd(...,
schedule="v9.1")``): it counts one call of ``bilstm_cbndk`` where v9 counts
``bilstm_cbnd``, and launches what v9 launches.
The v8 and v6 layer backwards (``lstm.bilstm_v8_bwd``, ``lstm.bilstm_v6_bwd``)
count one call of ``bilstm_cseq`` and one of ``bilstm_bwdc`` or
``bilstm_bwd_split`` and launch the gate GEMM once for both: v8 three
``bilstm_gemm``, one ``bilstm_cscan``, one ``bilstm_sweep``; v6 one of each.

The first ten but ``bilstm_cscan``, and the other schedules' six, also
have a bf16 form with its own counter (``bilstm_fwd_bf16``, ...,
``bilstm_fwd_xp_bf16``, ...): a second C entry point of the same source
with the suffix ``_bf16``, which a wrapper launches for bf16 tensors (for
the rows' calls, a second call count). Each wrapper counts its
launches, so a run can show which kernels, and which forms, its path went
through (:func:`launch_counts`).

Rows 1 and 4, row 1's recurrence and the conv stem are also
``torch.library`` custom ops (:mod:`.library`: ``msa_torch::bilstm_fwd``,
``bilstm_rec``, ``bilstm_fwd_xp``, ``conv_stem``), so that ``torch.export``
traces the serving forward through them; their counters move in the ops'
CUDA implementations only.
"""

import torch

from . import (attention, contrastive, conv_stem, conv_stem_train, fusion_head, iir, library,
               lstm)
from ._build import build_all, ptxas_report

_BF16 = torch.bfloat16
KERNELS = {
    "bilstm_fwd": lstm.KERNEL,
    "bilstm_cbnd": lstm.CBND_KERNEL,
    "bilstm_segbwd": lstm.SEGBWD_KERNEL,
    "stem_tail": conv_stem_train.KERNEL,
    "stem_tail_bwd": conv_stem_train.BWD_KERNEL,
    "infonce": contrastive.KERNEL,
    "bilstm_gemm": lstm.GEMM_KERNEL,
    "bilstm_rec": lstm.REC_KERNEL,
    "bilstm_sweep": lstm.SWEEP_KERNEL,
    "bilstm_cscan": lstm.CSCAN_KERNEL,
    "bilstm_fwd_bf16": lstm.KERNELS[_BF16],
    "bilstm_cbnd_bf16": lstm.CBND_KERNELS[_BF16],
    "bilstm_segbwd_bf16": lstm.SEGBWD_KERNELS[_BF16],
    "stem_tail_bf16": conv_stem_train.KERNELS[_BF16],
    "stem_tail_bwd_bf16": conv_stem_train.BWD_KERNELS[_BF16],
    "infonce_bf16": contrastive.KERNELS[_BF16],
    "bilstm_gemm_bf16": lstm.GEMM_KERNELS[_BF16],
    "bilstm_rec_bf16": lstm.REC_KERNELS[_BF16],
    "bilstm_sweep_bf16": lstm.SWEEP_KERNELS[_BF16],
    "conv_stem": conv_stem.KERNEL,
    "flash_fwd": attention.FWD_KERNELS[torch.float32],
    "flash_bwd_dq": attention.DQ_KERNELS[torch.float32],
    "flash_bwd_dkv": attention.DKV_KERNELS[torch.float32],
    "flash_fwd_bf16": attention.FWD_KERNELS[_BF16],
    "flash_bwd_dq_bf16": attention.DQ_KERNELS[_BF16],
    "flash_bwd_dkv_bf16": attention.DKV_KERNELS[_BF16],
    "fusion_head": fusion_head.KERNEL,
    "fusion_head_bf16": fusion_head.KERNELS[_BF16],
    "bilstm_fwd_xp": lstm.FWD_XP_KERNEL,
    "bilstm_bwd_xp": lstm.BWD_XP_KERNEL,
    "bilstm_cseq": lstm.CSEQ_KERNEL,
    "bilstm_bwd_split": lstm.BWD_SPLIT_KERNEL,
    "bilstm_bwdc": lstm.BWDC_KERNEL,
    "bilstm_cbndk": lstm.CBNDK_KERNEL,
    "bilstm_fwd_xp_bf16": lstm.FWD_XP_KERNELS[_BF16],
    "bilstm_bwd_xp_bf16": lstm.BWD_XP_KERNELS[_BF16],
    "bilstm_cseq_bf16": lstm.CSEQ_KERNELS[_BF16],
    "bilstm_bwd_split_bf16": lstm.BWD_SPLIT_KERNELS[_BF16],
    "bilstm_bwdc_bf16": lstm.BWDC_KERNELS[_BF16],
    "bilstm_cbndk_bf16": lstm.CBNDK_KERNELS[_BF16],
    "sos_filtfilt": iir.KERNEL,
    "sos_filtfilt_f64": iir.F64_KERNEL,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


__all__ = ["KERNELS", "build_all", "launch_counts", "ptxas_report", "reset_launch_counts"]

#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, LOSO training, ME-MHACL and
attention paths, bf16 LOSO training and bf16 serving, and the BiLSTM's
other kernel schedules, on one CUDA card, and check them.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --profile  # also torch.profiler windows over train epochs

It needs a CUDA card and exits non-zero without one. In order, it

1. turns TF32 off for matmuls and cuDNN convs (the plain versions are the
   fp32 reference) and builds every kernel in
   ``multimodal_sentiment_aanalysis_tpu_torch/csrc`` with nvcc, one process
   per source, all at once, and beside them prints ptxas's registers and
   spills of each instantiation of the three flash kernels (``nvcc -Xptxas
   -v``), failing if a backward form at D <= 64 spills;
2. serving: builds the full-width flagship model (feat_dim=256) from a seeded
   ``torch.Generator`` with perturbed BatchNorm running stats, and a pool of
   480 synthetic samples at MAHNOB-HCI shapes resident on the card; serves
   100 requests of 64 samples through the eval model forward,
   ``build_serving_forward`` and ``build_serving_forward(use_pallas=True)``,
   with every launch counter reset just before; checks the launch counts,
   finite logits, agreement of the three entry points within 1e-3, and the
   plain path on the CPU on the first rows within 1e-3; then the same 100
   requests through ``build_serving_forward(compute_dtype=torch.bfloat16)``
   (two launches of the bf16 BiLSTM forward per request, no other kernel),
   fp32 logits within rtol and atol 0.1 of fp32 serving and the same argmax
   on at least 90% of the rows (the JAX package's own bar for bf16
   serving); then the same requests through
   ``build_serving_forward(lstm_schedule="v5")`` (two launches of the v5
   forward per request, no other kernel), logits within 1e-4 of fp32
   serving's;
3. training: the synthetic MAHNOB-HCI set (480 trials, Z-scored) on the
   card, ``loso_split`` with subject 0 held out (460 train, 20 test); a
   full-width flagship from the seeded generator at the reference dropout
   rates; ``Trainer(batch_size=64)``: two ``train_epoch`` (8 steps each) and
   a ``test()`` after each, with every launch counter reset just before;
   checks finite losses, that every parameter tensor moved, and the launch
   counts; then card-vs-CPU gradient parity of a ``dropout=0.0`` copy on
   one batch;
4. LOSO training: ``VectorizedLOSOTrainer`` over all 24 subjects at once
   (S=24, batch 64, full width, reference dropout, early stop on) on the
   same set: two ``train_epoch`` and then two fused epochs
   (``train_epochs_fused``'s device loop, with the per-subject early-stop
   lanes) under ``torch.cuda.set_sync_debug_mode("error")``, the launch
   counters reset before each; checks that every kernel call is one launch
   for all 24 models (the single-model counts per step), finite per-subject
   losses, that the fused epochs never synchronise with the host, and,
   on a ``dropout=0.0`` copy, that subjects 0 and 17 of one vectorized step
   equal a single-model ``Trainer`` step (loss, gradients, BatchNorm running
   stats, updated parameters); prints ms/step and samples/s/chip;
   then the same trainer with ``compute_dtype="bfloat16",
   moment_dtype="bfloat16"`` from the same init (the JAX ``vloso_bf16``
   config): the same epochs and checks, with the bf16 forms of the BiLSTM
   and stem-tail kernels in every step and the fp32 forms in the held-out
   evaluation, as many launches per step as the fp32 trainer; fp32 master
   parameters and BatchNorm stats, bf16 moments; the epoch-2 loss gap to
   the fp32 trainer; and one fused bf16 epoch at B=512 (``vloso_bf16_b512``)
   after a warm-up epoch, with its ms/step and peak device memory; before
   the bf16 trainer, the fp32 trainer under each BiLSTM schedule (v9, then
   v5, v6, v8 and v9.1, ``MultimodalTransformerModel(lstm_schedule=)``)
   from the same init: two fused epochs each under the sync check, with
   launches per step by kernel (each of the schedule's kernels once per
   layer for all 24 models, no other schedule's), ms/step and peak device
   memory, and each epoch's per-subject train loss within 1e-3 relative of
   v9's; then one LOSO step's gradients (``dropout=0.0``, one fixed batch)
   under each schedule against v9's on the card (all 24 models) and subject
   0's against the CPU plain path, at the gradient-parity bar;
5. ME-MHACL (``cli.py memhacl``): ``make_synthetic_emotion_arrays(n=480)``
   on the card, the 80/20 split, full-width encoder, projection head and
   classifier (feat_dim 256, 8 heads) from seeded generators;
   ``memhacl_pretrain`` for 2 epochs on all 480 rows and ``memhacl_finetune``
   for 2 epochs, batch 32, with the launch counters reset just before;
   checks finite losses, that every parameter tensor moved, that the
   validation ran through the fused head (one launch per validation batch
   and epoch, no other kernel), and the fused-head logits of a validation
   batch against the module path on the card (1e-4) and on the CPU (1e-3);
   prints ms/step;
6. attention: ``MultiheadAttention(256, 8)`` self-attention at B=64,
   T=585, forward and backward on the card with the counters reset just
   before (one launch of each flash kernel), against the CPU plain path
   (outputs 1e-3, gradients as in 3);
7. holds every kernel against its plain PyTorch version at the shapes its
   paths give it (real activations of the first request, train batch,
   validation batch or attention input; for the S=24 cases the LOSO
   trainer's stacked weights and seeded activations; the flash kernels also
   at a 200-query / 100-key and a 9-row shape), and each bf16 form at the
   bf16 paths' shapes (the bf16 serving model's activations, the bf16 LOSO
   trainer's weights cast to bf16 with seeded bf16 activations, and subject
   0 alone), the six kernels of the other BiLSTM schedules at S=24 and at
   subject 0 (the fp32 LOSO trainer's weights, seeded activations; rows 8
   and 7 are the GEMM and the sweep at K=1 over the full c), and the
   pieces that rows 1, 9, 11, 8 and 7 launch (the tensor-core GEMM at its four
   products: projection, gate recompute, dx, dW_cat; the recurrence; the c
   scan, fp32 only, its one form; the sweep, at K=4 and, in fp32, at K=1
   over the full c) at each layer of the training
   step, at S=24 and, in bf16, at subject 0, each timed alone, which splits
   the rows' time; the GEMM also against its products in fp64, per
   mode within 1e-5 of the largest (a bar that one TF32 pass on the fp32
   operands is shown to miss); the flash forward's O and LSE against fp64,
   each within 1e-5 of its largest entry, and dQ, dK and dV within 1e-5 of
   their scale (``attention.flash_bwd_magnitudes``; bars one TF32 pass
   misses, ``tests/test_torch_port_flash_fwd_tc.py``,
   ``tests/test_torch_port_flash_bwd_tc.py``); times both with CUDA events, times one
   PyTorch call of the same function where there is one (``nn.LSTM`` in
   the case's dtype, cuDNN's in fp32; ``scaled_dot_product_attention``;
   timed here only, the port never calls them), computes each case's bound (the larger of its
   bytes over 3.35 TB/s and its operations over the peak rate for their
   type: 67 TFLOP/s fp32, 989 TFLOP/s bf16, 495 TFLOP/s per TF32 pass of
   the GEMM and of the flash kernels' products, three passes each, plus
   their softmax at the fp32 rate), prints each attention case's backward
   pair (dQ + dK/dV) against SDPA's backward, and checks the stem tail's
   dropout (keep share 1 - p within 5 sigma, every output exactly 0 or
   GELU(y) / (1 - p));
8. prints the card's name and power limit, one JSON line of per-kernel
   results (one entry per kernel a path launched; the InfoNCE kernel's
   bf16 form, which no path launches because the bf16 step's InfoNCE
   features are fp32 as in JAX, reports its case under ``bf16_*`` keys of
   the InfoNCE entry), and as its last line ``{"ok": true, "device":
   {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_sentiment_aanalysis_tpu_torch import (
    MultimodalTransformerModel,
    build_all,
    build_serving_forward,
    launch_counts,
    reset_launch_counts,
)
from multimodal_sentiment_aanalysis_tpu_torch.data import (
    DeviceDataset,
    assemble_features,
    epoch_batch_indices,
    loso_split,
    make_synthetic_emotion_arrays,
    make_synthetic_hci_data,
    random_split_indices,
)
from multimodal_sentiment_aanalysis_tpu_torch.kernels import (
    attention,
    contrastive,
    conv_stem,
    conv_stem_train,
    fusion_head,
    lstm,
    ptxas_report,
)
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MEMHACLClassifier,
    MEMHACLEncoder,
    MultiheadAttention,
    ProjectionHead,
)
from multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model import init_parameters
from multimodal_sentiment_aanalysis_tpu_torch.ops.losses import masked_cross_entropy
from multimodal_sentiment_aanalysis_tpu_torch.train import (
    Trainer,
    VectorizedLOSOTrainer,
    clip_by_global_norm,
    clip_rows_by_global_norm,
    memhacl_finetune,
    memhacl_logits,
    memhacl_pretrain,
)
from multimodal_sentiment_aanalysis_tpu_torch.train.vloso import TRAINER_CW

SEED = 0
POOL, REQUESTS, BATCH = 480, 100, 64
N_SUBJECTS, EX_NUMS, TEST_SUBJECT, EPOCHS = 24, 20, 0, 2
PATH_ATOL = 1e-3   # entry points against each other, and against the CPU plain path
# card vs CPU gradients, per parameter tensor: |diff| <= GRAD_RTOL * (max
# |CPU grad| + 1e-4 * the largest max |CPU grad| of any tensor) for all but
# GRAD_OUTLIERS of its elements. GRAD_RTOL: fp32 sums in other orders
# through 73 LSTM steps; the floor covers tensors whose true gradient is ~0
# (a Linear bias feeding a BatchNorm, the q/k projections of length-1
# attention). GRAD_OUTLIERS: a ReLU or max-pool input within rounding of
# its kink routes its gradient differently on the two devices, which
# changes a whole row of the next weight gradient (one of 768 rows of a
# feed-forward weight is 0.13% of it)
GRAD_RTOL = 1e-3
GRAD_OUTLIERS = 1e-2
DROPOUT_P = 0.4
TIMED_CALLS = 20
LOSO_FUSED_EPOCHS = 2
PARITY_SUBJECTS = (0, 17)  # LOSO models checked against a single-model Trainer step
LOSO_LR = 1e-4             # the trainers' default learning rate
# the kernels each call of rows 1, 9, 11, 8 and 7 launches on a train
# step's path (each call also counts once under the row's own name): the
# projection GEMM and the recurrence; the c scan; the gate-recompute, dx and
# dW_cat GEMMs and the sweep (row 11, and row 8 at K=1 over the full c); the
# gate-recompute GEMM and the sweep at K=1 (row 7). Row 9 runs there only
# inside the v9 layer backward, which computes the gate activations once for
# rows 9 and 11 (the GEMM counted under row 11); a call of row 9 alone
# launches that GEMM too
ROW_KERNELS = {"bilstm_fwd": {"bilstm_gemm": 1, "bilstm_rec": 1},
               "bilstm_cbnd": {"bilstm_cscan": 1},
               "bilstm_segbwd": {"bilstm_gemm": 3, "bilstm_sweep": 1},
               "bilstm_bwdc": {"bilstm_gemm": 3, "bilstm_sweep": 1},
               "bilstm_bwd_split": {"bilstm_gemm": 1, "bilstm_sweep": 1}}
# kernels with one form, which a bf16 path launches too: the c scan reads
# the fp32 gate activations in both
ONE_FORM = ("bilstm_cscan",)


def with_row_kernels(per: dict) -> dict:
    """``per`` (launches by kernel) with the launches of the kernels that
    rows 1, 9 and 11 make, in the same form (fp32 or bf16), added."""
    out = dict(per)
    for name, n in per.items():
        sfx = "_bf16" if name.endswith("_bf16") else ""
        for inner, m in ROW_KERNELS.get(name.removesuffix("_bf16"), {}).items():
            inner += "" if inner in ONE_FORM else sfx
            out[inner] = out.get(inner, 0) + n * m
    return out


# launches per train step of one model, and per held-out evaluation
PER_STEP = with_row_kernels(dict(bilstm_fwd=2, bilstm_cbnd=2, bilstm_segbwd=2, stem_tail=2,
                                 stem_tail_bwd=2, infonce=1))
PER_EVAL = with_row_kernels(dict(bilstm_fwd=2, stem_tail=2, infonce=1))
# a bf16 step: the bf16 forms, but the fp32 InfoNCE form (its features are
# fp32, as in the JAX model) and the one-form kernels; the held-out
# evaluation runs in fp32 (PER_EVAL)
BF16 = torch.bfloat16
PER_STEP_BF16 = {(name if name in ("infonce", *ONE_FORM) else f"{name}_bf16"): n
                 for name, n in PER_STEP.items()}
# the BiLSTM's kernel schedules (fp32): each one's forward and backward
# kernels, launched once per layer of a train step; the first also once per
# layer of an evaluation
SCHEDULE_KERNELS = {
    "v9": ("bilstm_fwd", "bilstm_cbnd", "bilstm_segbwd"),
    "v9.1": ("bilstm_fwd", "bilstm_cbndk", "bilstm_segbwd"),
    "v8": ("bilstm_fwd", "bilstm_cseq", "bilstm_bwdc"),
    "v6": ("bilstm_fwd", "bilstm_cseq", "bilstm_bwd_split"),
    "v5": ("bilstm_fwd_xp", "bilstm_bwd_xp"),
}
OTHER_SCHEDULES = ("v5", "v6", "v8", "v9.1")
# fp32 schedules against v9 from the same init and plans: the same function
# summed in other orders; per-subject train loss of each fused epoch,
# relative, and serving logits
SCHEDULE_LOSS_GAP, SCHEDULE_SERVE_ATOL = 1e-3, 1e-4
LOSO_B512 = 512       # the JAX bench's vloso_bf16_b512 batch
LOSS_GAP_LIMIT = 0.1  # bf16 against fp32 epoch-2 train loss, relative, per subject
# bf16 serving against fp32 serving: the JAX package's bar (tests/test_serving.py)
SERVE_BF16_TOL, SERVE_BF16_ARGMAX = 0.1, 0.9
# the GEMM of rows 1 and 11 against its products in fp64, per mode: max
# |err| over max |ref| (gemm_check)
GEMM_REL = {"proj": 1e-5, "gates": 1e-5, "dx": 1e-5, "dw": 1e-5}
# the flash kernels (3xTF32 on the tensor cores) against fp64 (flash_check):
# max |err| of the forward's O and LSE over their max |ref|, and of the
# backward's dQ, dK and dV over their scale, the largest entry of each one's
# sum of absolute terms (attention.flash_bwd_magnitudes: 2.2-5.1x the
# largest entry at these shapes, and finite where dQ and dK cancel to 0 at
# Tk = 1); one TF32 pass misses it at the attention phase's shape and at
# 200 / 100, the fp32 plain version meets it
# (tests/test_torch_port_flash_fwd_tc.py, tests/test_torch_port_flash_bwd_tc.py)
FLASH_FP64_REL = 1e-5
BF16_RTOL = 2.0 ** -7  # a bf16 output of a bf16 form: one ulp of the value on top of its atol
# ME-MHACL: the MAHNOB-HCI trial count of the other phases, the reference
# batch, full width
MEMHACL_N, MEMHACL_BATCH, MEMHACL_EPOCHS, MEMHACL_F, MEMHACL_HEADS = 480, 32, 2, 256, 8
HEAD_ATOL = 1e-4  # fused head against the module path on the card
# attention: the T=585 EEG window as a sequence, MHA(256, 8)
ATTN_B, ATTN_T, ATTN_E, ATTN_HEADS = 64, 585, 256, 8
# the bound of a case: the larger of its bytes (each input read once, each
# output written once) over the memory rate and its operations over the
# peak rate for their type (peak_rate): fp32, or bf16 for a bf16 form; the
# BiLSTM's GEMM at the bf16 rate for its bf16 x bf16 products and at the
# TF32 tensor-core rate, per TF32 pass, for its products with an fp32
# operand; the recurrence and the sweep at the fp32 rate in both forms
# (their arithmetic is fp32 on CUDA cores); the flash kernels' products as
# three TF32 passes at the TF32 rate, which the three kernels run, plus
# their softmax at the fp32 rate (flash_ops_ms) (H100 SXM data sheet, dense)
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, PEAK_BF16_FLOPS = 3.35e12, 67e12, 989e12
PEAK_TF32_FLOPS = 495e12

CSRC = "multimodal_sentiment_aanalysis_tpu_torch/csrc/"
JAX_KERNELS = "multimodal_sentiment_aanalysis_tpu/kernels/"
# kernel -> (source, TPU kernel it replaces, max |err| against its plain
# version over every output). The backward kernels' reductions sum B*T rows
# in another order: dW_cat over 4,672 rows with entries up to ~130, the
# stem's dgamma/dbeta over 9,344 rows with entries up to ~370, the flash
# dQ and dK/dV over up to 585 keys or queries; the InfoNCE losses are
# ~25-50 at temperature 0.01. A bf16 form (suffix _bf16, same source) keeps
# its fp32 form's tolerance for its fp32 outputs (its arithmetic is fp32 on
# bf16 operands) and adds BF16_RTOL for its bf16 outputs
TRAINING_KERNELS = {
    "bilstm_fwd": (CSRC + "lstm_fwd.cu", JAX_KERNELS + "lstm.py:527", 1e-4),
    "bilstm_cbnd": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:1026", 1e-4),
    "bilstm_segbwd": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:1227", 1e-3),
    # the pieces of rows 1 and 11: the GEMM's dW_cat sums B*T rows as
    # bilstm_segbwd's does; the sweep's dgates carry dh through T steps
    "bilstm_gemm": (CSRC + "lstm_gemm.cu", JAX_KERNELS + "lstm.py:527,1227", 1e-3),
    "bilstm_rec": (CSRC + "lstm_fwd.cu", JAX_KERNELS + "lstm.py:527", 1e-4),
    "bilstm_sweep": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:1227,819,691", 1e-4),
    "stem_tail": (CSRC + "stem_tail.cu", JAX_KERNELS + "conv_stem_train.py:265", 1e-5),
    "stem_tail_bwd": (CSRC + "stem_tail.cu", JAX_KERNELS + "conv_stem_train.py:368", 1e-3),
    "infonce": (CSRC + "infonce.cu", JAX_KERNELS + "contrastive.py:61", 1e-4),
}
KERNELS = {
    **TRAINING_KERNELS,
    **{f"{name}_bf16": entry for name, entry in TRAINING_KERNELS.items()},
    "conv_stem": (CSRC + "conv_stem.cu", JAX_KERNELS + "conv_stem.py:64", 1e-4),
    "flash_fwd": (CSRC + "flash_attn.cu", JAX_KERNELS + "attention.py:67", 1e-4),
    "flash_bwd_dq": (CSRC + "flash_attn.cu", JAX_KERNELS + "attention.py:159", 1e-3),
    "flash_bwd_dkv": (CSRC + "flash_attn.cu", JAX_KERNELS + "attention.py:184", 1e-3),
    "fusion_head": (CSRC + "fusion_head.cu", JAX_KERNELS + "fusion_head.py:40", HEAD_ATOL),
    # row 9's c scan, one form: the plain version's rounding, step by step
    "bilstm_cscan": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:1026", 1e-6),
    # the other schedules' kernels; the v8 sweep's dW_cat sums B*T rows as
    # bilstm_segbwd's does (rows 8 and 7 are row 11's pieces at K=1 over
    # the full c: the sweep rebuilds c from c_seq and the GEMM's 3xTF32
    # activations, row 6's c from its own CUDA-core product)
    "bilstm_fwd_xp": (CSRC + "lstm_fwd.cu", JAX_KERNELS + "lstm.py:310", 1e-4),
    "bilstm_bwd_xp": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:401", 1e-4),
    "bilstm_cseq": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:623", 1e-4),
    "bilstm_bwd_split": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:691", 1e-4),
    "bilstm_bwdc": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:819", 1e-3),
    "bilstm_cbndk": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:1115", 1e-4),
}


# the BiLSTM kernels whose first argument is the output gradient dh_seq
REVERSE_SWEEPS = ("bilstm_segbwd", "bilstm_bwdc", "bilstm_bwd_split", "bilstm_bwd_xp")


def schedule_per_step(schedule: str) -> tuple[dict, dict]:
    """One train step's and one evaluation's launches of each kernel, for
    one model, under a BiLSTM schedule."""
    other = lambda per: {k: n for k, n in per.items() if not k.startswith("bilstm")}
    fwd = SCHEDULE_KERNELS[schedule]
    return (with_row_kernels({**other(PER_STEP), **{name: 2 for name in fwd}}),
            with_row_kernels({**other(PER_EVAL), fwd[0]: 2}))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def synced(fn):
    """``fn()`` and its host-clock seconds, the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fused_epochs_checked(vt, epochs: int, expected: dict, label: str) -> tuple:
    """``vt.fused_epochs_on_device(epochs)`` under
    ``set_sync_debug_mode("error")`` (any host sync in the loop raises),
    its launch counts held to ``expected`` and its metrics to finite values.
    Returns the metrics as numpy, the host-clock seconds of the synchronised
    run and the launch counts."""
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = vt.fused_epochs_on_device(epochs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    print(f"{label} fused launches over {epochs} epoch(s): {counts}")
    check(counts == expected, f"{label} fused launch counts {counts} != {expected}")
    out = out.cpu().numpy()
    check(bool(np.isfinite(out).all()), f"{label} fused epochs: non-finite metrics")
    return out, seconds, counts


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def make_model(device: torch.device) -> MultimodalTransformerModel:
    gen = torch.Generator().manual_seed(SEED)
    model = MultimodalTransformerModel(feat_dim=256, device=device, generator=gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return model


def make_pool(device: torch.device) -> DeviceDataset:
    rng = np.random.default_rng(SEED)
    return DeviceDataset({
        "eeg": rng.normal(size=(POOL, 32, 585)).astype(np.float32),
        "eye": rng.normal(size=(POOL, 38)).astype(np.float32),
        "pps": rng.normal(size=(POOL, 230)).astype(np.float32),
    }, device)


def request_plan(device: torch.device) -> torch.Tensor:
    """REQUESTS batches of BATCH pool rows: shuffled epochs, back to back."""
    rng = np.random.default_rng(SEED + 1)
    epochs = []
    while sum(len(e) for e in epochs) < REQUESTS:
        epochs.append(epoch_batch_indices(POOL, BATCH, rng)[0])
    return torch.as_tensor(np.concatenate(epochs)[:REQUESTS], dtype=torch.long, device=device)


def serve(paths: dict, pool: DeviceDataset, plan: torch.Tensor) -> tuple[dict, dict]:
    """Every request through every path; returns logits and ms per batch."""
    outs, ms = {}, {}
    for name, fwd in paths.items():
        def run(fwd=fwd):
            batches = (pool.gather(idx) for idx in plan)
            return [fwd(b["eeg"], b["eye"], b["pps"]) for b in batches]
        outs[name], seconds = synced(run)
        ms[name] = seconds * 1e3 / len(plan)
    return outs, ms


def serving_phase(device: torch.device):
    """Returns the model, the first request, the path's launch counts, and
    the pool, the request plan and ``build_serving_forward``'s logits."""
    model = make_model(device)
    pool = make_pool(device)
    plan = request_plan(device)
    paths = {
        "model_forward": model,
        "serving": build_serving_forward(model),
        "serving_use_pallas": build_serving_forward(model, use_pallas=True),
    }
    first = pool.gather(plan[0])
    with torch.no_grad():
        for fwd in paths.values():  # warm-up: first launches, cuBLAS/cuDNN handles
            fwd(first["eeg"], first["eye"], first["pps"])
        torch.cuda.synchronize()

        reset_launch_counts()
        outs, ms = serve(paths, pool, plan)
        counts = launch_counts()
    expected = {name: 0 for name in KERNELS}
    expected.update(with_row_kernels(dict(bilstm_fwd=2 * REQUESTS * len(paths),
                                          stem_tail=2 * REQUESTS, conv_stem=2 * REQUESTS)))
    print(f"serving launches over {REQUESTS} requests x {len(paths)} entry points: {counts}")
    check(counts == expected, f"serving launch counts {counts} != {expected}")
    for name in paths:
        print(f"serve {name}: {REQUESTS} requests x {BATCH}, {ms[name]:.4f} ms/batch "
              f"(host clock around synchronised runs)")

    worst = 0.0
    for name, res in outs.items():
        for a, v in res:
            check(a.shape == (BATCH, 3) and v.shape == (BATCH, 3), f"{name}: logits shape")
            check(bool(torch.isfinite(a).all() and torch.isfinite(v).all()),
                  f"{name}: non-finite logits")
        for other in outs:
            for (a, v), (a2, v2) in zip(res, outs[other]):
                worst = max(worst, (a - a2).abs().max().item(), (v - v2).abs().max().item())
    print(f"entry points agree: max |diff| {worst:.3e} (limit {PATH_ATOL})")
    check(worst <= PATH_ATOL, "entry points disagree")

    cpu_model = copy.deepcopy(model).cpu()
    rows = {k: v[:4].cpu() for k, v in first.items()}
    with torch.no_grad():
        ca, cv = cpu_model(rows["eeg"], rows["eye"], rows["pps"])
    cpu_err = max(max((a[:4].cpu() - ca).abs().max().item(), (v[:4].cpu() - cv).abs().max().item())
                  for a, v in (res[0] for res in outs.values()))
    print(f"card vs CPU plain path on 4 rows: max |diff| {cpu_err:.3e} (limit {PATH_ATOL})")
    check(cpu_err <= PATH_ATOL, "card disagrees with the CPU plain path")
    return model, first, counts, (pool, plan, outs["serving"])


def serving_bf16_phase(model, pool: DeviceDataset, plan: torch.Tensor, fp32_logits: list) -> dict:
    """The requests through ``build_serving_forward(compute_dtype=bf16)``:
    launch counts, fp32 logits, agreement with fp32 serving. Returns the
    path's launch counts."""
    fwd = build_serving_forward(model, compute_dtype=BF16)
    first = pool.gather(plan[0])
    fwd(first["eeg"], first["eye"], first["pps"])  # warm-up: bf16 cuBLAS/cuDNN handles
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, ms = serve({"serving_bf16": fwd}, pool, plan)
    counts = launch_counts()
    expected = {name: 0 for name in KERNELS}
    expected.update(with_row_kernels({"bilstm_fwd_bf16": 2 * REQUESTS}))
    print(f"bf16 serving launches over {REQUESTS} requests: {counts}")
    check(counts == expected, f"bf16 serving launch counts {counts} != {expected}")
    worst, excess, agree = 0.0, 0.0, 1.0
    for head in (0, 1):  # arousal, valence
        lo = torch.cat([res[head] for res in outs["serving_bf16"]])
        hi = torch.cat([res[head] for res in fp32_logits])
        check(lo.dtype == torch.float32 and lo.shape == hi.shape
              and bool(torch.isfinite(lo).all()), "bf16 serving: logits not finite fp32")
        diff = (lo - hi).abs()
        worst = max(worst, diff.max().item())
        excess = max(excess, (diff - SERVE_BF16_TOL * (1 + hi.abs())).max().item())
        agree = min(agree, (lo.argmax(-1) == hi.argmax(-1)).double().mean().item())
    print(f"serve serving_bf16: {REQUESTS} requests x {BATCH}, {ms['serving_bf16']:.4f} ms/batch "
          f"(host clock around synchronised runs); against fp32 serving: max |diff| "
          f"{worst:.3e}, within rtol/atol {SERVE_BF16_TOL}: {excess <= 0}, argmax agreement "
          f"{agree:.4f} (the lower head; limit {SERVE_BF16_ARGMAX})")
    check(excess <= 0 and agree >= SERVE_BF16_ARGMAX, "bf16 serving disagrees with fp32 serving")
    return counts


def serving_v5_phase(model, pool: DeviceDataset, plan: torch.Tensor, fp32_logits: list) -> dict:
    """The requests through ``build_serving_forward(lstm_schedule="v5")``:
    two launches of the v5 forward per request and no other kernel, logits
    within SCHEDULE_SERVE_ATOL of (v9) fp32 serving's. Returns the launch
    counts."""
    fwd = build_serving_forward(model, lstm_schedule="v5")
    first = pool.gather(plan[0])
    fwd(first["eeg"], first["eye"], first["pps"])  # warm-up: the projection's cuBLAS handle
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, ms = serve({"serving_v5": fwd}, pool, plan)
    counts = launch_counts()
    expected = {name: 0 for name in KERNELS}
    expected["bilstm_fwd_xp"] = 2 * REQUESTS
    print(f"v5 serving launches over {REQUESTS} requests: {counts}")
    check(counts == expected, f"v5 serving launch counts {counts} != {expected}")
    worst = max((a - a2).abs().max().item() for res, res2 in zip(outs["serving_v5"], fp32_logits)
                for a, a2 in zip(res, res2))
    finite = all(bool(torch.isfinite(a).all()) and a.shape == (BATCH, 3)
                 for res in outs["serving_v5"] for a in res)
    print(f"serve serving_v5 (lstm_schedule='v5'): {REQUESTS} requests x {BATCH}, "
          f"{ms['serving_v5']:.4f} ms/batch (host clock around synchronised runs); logits against "
          f"v9 fp32 serving max |diff| {worst:.3e} (limit {SCHEDULE_SERVE_ATOL})")
    check(finite and worst <= SCHEDULE_SERVE_ATOL, "v5 serving disagrees with v9 serving")
    return counts


def serving_kernel_cases(model, eeg: torch.Tensor, cases: dict) -> None:
    """Adds (label, kernel call, plain call) at the serving path's shapes, on
    the activations the eval model forward computes from ``eeg``; with bf16
    ``eeg`` and a model cast to bf16, to the bf16 forms (the conv stem has
    none). Call under ``no_grad``."""
    sfx = "_bf16" if eeg.dtype == BF16 else ""
    tc = model.eeg_net.temp_conv
    # eval model forward: conv (cuDNN), then the stem tail per stage
    h = eeg
    for conv, bn, pool in ((tc[0], tc[1], 4), (tc[5], tc[6], 2)):
        y = F.conv1d(h, conv.weight, conv.bias, padding=conv.padding)
        args = (y.transpose(1, 2).contiguous(), bn.weight, bn.bias,
                bn.running_mean, bn.running_var)
        cases["stem_tail" + sfx].append((
            f"eval pool {pool} {tuple(args[0].shape)}",
            lambda a=args, p=pool: conv_stem_train.fused_stage_train(*a, 0.0, p),
            lambda a=args, p=pool: conv_stem_train.fused_stage_train_plain(*a, p), args))
        h = conv_stem_train.fused_stage_train_plain(*args, pool).transpose(1, 2)
    # both BiLSTM layers, on the stem's output
    x = h.transpose(1, 2).contiguous()
    bilstm = model.eeg_net.bilstm
    for k in range(bilstm.num_layers):
        fwd, bwd = bilstm.layer_params(k)
        cases["bilstm_fwd" + sfx].append((
            f"layer {k} {tuple(x.shape)}",
            lambda x=x, f=fwd, b=bwd: lstm.fused_bilstm_layer(x, f, b),
            lambda x=x, f=fwd, b=bwd: lstm.fused_bilstm_layer_plain(x, f, b), (x, *fwd, *bwd)))
        x = lstm.fused_bilstm_layer_plain(x, fwd, bwd)
    if sfx:
        return
    # serving forward with use_pallas=True: the fused conv stem per stage
    h = eeg.transpose(1, 2).contiguous()
    for conv, bn, pad, pool in ((tc[0], tc[1], 7, 4), (tc[5], tc[6], 2, 2)):
        scale, shift = conv_stem.fold_bn(bn.weight, bn.bias, bn.running_mean,
                                         bn.running_var, conv.bias)
        args = (h, conv.weight, scale, shift, pad, pool)
        cases["conv_stem"].append((
            f"k {conv.weight.shape[2]} pool {pool} {tuple(h.shape)}",
            lambda a=args: conv_stem.fused_conv_bn_gelu_pool(*a),
            lambda a=args: conv_stem.fused_conv_bn_gelu_pool_plain(*a), args))
        h = conv_stem.fused_conv_bn_gelu_pool_plain(*args)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def hci_dataset(device: torch.device) -> DeviceDataset:
    """The synthetic MAHNOB-HCI set (24 subjects x 20 trials), Z-scored, on
    the card."""
    data = make_synthetic_hci_data(seed=SEED)
    feats, _ = assemble_features(data, ["eeg", "eye", "pps"], norm="Z_score",
                                 label_type="arousal")
    return DeviceDataset({
        "eeg": feats["eeg"].astype(np.float32), "eye": feats["eye"].astype(np.float32),
        "pps": feats["pps"].astype(np.float32),
        "arousal": np.asarray(data["arousal_label"]).astype(np.int64),
        "valence": np.asarray(data["valence_label"]).astype(np.int64),
    }, device)


def make_trainer(full: DeviceDataset) -> Trainer:
    """``cli.py single`` on the synthetic set: subject 0 held out."""
    device = full.device
    tr_idx, te_idx = loso_split(N_SUBJECTS, EX_NUMS, TEST_SUBJECT)
    model = MultimodalTransformerModel(feat_dim=256, device=device,
                                       generator=torch.Generator().manual_seed(SEED))
    return Trainer(model, full.subset(tr_idx), full.subset(te_idx), batch_size=BATCH,
                   seed=SEED, verbose=False)


def training_phase(trainer: Trainer) -> dict:
    """Two epochs and a test after each; returns the path's launch counts."""
    n_train, n_test = len(trainer.train_data), len(trainer.test_data)
    steps, evals = -(-n_train // BATCH), -(-n_test // BATCH)
    print(f"training: {n_train} train / {n_test} test samples, {steps} steps of {BATCH} "
          f"per epoch, feat_dim 256, dropout 0.4 (stem) / 0.3")
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    reset_launch_counts()
    for epoch in range(1, EPOCHS + 1):
        tr, t_train = synced(lambda: trainer.train_epoch(epoch))
        te, t_test = synced(trainer.test)
        print(f"epoch {epoch}: train loss {tr[0]:.6f} ce {tr[1]:.6f} con {tr[2]:.6f} "
              f"acc {tr[3]:.4f} | test loss {te[0]:.6f} ce {te[1]:.6f} con {te[2]:.6f} "
              f"acc {te[3]:.4f}")
        print(f"epoch {epoch} smoke reading (host clock around synchronised runs): "
              f"{t_train * 1e3 / steps:.3f} ms/step, {n_train / t_train:.1f} samples/s "
              f"train; test {t_test * 1e3:.3f} ms")
        check(all(math.isfinite(v) for v in (*tr, *te)), f"epoch {epoch}: non-finite loss")
    counts = launch_counts()
    expected = {name: EPOCHS * (steps * PER_STEP.get(name, 0) + evals * PER_EVAL.get(name, 0))
                for name in KERNELS}
    print(f"training launches over {EPOCHS} epochs: {counts}")
    check(counts == expected, f"training launch counts {counts} != {expected}")
    frozen = [n for n, p in trainer.model.named_parameters() if torch.equal(p, before[n])]
    print(f"parameter tensors moved: {len(before) - len(frozen)} of {len(before)}")
    check(not frozen, f"parameters that did not move: {frozen}")
    return counts


def step_loss(model, batch: dict, mask: torch.Tensor, contrastive_weight=1.0) -> torch.Tensor:
    """The trainers' loss: both heads' masked cross-entropy plus
    ``contrastive_weight`` times the three contrastive terms."""
    a, v, c1, c2, c3 = model(batch["eeg"], batch["eye"], batch["pps"],
                             labels=(batch["arousal"], batch["valence"], mask))
    return (masked_cross_entropy(torch.nan_to_num(a), batch["arousal"], mask)
            + masked_cross_entropy(torch.nan_to_num(v), batch["valence"], mask)
            + contrastive_weight * (c1 + c2 + c3))


def grad_agreement(got: dict, want: dict) -> tuple[float, str, float, str]:
    """``(worst scaled |diff|, its tensor, largest share of elements above
    GRAD_RTOL, its tensor)`` of named gradients ``got`` against ``want``,
    each tensor's error scaled as GRAD_RTOL's comment says."""
    scale = max(g.abs().max().item() for g in want.values())
    worst, worst_name, outliers, outlier_name = 0.0, "", 0.0, ""
    for name, g_want in want.items():
        err = ((got[name].cpu() - g_want.cpu()).abs()
               / (g_want.abs().max().item() + 1e-4 * scale))
        if err.max().item() > worst:
            worst, worst_name = err.max().item(), name
        share = (err > GRAD_RTOL).double().mean().item()
        if share > outliers:
            outliers, outlier_name = share, name
    return worst, worst_name, outliers, outlier_name


def gradient_parity(trainer: Trainer, batch: dict, mask: torch.Tensor) -> None:
    """A dropout=0.0 copy of the trained model, one batch, train mode: the
    loss and every parameter's gradient on the card against the CPU plain
    path."""
    card = MultimodalTransformerModel(feat_dim=256, dropout=0.0, device=mask.device)
    card.load_state_dict(trainer.model.state_dict())
    cpu = copy.deepcopy(card).cpu()
    losses, grads = [], []
    for model, dev in ((card, mask.device), (cpu, torch.device("cpu"))):
        model.train()
        loss = step_loss(model, {k: v.to(dev) for k, v in batch.items()}, mask.to(dev))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    worst, worst_name, outliers, outlier_name = grad_agreement(grads[0], grads[1])
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"gradient parity, card vs CPU plain path, B={BATCH}, dropout 0: loss "
          f"{losses[0]:.6f} vs {losses[1]:.6f} (rel {loss_err:.3e}); {len(grads[1])} tensors, "
          f"worst scaled |diff| {worst:.3e} at {worst_name}; largest share of elements "
          f"above {GRAD_RTOL}: {outliers:.3e}{' at ' + outlier_name if outlier_name else ''} "
          f"(limit {GRAD_OUTLIERS})")
    check(loss_err <= 1e-4 and outliers <= GRAD_OUTLIERS, "card gradients disagree with the CPU")


def training_kernel_cases(model, batch: dict, mask: torch.Tensor, gen: torch.Generator,
                          cases: dict) -> None:
    """Adds (label, kernel call, plain call) at the training path's shapes,
    on the activations of ``batch``. Call under ``no_grad``."""
    tc = model.eeg_net.temp_conv
    h = batch["eeg"]
    for conv, bn, pool in ((tc[0], tc[1], 4), (tc[5], tc[6], 2)):
        y = F.conv1d(h, conv.weight, conv.bias, padding=conv.padding).transpose(1, 2)
        y = y.contiguous()
        mean = y.mean((0, 1))
        var = (y * y).mean((0, 1)) - mean * mean
        args = (y, bn.weight, bn.bias, mean, var)
        shape = tuple(y.shape)
        cases["stem_tail"].append((
            f"train pool {pool} {shape} batch stats, writes the code",
            lambda a=args, p=pool: conv_stem_train.stem_tail_fwd(*a, 0.0, p),
            lambda a=args, p=pool: conv_stem_train.fused_stage_train_plain(
                *a, p, with_code=True), args))
        out, code = conv_stem_train.stem_tail_fwd(*args, DROPOUT_P, pool, generator=gen)
        inv = torch.rsqrt(var + bn.eps)
        bwd_args = (y, torch.randn(out.shape, device=y.device, generator=gen), code,
                    bn.weight * inv, bn.bias - mean * bn.weight * inv, mean, inv,
                    DROPOUT_P, pool)
        cases["stem_tail_bwd"].append((
            f"pool {pool} {shape} p {DROPOUT_P}, the kernel's own code",
            lambda a=bwd_args: conv_stem_train.stem_tail_bwd(*a),
            lambda a=bwd_args: conv_stem_train.stem_tail_bwd_plain(*a), bwd_args))
        h = conv_stem_train.fused_stage_train_plain(*args, pool).transpose(1, 2)
    x = h.transpose(1, 2).contiguous()
    bilstm = model.eeg_net.bilstm
    for k in range(bilstm.num_layers):
        fwd, bwd = bilstm.layer_params(k)
        w = lstm.stack_params(fwd, bwd)
        h_seq = lstm.fused_bilstm_layer_plain(x, fwd, bwd)
        dh = torch.randn(h_seq.shape, device=x.device, generator=gen)
        c_bnd = lstm.bilstm_cbnd_plain(x, h_seq, *w)
        layer_label = f"layer {k} {tuple(x.shape)}"
        label = f"{layer_label} K {lstm.SEG_K}"
        cases["bilstm_cbnd"].append((
            label, lambda a=(x, h_seq, *w): lstm.bilstm_cbnd(*a),
            lambda a=(x, h_seq, *w): lstm.bilstm_cbnd_plain(*a), (x, h_seq, *w)))
        cases["bilstm_segbwd"].append((
            label, lambda a=(dh, x, h_seq, c_bnd, *w): lstm.bilstm_segbwd(*a),
            lambda a=(dh, x, h_seq, c_bnd, *w): lstm.bilstm_segbwd_plain(*a),
            (dh, x, h_seq, c_bnd, *w)))
        for name, items in lstm_piece_cases(x, w, h_seq, dh, c_bnd, layer_label).items():
            cases[name] += items
        x = h_seq
    model.eval()  # the encoders' embeddings, without moving the running stats
    feats = torch.stack([model.eeg_net(batch["eeg"]), model.eye_net(batch["eye"]),
                         model.pps_net(batch["pps"])])
    n = F.normalize(feats, dim=2, eps=1e-12)
    # the step's three problems share its labels, mask and temperature
    args = (n, n, batch["arousal"].expand(3, -1).contiguous(), mask.expand(3, -1).contiguous(),
            model.temperature.reshape(1).expand(3).contiguous())
    cases["infonce"].append((
        f"G 3 {tuple(n.shape[1:])}", lambda a=args: contrastive.infonce(*a),
        lambda a=args: contrastive.infonce_plain(*a), args))


def lstm_piece_cases(x, w, h_seq, dh, c_bnd, label: str, sfx: str = "") -> dict:
    """The pieces of rows 1, 9 and 11 at one layer's shapes: the GEMM at its
    four products, the recurrence, the c scan (fp32 cases only: it has one
    form) and the sweep, each (label, kernel call, plain call, the tensors
    the call reads). The sweep's kernel call overwrites a copy of the
    activations (the copy is timed with it)."""
    w_ih, w_hh, bias = w
    xp = lstm.bilstm_gemm_plain("proj", x, *w)
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    dg = lstm.bilstm_sweep_plain(act, dh, c_bnd, w_hh)
    reads = {"proj": (x, w_ih, bias), "gates": (x, h_seq, w_ih, w_hh, bias), "dx": (dg, w_ih),
             "dw": (x, h_seq, dg)}

    def exact(mode: str):
        """The mode's products in fp64, on the operands as given and on
        their TF32 roundings (bias aside)"""
        ref = lstm.bilstm_gemm_plain(mode, *(a.double() for a in (x, *w)), h_seq=h_seq.double(),
                                     dg=dg.double())
        one_pass = lstm.bilstm_gemm_plain(
            mode, *(tf32_round(a).double() for a in (x, w_ih, w_hh)), bias.double(),
            h_seq=tf32_round(h_seq).double(), dg=tf32_round(dg).double())
        return ref, one_pass

    pieces = {
        "bilstm_gemm" + sfx: [
            (f"{mode} {label}", lambda m=mode: lstm.bilstm_gemm(m, x, *w, h_seq=h_seq, dg=dg),
             lambda m=mode: lstm.bilstm_gemm_plain(m, x, *w, h_seq=h_seq, dg=dg),
             (mode, *reads[mode]), lambda m=mode: exact(m)) for mode in lstm.GEMM_MODES],
        "bilstm_rec" + sfx: [(label, lambda: lstm.bilstm_rec(xp, w_hh),
                              lambda: lstm.bilstm_rec_plain(xp, w_hh), (xp, w_hh))],
        "bilstm_sweep" + sfx: [(f"{label} K {lstm.SEG_K}",
                                lambda: lstm.bilstm_sweep(act.clone(), dh, c_bnd, w_hh),
                                lambda: lstm.bilstm_sweep_plain(act, dh, c_bnd, w_hh),
                                (act, dh, c_bnd, w_hh))],
    }
    if not sfx:
        pieces["bilstm_cscan"] = [(f"{label} K {lstm.SEG_K}", lambda: lstm.bilstm_cscan(act),
                                   lambda: lstm.bilstm_cscan_plain(act), (act,))]
    return pieces


def dropout_check(model, batch: dict, gen: torch.Generator) -> None:
    """Stem tail at p=0.4, pool=1, on the stage-1 conv output: each output
    is exactly 0 or GELU(y) / (1 - p), the keep share 1 - p within 5 sigma."""
    conv, bn = model.eeg_net.temp_conv[0], model.eeg_net.temp_conv[1]
    y = F.conv1d(batch["eeg"], conv.weight, conv.bias, padding=conv.padding)
    y = y.transpose(1, 2).contiguous()
    mean = y.mean((0, 1))
    var = (y * y).mean((0, 1)) - mean * mean
    args = (y, bn.weight, bn.bias, mean, var)
    out, _ = conv_stem_train.stem_tail_fwd(*args, DROPOUT_P, 1, generator=gen, with_code=False)
    full, _ = conv_stem_train.stem_tail_fwd(*args, 0.0, 1, with_code=False)
    full = full * (1.0 / (1.0 - DROPOUT_P))  # the kernel's one multiply by fp32 1/(1-p)
    kept = out != 0
    share, n = kept.double().mean().item(), out.numel()
    sigma = math.sqrt(DROPOUT_P * (1 - DROPOUT_P) / n)
    exact = bool(torch.equal(out[kept], full[kept]))
    print(f"dropout check {tuple(y.shape)} p {DROPOUT_P} pool 1: keep share {share:.6f} "
          f"(expected {1 - DROPOUT_P}, {abs(share - (1 - DROPOUT_P)) / sigma:.2f} sigma), "
          f"kept outputs equal GELU(y)/(1-p): {exact}")
    check(abs(share - (1 - DROPOUT_P)) <= 5 * sigma and exact, "stem-tail dropout check failed")


# --------------------------------------------------------------------------
# LOSO training: the 24 subjects' models in one vectorized step
# --------------------------------------------------------------------------


def make_loso_trainer(full: DeviceDataset, dropout: float | None = None, batch: int = BATCH,
                      early_stop: bool = True, lstm_schedule: str = "v9",
                      **dtypes) -> VectorizedLOSOTrainer:
    """``cli.py vloso`` on the synthetic set, with early stop: one model per
    held-out subject, all 24 trained together, the BiLSTM under
    ``lstm_schedule``. ``dtypes``: the trainer's
    ``compute_dtype``/``moment_dtype``."""
    model = MultimodalTransformerModel(feat_dim=256, dropout=dropout, device=full.device,
                                       generator=torch.Generator().manual_seed(SEED),
                                       lstm_schedule=lstm_schedule)
    return VectorizedLOSOTrainer(model, full, N_SUBJECTS, EX_NUMS, lr=LOSO_LR, batch_size=batch,
                                 seed=SEED, early_stop=early_stop, **dtypes)


def loso_phase(vt: VectorizedLOSOTrainer, per_step: dict = PER_STEP, label: str = "LOSO") -> dict:
    """Two host-plan epochs, then LOSO_FUSED_EPOCHS fused epochs with the
    early-stop lanes under the sync check; ``per_step`` is one step's
    launches of each kernel (the held-out evaluation runs PER_EVAL).
    Returns the path's launch counts (``counts``), the host-plan epochs'
    launches per step (``per_step``) and the last host-plan epoch's
    per-subject train losses (``loss``)."""
    s_n, n_train = vt.n_subjects, vt.train_idx.shape[1]
    steps = -(-n_train // BATCH)
    print(f"{label} training: {s_n} models x {n_train} train / {vt.test_idx.shape[1]} test "
          f"samples, {steps} steps of {s_n} x {BATCH} per epoch, feat_dim 256, dropout 0.4 "
          f"(stem) / 0.3, compute dtype {vt.compute_dtype or torch.float32}, moments "
          f"{vt.opt.mu.dtype}")
    reset_launch_counts()
    for epoch in range(1, EPOCHS + 1):
        tm, seconds = synced(vt.train_epoch)
        check(all(np.isfinite(v).all() for v in tm.values()), f"{label} epoch {epoch}: non-finite")
        print(f"{label} epoch {epoch}: train loss mean {tm['loss'].mean():.6f} (subjects "
              f"{tm['loss'].min():.6f} to {tm['loss'].max():.6f}), a_acc {tm['a_acc'].mean():.4f}, "
              f"v_acc {tm['v_acc'].mean():.4f}")
        print(f"{label} epoch {epoch} smoke reading (host clock around synchronised runs): "
              f"{seconds * 1e3 / steps:.3f} ms/step of {s_n} models, "
              f"{s_n * n_train / seconds:.1f} samples/s/chip")
    counts = launch_counts()
    measured = {name: n / (EPOCHS * steps) for name, n in counts.items() if n}
    print(f"{label} launches per step ({s_n} models, {EPOCHS} epochs of {steps} steps): {measured}")
    expected = {name: EPOCHS * steps * per_step.get(name, 0) for name in KERNELS}
    check(counts == expected, f"{label} launch counts {counts} != {expected}: not one launch "
                              f"per kernel call for all {s_n} models")

    expected = {name: LOSO_FUSED_EPOCHS * (steps * per_step.get(name, 0) + PER_EVAL.get(name, 0))
                for name in KERNELS}
    # (E, S, 9): masked sums, held-out metrics, lr, stopped
    out, seconds, fused = fused_epochs_checked(vt, LOSO_FUSED_EPOCHS, expected,
                                               f"{label} (early stop)")
    for e in range(LOSO_FUSED_EPOCHS):
        loss = out[e, :, 0] / np.maximum(out[e, :, 3], 1.0)
        print(f"{label} fused epoch {EPOCHS + e + 1}: train loss mean {loss.mean():.6f}, held-out "
              f"loss mean {out[e, :, 4].mean():.6f} a_acc {out[e, :, 5].mean():.4f}, lr lanes "
              f"{out[e, :, 7].min():.3e} to {out[e, :, 7].max():.3e}, stopped "
              f"{int(out[e, :, 8].sum())}/{s_n}")
    print(f"{label} fused epochs ran under set_sync_debug_mode('error'): no host sync in "
          f"{LOSO_FUSED_EPOCHS} epochs; smoke reading (host clock around synchronised runs): "
          f"{seconds * 1e3 / (LOSO_FUSED_EPOCHS * steps):.3f} ms/step with the per-epoch held-out "
          f"evaluation, {LOSO_FUSED_EPOCHS * s_n * n_train / seconds:.1f} samples/s/chip")
    return {"counts": {name: counts[name] + fused[name] for name in KERNELS},
            "per_step": measured, "loss": tm["loss"]}


def loso_bf16_phase(full: DeviceDataset, fp32: dict) -> tuple[dict, VectorizedLOSOTrainer]:
    """The LOSO phase in bf16 from the fp32 phase's init (``fp32``: that
    phase's result): launches per step by kernel row equal to the fp32
    trainer's, fp32 master parameters and BatchNorm stats, bf16 moments,
    the epoch-2 loss gap. Returns the launch counts and the trainer."""
    vt = make_loso_trainer(full, compute_dtype="bfloat16", moment_dtype="bfloat16")
    res = loso_phase(vt, PER_STEP_BF16, "LOSO bf16")
    by_row = {name.removesuffix("_bf16"): n for name, n in res["per_step"].items()}
    print(f"LOSO bf16 launches per step by kernel row equal the fp32 trainer's: "
          f"{by_row == fp32['per_step']}")
    check(by_row == fp32["per_step"], f"LOSO bf16 per-step launches {by_row} != fp32 "
                                      f"{fp32['per_step']}")
    dtypes = (vt.params.dtype, vt.stats.dtype, vt.opt.mu.dtype, vt.opt.nu.dtype)
    print(f"LOSO bf16 state: master parameters {dtypes[0]}, BatchNorm stats {dtypes[1]}, "
          f"moments {dtypes[2]} / {dtypes[3]}")
    check(dtypes == (torch.float32, torch.float32, BF16, BF16), "LOSO bf16: state dtypes")
    check(bool(torch.isfinite(vt.params).all()), "LOSO bf16: non-finite master parameters")
    gap = np.abs(res["loss"] - fp32["loss"]) / np.abs(fp32["loss"])
    print(f"LOSO epoch {EPOCHS} train loss, bf16 vs fp32 from the same init and plans: mean "
          f"{res['loss'].mean():.6f} vs {fp32['loss'].mean():.6f}, relative gap per subject "
          f"mean {gap.mean():.3e} max {gap.max():.3e} (limit {LOSS_GAP_LIMIT})")
    check(gap.max() <= LOSS_GAP_LIMIT, "LOSO bf16 parts from the fp32 trainer")
    return res["counts"], vt


def loso_b512_phase(full: DeviceDataset) -> dict:
    """``vloso_bf16_b512``: a bf16 trainer at B=512 without early stop, one
    warm-up fused epoch, then one fused epoch under the sync check, with
    its launch counts, ms/step and the peak device memory. Returns the
    timed epoch's launch counts."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vt = make_loso_trainer(full, batch=LOSO_B512, early_stop=False, compute_dtype="bfloat16",
                           moment_dtype="bfloat16")
    s_n, n_train = vt.n_subjects, vt.train_idx.shape[1]
    steps = -(-n_train // LOSO_B512)
    _, warm = synced(lambda: vt.fused_epochs_on_device(1))
    expected = {name: steps * PER_STEP_BF16.get(name, 0) for name in KERNELS}
    # (1, S, 4) masked sums
    out, seconds, counts = fused_epochs_checked(vt, 1, expected, f"LOSO bf16 B={LOSO_B512}")
    peak = torch.cuda.max_memory_allocated()
    loss = out[0, :, 0] / np.maximum(out[0, :, 3], 1.0)
    print(f"LOSO bf16 B={LOSO_B512}: {s_n} models x {n_train} train samples, {steps} step(s) of "
          f"{s_n} x {LOSO_B512} per epoch, no early stop; warm-up epoch {warm:.3f} s; fused epoch "
          f"train loss mean {loss.mean():.6f}; smoke reading (host clock around a synchronised "
          f"run, no host sync inside): {seconds * 1e3 / steps:.3f} ms/step, "
          f"{s_n * n_train / seconds:.1f} samples/s/chip; torch.cuda.max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB ({base / 2 ** 30:.3f} GiB held before the trainer was built)")
    del vt, out
    torch.cuda.empty_cache()
    return counts


def loso_step_parity(full: DeviceDataset) -> None:
    """A dropout=0.0 LOSO trainer's first step against a single-model
    ``Trainer`` step of subjects PARITY_SUBJECTS, from the same init on the
    same batch: loss, every gradient (the gradient-parity metric), BatchNorm
    running stats after the forward, and parameters after the update
    (|diff| <= 2 lr + 1e-6: Adam's first step moves each weight by lr times
    the sign of its gradient, which is noise where the gradient is ~0)."""
    vt = make_loso_trainer(full, dropout=0.0)
    plans, masks = vt._epoch_plans()
    idx = torch.as_tensor(plans[:, 0], device=full.device)
    mask = torch.as_tensor(masks[:, 0], device=full.device)
    init = {s: vt.subject_variables(s) for s in PARITY_SUBJECTS}
    cw = vt._param_dict(vt.params)["trainer.contrastive_weight"].clone()
    batch = vt._gather(idx)
    batch["mask"] = mask
    vt.model.train()
    grads, (loss, _) = vt._grad_step(vt.params, vt._stat_views, batch)
    vt.opt.step(vt.params, clip_rows_by_global_norm(grads, vt.clip_norm), torch.isfinite(loss))
    vt_grads = vt._param_dict(grads)
    for s in PARITY_SUBJECTS:
        model = MultimodalTransformerModel(feat_dim=256, dropout=0.0, device=full.device)
        model.load_state_dict(init[s])
        t = Trainer(model, full.subset(vt.train_idx[s]), full.subset(vt.test_idx[s]),
                    lr=LOSO_LR, batch_size=BATCH, seed=SEED, verbose=False)
        with torch.no_grad():
            t.contrastive_weight.copy_(cw[s])
        model.train()
        one, one_mask = full.gather(idx[s]), mask[s]
        t_loss, _ = t._loss(one, one_mask)
        t_loss.backward()
        want = {n: p.grad for n, p in model.named_parameters()}
        want["trainer.contrastive_weight"] = t.contrastive_weight.grad
        worst, worst_name, outliers, outlier_name = grad_agreement(
            {n: vt_grads[n][s] for n in want}, want)
        after = vt.subject_variables(s)  # the vectorized step's stats and updated weights
        stat_err = max((after[n] - b).abs().max().item() for n, b in model.named_buffers()
                       if "running" in n)
        clip_by_global_norm(t.params, t.clip_norm)
        t.optimizer.step()
        param_err = max((after[n] - p).abs().max().item() for n, p in model.named_parameters())
        loss_err = abs(loss[s].item() - t_loss.item()) / abs(t_loss.item())
        print(f"LOSO step subject {s} vs single-model Trainer step, dropout 0: loss "
              f"{loss[s].item():.6f} vs {t_loss.item():.6f} (rel {loss_err:.3e}); gradients worst "
              f"scaled |diff| {worst:.3e} at {worst_name}, largest share above {GRAD_RTOL}: "
              f"{outliers:.3e}{' at ' + outlier_name if outlier_name else ''} (limit "
              f"{GRAD_OUTLIERS}); BN running stats max |diff| {stat_err:.3e} (limit 1e-4); "
              f"updated parameters max |diff| {param_err:.3e} (limit {2 * LOSO_LR + 1e-6:.3e})")
        check(loss_err <= 1e-4 and outliers <= GRAD_OUTLIERS and stat_err <= 1e-4
              and param_err <= 2 * LOSO_LR + 1e-6,
              f"LOSO subject {s} disagrees with the single-model Trainer")


def loso_schedules_phase(full: DeviceDataset) -> dict:
    """Each BiLSTM schedule's LOSO trainer (fp32, S=24, B=64, early stop)
    from the v9 phase's init: two fused epochs under the sync check, the
    launch counts of each (the schedule's kernels once per layer and step
    for all 24 models, no other schedule's), its ms/step and peak device
    memory, and its per-subject train loss against v9's.
    Returns the launch counts."""
    total = {name: 0 for name in KERNELS}
    losses = {}
    for schedule in ("v9", *OTHER_SCHEDULES):
        gc.collect()  # the last schedule's trainer (its closures hold it in cycles)
        torch.cuda.empty_cache()
        vt = make_loso_trainer(full, lstm_schedule=schedule)
        s_n, n_train = vt.n_subjects, vt.train_idx.shape[1]
        steps = -(-n_train // BATCH)
        per_step, per_eval = schedule_per_step(schedule)
        expected = {name: steps * per_step.get(name, 0) + per_eval.get(name, 0) for name in KERNELS}
        losses[schedule] = []
        for epoch in (1, 2):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, seconds, counts = fused_epochs_checked(vt, 1, expected,
                                                        f"LOSO {schedule} epoch {epoch}")
            peak = torch.cuda.max_memory_allocated()
            for name in KERNELS:
                total[name] += counts[name]
            out = out[0]
            losses[schedule].append(out[:, 0] / np.maximum(out[:, 3], 1.0))
            print(f"LOSO {schedule} fused epoch {epoch}: train loss mean "
                  f"{losses[schedule][-1].mean():.6f}; smoke reading (host clock around a "
                  f"synchronised run, no host sync inside): {seconds * 1e3 / steps:.3f} ms/step of "
                  f"{s_n} x {BATCH} with the held-out evaluation, "
                  f"{s_n * n_train / seconds:.1f} samples/s/chip; torch.cuda.max_memory_allocated "
                  f"{peak / 2 ** 30:.3f} GiB, {(peak - base) / 2 ** 30:.3f} GiB above the "
                  f"{base / 2 ** 30:.3f} GiB held before the epoch")
        train_launches = {name: (n - per_eval.get(name, 0)) / steps for name, n in counts.items() if n}
        print(f"LOSO {schedule} launches per step ({s_n} models, the evaluation's taken out): "
              f"{train_launches}")
        del vt, out
    gc.collect()
    for schedule in OTHER_SCHEDULES:
        gap = max((np.abs(a - b) / np.abs(b)).max() for a, b in zip(losses[schedule], losses["v9"]))
        print(f"LOSO {schedule} against v9 from the same init and plans: largest relative "
              f"per-subject train-loss gap over 2 fused epochs {gap:.3e} (limit {SCHEDULE_LOSS_GAP})")
        check(gap <= SCHEDULE_LOSS_GAP, f"LOSO {schedule} parts from v9")
    torch.cuda.empty_cache()
    return total


def schedule_gradient_parity(full: DeviceDataset) -> None:
    """One LOSO step's gradients of a dropout=0.0 trainer under each
    schedule on one fixed batch: all 24 models against v9's on the card,
    and subject 0 against the CPU plain path (``grad_agreement``, the bar
    of the gradient-parity check above)."""
    batch, grads = None, {}
    for schedule in ("v9", *OTHER_SCHEDULES):
        vt = make_loso_trainer(full, dropout=0.0, lstm_schedule=schedule)
        if batch is None:
            plans, masks = vt._epoch_plans()
            idx = torch.as_tensor(plans[:, 0], device=full.device)
            mask = torch.as_tensor(masks[:, 0], device=full.device)
            init, cw = vt.subject_variables(0), vt._param_dict(vt.params)[TRAINER_CW][0].item()
            batch = vt._gather(idx)
            batch["mask"] = mask
        vt.model.train()
        g, (loss, _) = vt._grad_step(vt.params, vt._stat_views, batch)
        grads[schedule] = ({n: t.detach().clone() for n, t in vt._param_dict(g).items()},
                           loss.detach().clone())
        del vt, g
        gc.collect()
    torch.cuda.empty_cache()
    # subject 0 on the CPU plain path: the trainer's loss, ce + cw * contrastive
    model = MultimodalTransformerModel(feat_dim=256, dropout=0.0)
    model.load_state_dict({n: t.cpu() for n, t in init.items()})
    model.train()
    cw_leaf = torch.tensor(cw, requires_grad=True)
    cpu_loss = step_loss(model, {k: v.cpu() for k, v in full.gather(idx[0]).items()},
                         mask[0].cpu(), cw_leaf)
    cpu_loss.backward()
    want = {n: p.grad for n, p in model.named_parameters()}
    want[TRAINER_CW] = cw_leaf.grad
    for schedule in OTHER_SCHEDULES + ("v9",):
        got, loss = grads[schedule]
        lines = []
        if schedule != "v9":
            ref, ref_loss = grads["v9"]
            worst, worst_name, outliers, outlier_name = grad_agreement(got, ref)
            loss_err = ((loss - ref_loss).abs() / ref_loss.abs()).max().item()
            lines.append((f"card, all {loss.numel()} models, against v9", loss_err, worst,
                          worst_name, outliers, outlier_name))
        worst, worst_name, outliers, outlier_name = grad_agreement(
            {n: got[n][0] for n in want}, want)
        loss_err = abs(loss[0].item() - cpu_loss.item()) / abs(cpu_loss.item())
        lines.append(("subject 0 against the CPU plain path", loss_err, worst, worst_name,
                      outliers, outlier_name))
        for what, loss_err, worst, worst_name, outliers, outlier_name in lines:
            print(f"LOSO step gradients under {schedule}, dropout 0, {what}: loss rel "
                  f"{loss_err:.3e} (limit 1e-4); worst scaled |diff| {worst:.3e} at {worst_name}; "
                  f"largest share of elements above {GRAD_RTOL}: {outliers:.3e}"
                  f"{' at ' + outlier_name if outlier_name else ''} (limit {GRAD_OUTLIERS})")
            check(loss_err <= 1e-4 and outliers <= GRAD_OUTLIERS,
                  f"LOSO step gradients under {schedule} disagree ({what})")


def schedule_kernel_cases(vt: VectorizedLOSOTrainer, gen: torch.Generator, cases: dict,
                          loso_cases: dict) -> None:
    """Adds the other schedules' six kernels at the LOSO step's S=24 shapes
    (the fp32 trainer's stacked weights, seeded activations) to
    ``loso_cases``, and subject 0's share to ``cases``; and the sweep at
    K=1 over the full c, the piece rows 8 and 7 launch (its kernel call
    overwrites a copy of the activations, timed with it). Call under
    ``no_grad``."""
    device = vt.device
    pd = vt._param_dict(vt.params)
    s_n = vt.n_subjects
    randn = lambda *shape: torch.randn(shape, device=device, generator=gen)
    x = randn(s_n, BATCH, vt.data.arrays["eeg"].shape[2] // 8, pd["eeg_net.temp_conv.6.weight"].shape[1])
    for k in range(2):
        part = lambda name, sfx: pd[f"eeg_net.bilstm.{name}_l{k}{sfx}"]
        w = (torch.stack([part("weight_ih", ""), part("weight_ih", "_reverse")], 1),
             torch.stack([part("weight_hh", ""), part("weight_hh", "_reverse")], 1),
             torch.stack([part("bias_ih", "") + part("bias_hh", ""),
                          part("bias_ih", "_reverse") + part("bias_hh", "_reverse")], 1))
        h_seq = lstm.bilstm_fwd_plain(x, *w)
        c_seq = lstm.bilstm_cseq_plain(x, h_seq, *w)
        xp = lstm._projection(x, w[0], w[2])
        dh = randn(*h_seq.shape)
        label = f"layer {k} {tuple(x.shape)}"
        for name, args in (("bilstm_fwd_xp", (xp, w[1])),
                           ("bilstm_bwd_xp", (dh, xp, h_seq, c_seq, w[1])),
                           ("bilstm_cseq", (x, h_seq, *w)),
                           ("bilstm_bwd_split", (dh, x, h_seq, c_seq, *w)),
                           ("bilstm_bwdc", (dh, x, h_seq, c_seq, *w)),
                           ("bilstm_cbndk", (x, h_seq, *w))):
            fn, plain = getattr(lstm, name), getattr(lstm, name + "_plain")
            a0 = tuple(a[0] for a in args)
            loso_cases.setdefault(name, []).append((f"S={s_n} {label}", lambda a=args, f=fn: f(*a),
                                     lambda a=args, p=plain: p(*a), args))
            cases[name].append((f"subject 0 of S={s_n} {label}", lambda a=a0, f=fn: f(*a),
                                lambda a=a0, p=plain: p(*a), a0))
        act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
        args = (act, dh, c_seq, w[1])
        for what, a, into in ((f"S={s_n}", args, loso_cases),
                              (f"subject 0 of S={s_n}", tuple(t[0] for t in args), cases)):
            into["bilstm_sweep"].append((
                f"{what} {label} K 1 (rows 8 and 7)",
                lambda a=a: lstm.bilstm_sweep(a[0].clone(), *a[1:], 1),
                lambda a=a: lstm.bilstm_sweep_plain(*a, 1), a))
        x = h_seq


def loso_kernel_cases(vt: VectorizedLOSOTrainer, gen: torch.Generator,
                      one_model: dict | None = None) -> dict:
    """(label, kernel call, plain call) at the LOSO step's S=24 shapes: the
    trainer's stacked weights, seeded activations. For a bf16 trainer the
    cases go to the bf16 forms, on its weights and activations in bf16 as
    its step casts them (the BatchNorm statistics computed in bf16, as its
    stem computes them; the InfoNCE case too, though the step's own
    features are fp32), and ``one_model`` gains each training kernel's case
    at subject 0 alone: one model's share of the launch, the shape of a
    one-model library call. Call under ``no_grad``."""
    dtype = vt.compute_dtype or torch.float32
    sfx = "_bf16" if dtype == BF16 else ""
    cases: dict = {name + sfx: [] for name in TRAINING_KERNELS}
    device = vt.device
    pd = {n: p.to(dtype) if n != "temperature" else p for n, p in vt._param_dict(vt.params).items()}
    s_n = vt.n_subjects
    randn = lambda *shape: torch.randn(shape, device=device, generator=gen).to(dtype)

    def add(name, label, fn, plain, args, one=None):
        cases[name + sfx].append((f"S={s_n} {label}", lambda: fn(*args), lambda: plain(*args),
                                  args))
        if one_model is not None:
            a0 = one or tuple(a[0] if isinstance(a, torch.Tensor) else a for a in args)
            one_model[name + sfx].append((f"subject 0 of S={s_n} {label}", lambda: fn(*a0),
                                          lambda: plain(*a0), a0))

    tc = "eeg_net.temp_conv"
    t_eeg = vt.data.arrays["eeg"].shape[2]
    width = pd[f"{tc}.6.weight"].shape[1]  # feat_dim
    for conv_shape, bn, pool in (((s_n, BATCH, t_eeg, pd[f"{tc}.1.weight"].shape[1]), f"{tc}.1", 4),
                                 ((s_n, BATCH, t_eeg // 4, width), f"{tc}.6", 2)):
        y = randn(*conv_shape)
        mean = y.mean((1, 2))
        var = (y * y).mean((1, 2)) - mean * mean
        args = (y, pd[f"{bn}.weight"].contiguous(), pd[f"{bn}.bias"].contiguous(), mean, var)
        add("stem_tail", f"pool {pool} {conv_shape} batch stats, writes the code",
            lambda *a, p=pool: conv_stem_train.stem_tail_fwd(*a, 0.0, p),
            lambda *a, p=pool: conv_stem_train.fused_stage_train_plain(*a, p, with_code=True),
            args)
        out, code = conv_stem_train.stem_tail_fwd(*args, DROPOUT_P, pool, generator=gen)
        inv = torch.rsqrt(var + 1e-5)
        scale = args[1] * inv
        bwd_args = (y, randn(*out.shape), code, scale, args[2] - mean * scale, mean, inv,
                    DROPOUT_P, pool)
        add("stem_tail_bwd", f"pool {pool} {conv_shape} p {DROPOUT_P}, the kernel's own code",
            conv_stem_train.stem_tail_bwd, conv_stem_train.stem_tail_bwd_plain, bwd_args)
    x = randn(s_n, BATCH, t_eeg // 8, width)
    for k in range(2):
        part = lambda name, sfx: pd[f"eeg_net.bilstm.{name}_l{k}{sfx}"]
        w = (torch.stack([part("weight_ih", ""), part("weight_ih", "_reverse")], 1),
             torch.stack([part("weight_hh", ""), part("weight_hh", "_reverse")], 1),
             torch.stack([part("bias_ih", "") + part("bias_hh", ""),
                          part("bias_ih", "_reverse") + part("bias_hh", "_reverse")], 1))
        h_seq = lstm.bilstm_fwd_plain(x, *w)
        c_bnd = lstm.bilstm_cbnd_plain(x, h_seq, *w)
        dh = randn(*h_seq.shape)
        label = f"layer {k} {tuple(x.shape)}"
        # the forward's one-model cases are the serving path's
        cases["bilstm_fwd" + sfx].append((f"S={s_n} {label}", lambda a=(x, *w): lstm.bilstm_fwd(*a),
                                          lambda a=(x, *w): lstm.bilstm_fwd_plain(*a), (x, *w)))
        add("bilstm_cbnd", f"{label} K {lstm.SEG_K}", lstm.bilstm_cbnd, lstm.bilstm_cbnd_plain,
            (x, h_seq, *w))
        add("bilstm_segbwd", f"{label} K {lstm.SEG_K}", lstm.bilstm_segbwd,
            lstm.bilstm_segbwd_plain, (dh, x, h_seq, c_bnd, *w))
        for name, items in lstm_piece_cases(x, w, h_seq, dh, c_bnd, f"S={s_n} {label}",
                                            sfx).items():
            cases.setdefault(name, []).extend(items)
        if one_model is not None:
            for name, items in lstm_piece_cases(
                    x[0], tuple(t[0] for t in w), h_seq[0], dh[0], c_bnd[0],
                    f"subject 0 of S={s_n} {label}", sfx).items():
                one_model[name] += items
        x = h_seq
    # one step's 3 S problems: each model's labels; every other model on the
    # epoch's wrap-padded last batch (12 real rows of 64)
    p_n = 3 * s_n
    n = F.normalize(randn(p_n, BATCH, width), dim=2, eps=1e-12)
    rows = torch.as_tensor(vt.train_idx[:, :BATCH], device=device)
    labels = vt.data.arrays["arousal"][rows].repeat_interleave(3, 0).contiguous()
    tail = vt.train_idx.shape[1] % BATCH
    valid = torch.ones(p_n, BATCH, device=device)
    valid[3::6, tail:] = valid[4::6, tail:] = valid[5::6, tail:] = 0.0
    temp = pd["temperature"].repeat_interleave(3).contiguous()
    args = (n, n, labels, valid, temp)
    add("infonce", f"P={p_n} {tuple(n.shape[1:])} per-problem labels, masks, temperatures",
        contrastive.infonce, contrastive.infonce_plain, args, one=tuple(a[:3] for a in args))
    return cases


# --------------------------------------------------------------------------
# ME-MHACL: contrastive pretrain, joint finetune, the fused head
# --------------------------------------------------------------------------


def _params(*modules) -> dict[str, torch.Tensor]:
    return {f"{i}.{n}": p for i, m in enumerate(modules) for n, p in m.named_parameters()}


def memhacl_phase(device: torch.device) -> tuple[dict, tuple, tuple]:
    """``cli.py memhacl`` at full width: 2 pretrain and 2 finetune epochs.
    Returns the path's launch counts, the trained ``(encoder, projector,
    classifier)`` and the ``(full, train, validation)`` sets."""
    arrays = make_synthetic_emotion_arrays(n=MEMHACL_N, seed=SEED)
    full = DeviceDataset(arrays, device)
    tr_idx, va_idx = random_split_indices(MEMHACL_N, 0.8, seed=SEED)
    train, val = full.subset(tr_idx), full.subset(va_idx)
    gen = lambda k: torch.Generator().manual_seed(SEED + k)
    encoder = MEMHACLEncoder(MEMHACL_F, MEMHACL_HEADS, device=device, generator=gen(0))
    projector = ProjectionHead(MEMHACL_F, device=device, generator=gen(1))
    classifier = MEMHACLClassifier(MEMHACL_F, device=device, generator=gen(2))
    pre_steps = -(-MEMHACL_N // MEMHACL_BATCH)
    ft_steps, val_batches = -(-len(train) // MEMHACL_BATCH), -(-len(val) // MEMHACL_BATCH)
    print(f"ME-MHACL: {MEMHACL_N} synthetic trials; pretrain on all of them ({pre_steps} steps "
          f"of {MEMHACL_BATCH} per epoch), finetune on {len(train)} with {len(val)} validation "
          f"({ft_steps} steps, {val_batches} validation batches per epoch); feat_dim "
          f"{MEMHACL_F}, {MEMHACL_HEADS} heads, projector and classifier dropout 0.5")

    reset_launch_counts()
    before = {n: p.detach().clone() for n, p in _params(encoder, projector).items()}
    (_, _, losses), t_pre = synced(lambda: memhacl_pretrain(
        encoder, projector, full, num_epochs=MEMHACL_EPOCHS, batch_size=MEMHACL_BATCH,
        seed=SEED, verbose=False))
    frozen = [n for n, p in _params(encoder, projector).items() if torch.equal(p, before[n])]
    before = {n: p.detach().clone() for n, p in _params(encoder, classifier).items()}
    (_, _, metrics), t_ft = synced(lambda: memhacl_finetune(
        encoder, None, classifier, train, val, num_epochs=MEMHACL_EPOCHS,
        batch_size=MEMHACL_BATCH, seed=SEED, verbose=False))
    counts = launch_counts()
    frozen += [n for n, p in _params(encoder, classifier).items() if torch.equal(p, before[n])]
    print(f"ME-MHACL pretrain losses {losses}; finetune losses {metrics['loss_history']}, "
          f"validation a_acc {metrics['a_acc']:.4f} v_acc {metrics['v_acc']:.4f}")
    print(f"ME-MHACL smoke reading (host clock around synchronised runs): pretrain "
          f"{t_pre * 1e3 / (MEMHACL_EPOCHS * pre_steps):.3f} ms/step, finetune "
          f"{t_ft * 1e3 / (MEMHACL_EPOCHS * ft_steps):.3f} ms/step with the per-epoch validation")
    check(all(math.isfinite(v) for v in (*losses, *metrics["loss_history"])),
          "ME-MHACL: non-finite loss")
    print(f"ME-MHACL parameter tensors that did not move: {frozen}")
    check(not frozen, f"ME-MHACL parameters that did not move: {frozen}")
    expected = {name: 0 for name in KERNELS}
    expected["fusion_head"] = val_batches * MEMHACL_EPOCHS
    print(f"ME-MHACL launches: {counts}")
    check(counts == expected, f"ME-MHACL launch counts {counts} != {expected}")

    # one validation batch: fused head vs module path on the card and on the CPU
    idx, _ = val.epoch_plan(MEMHACL_BATCH, shuffle=False)
    batch = val.gather(idx[0])
    x = (batch["eeg"], batch["eye"], batch["pps"])
    fused = memhacl_logits(encoder, classifier, *x)  # eval mode, no grad
    with torch.no_grad():
        module = classifier(encoder(*x))
    cpu = memhacl_logits(copy.deepcopy(encoder).cpu(), copy.deepcopy(classifier).cpu(),
                         *(t.cpu() for t in x))
    card_err = max((f - m).abs().max().item() for f, m in zip(fused, module))
    cpu_err = max((f.cpu() - c).abs().max().item() for f, c in zip(fused, cpu))
    print(f"ME-MHACL validation logits, fused head vs module path on the card: max |diff| "
          f"{card_err:.3e} (limit {HEAD_ATOL}); vs the CPU module path {cpu_err:.3e} (limit "
          f"{PATH_ATOL})")
    check(all(f.shape == (MEMHACL_BATCH, 2) and bool(torch.isfinite(f).all()) for f in fused),
          "ME-MHACL: fused-head logits not finite (B, 2)")
    check(card_err <= HEAD_ATOL and cpu_err <= PATH_ATOL, "ME-MHACL: fused head disagrees")
    return counts, (encoder, projector, classifier), (full, train, val)


def memhacl_kernel_cases(encoder, classifier, val: DeviceDataset, cases: dict) -> None:
    """Adds the fused head at the validation batch (B=32) and at a ragged
    B=37, on the trained encoder's embeddings. Call under ``no_grad``."""
    encoder.eval()
    weights = fusion_head.head_weights(encoder.multihead_attn, classifier)
    for rows, what in ((MEMHACL_BATCH, "validation batch"), (37, "ragged")):
        batch = val.gather(np.arange(rows) % len(val))
        args = (*encoder.embed(batch["eeg"], batch["eye"], batch["pps"]), *weights)
        cases["fusion_head"].append((
            f"B={rows} F={MEMHACL_F} {what}",
            lambda a=args: fusion_head.fusion_head(*a, num_heads=MEMHACL_HEADS),
            lambda a=args: fusion_head.fusion_head_plain(*a, num_heads=MEMHACL_HEADS), args))


# --------------------------------------------------------------------------
# attention over a long sequence: the flash kernels
# --------------------------------------------------------------------------


def attention_phase(device: torch.device) -> tuple[dict, MultiheadAttention, torch.Tensor]:
    """``MultiheadAttention(256, 8)`` self-attention over the T=585 EEG
    window, forward and backward; returns the launch counts, the module and
    its input on the card."""
    gen = torch.Generator().manual_seed(SEED)
    cpu = MultiheadAttention(ATTN_E, ATTN_HEADS)
    init_parameters(cpu, gen)
    card = copy.deepcopy(cpu).to(device)
    x = torch.randn(ATTN_B, ATTN_T, ATTN_E, generator=gen)
    x_card = x.to(device)

    def step(m, xi):
        xi = xi.detach().requires_grad_()
        y = m(xi, xi, xi)
        (y * y).sum().backward()
        grads = {"input": xi.grad, **{n: p.grad for n, p in m.named_parameters()}}
        m.zero_grad()
        return y.detach(), grads

    step(card, x_card)  # warm-up: first launches, cuBLAS handles
    reset_launch_counts()
    (y, grads), seconds = synced(lambda: step(card, x_card))
    counts = launch_counts()
    print(f"attention: MultiheadAttention({ATTN_E}, {ATTN_HEADS}) self-attention, B={ATTN_B}, "
          f"T={ATTN_T}, forward + backward {seconds * 1e3:.3f} ms (host clock around a "
          f"synchronised run); launches {counts}")
    expected = {name: 0 for name in KERNELS}
    expected.update(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    check(counts == expected, f"attention launch counts {counts} != {expected}")
    y_cpu, g_cpu = step(cpu, x)
    out_err = (y.cpu() - y_cpu).abs().max().item()
    worst, worst_name, outliers, outlier_name = grad_agreement(grads, g_cpu)
    print(f"attention card vs CPU plain path: outputs max |diff| {out_err:.3e} (limit "
          f"{PATH_ATOL}); {len(g_cpu)} gradients, worst scaled |diff| {worst:.3e} at "
          f"{worst_name}; largest share above {GRAD_RTOL}: {outliers:.3e}"
          f"{' at ' + outlier_name if outlier_name else ''} (limit {GRAD_OUTLIERS})")
    check(bool(torch.isfinite(y).all()) and out_err <= PATH_ATOL and outliers <= GRAD_OUTLIERS,
          "attention on the card disagrees with the CPU")
    return counts, card, x_card


def attention_kernel_cases(mha: MultiheadAttention, x: torch.Tensor, gen: torch.Generator,
                           cases: dict) -> None:
    """Adds the three flash kernels at the attention phase's own q, k, v
    (B H = 512, T = 585, Dh = 32), at 200 queries over 100 keys and at 9
    rows, seeded; each case also with its fp64 outputs (flash_check), the
    backward's with their scales. Call under ``no_grad``."""
    dh = ATTN_E // ATTN_HEADS
    bh = ATTN_B * ATTN_HEADS

    def heads(t):
        return t.reshape(ATTN_B, ATTN_T, ATTN_HEADS, dh).transpose(1, 2).reshape(
            bh, ATTN_T, dh).contiguous()

    w, b = mha.in_proj_weight.chunk(3), mha.in_proj_bias.chunk(3)
    q, k, v = (heads(F.linear(x, wi, bi)) for wi, bi in zip(w, b))
    randn = lambda *shape: torch.randn(shape, device=x.device, generator=gen)
    shapes = [(f"MHA self-attention {tuple(q.shape)}", q / math.sqrt(dh), k, v)]
    for tq, tk in ((200, 100), (9, 9)):
        shapes.append((f"({bh}, {tq} q / {tk} k, {dh})", randn(bh, tq, dh) / math.sqrt(dh),
                       randn(bh, tk, dh), randn(bh, tk, dh)))
    for label, q, k, v in shapes:
        o, lse = attention.flash_fwd_plain(q, k, v)
        do = randn(*q.shape)
        fwd_args, bwd_args = (q, k, v), (q, k, v, do, lse, (do * o).sum(-1))
        cases["flash_fwd"].append((label, lambda a=fwd_args: attention.flash_fwd(*a),
                                   lambda a=fwd_args: attention.flash_fwd_plain(*a), fwd_args,
                                   lambda a=fwd_args: (attention.flash_fwd_plain(
                                       *(t.double() for t in a)),)))
        cases["flash_bwd_dq"].append((label, lambda a=bwd_args: attention.flash_bwd_dq(*a),
                                      lambda a=bwd_args: attention.flash_bwd_dq_plain(*a),
                                      bwd_args, lambda a=bwd_args: flash_bwd_fp64("dq", a)))
        cases["flash_bwd_dkv"].append((label, lambda a=bwd_args: attention.flash_bwd_dkv(*a),
                                       lambda a=bwd_args: attention.flash_bwd_dkv_plain(*a),
                                       bwd_args, lambda a=bwd_args: flash_bwd_fp64("dkv", a)))


def flash_bwd_fp64(kernel: str, args) -> tuple:
    """The fp64 plain outputs of a backward case (``kernel`` "dq" or "dkv")
    on the same inputs, and their scales (attention.flash_bwd_magnitudes)."""
    a = [t.double() for t in args]
    scales = attention.flash_bwd_magnitudes(*a)
    if kernel == "dq":
        return (attention.flash_bwd_dq_plain(*a),), scales[:1]
    return attention.flash_bwd_dkv_plain(*a), scales[1:]


# --------------------------------------------------------------------------
# kernels against their plain versions, their bounds and the library calls
# --------------------------------------------------------------------------


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED_CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_CALLS


def outputs(name: str, res) -> list[torch.Tensor]:
    """A call's compared tensors. The stem forward's pooled values only: its
    winner code can differ where two window entries tie within rounding
    (the gradient parity above and the stem-backward case, fed the kernel's
    code, cover it). The stem backward's dgamma/dbeta partials summed, as
    its caller sums them (the kernel and the plain version chunk them
    differently)."""
    name = name.removesuffix("_bf16")
    if isinstance(res, torch.Tensor):
        return [res]
    if name == "stem_tail":
        return [res[0]]
    if name == "stem_tail_bwd":  # partials (chunks, C), or (S, chunks, C)
        return [res[0], res[1].sum(-2), res[2].sum(-2)]
    return list(res)


def tensors(args) -> list[torch.Tensor]:
    """The tensors among ``args``, nested tuples flattened."""
    if isinstance(args, torch.Tensor):
        return [args]
    out = []
    for a in args:
        if isinstance(a, (torch.Tensor, tuple, list)):
            out += tensors(a)
    return out


def operations(name: str, args, res) -> float:
    """Floating-point operations of one call on these inputs: a multiply-add
    counts two, an exp, erf, max or division one; the per-element terms of
    the gate and normalisation arithmetic are approximate. A bf16 form does
    its fp32 form's operations."""
    bf16 = name.endswith("_bf16")
    name = name.removesuffix("_bf16")
    t = tensors(args)
    if name == "bilstm_gemm":
        # 2MNK per product and pass: three TF32 passes for fp32 x fp32
        # (fp32-accurate), two for bf16 x fp32 dgates (dx, dW_cat), one bf16
        # pass for bf16 x bf16 (proj, gates; peak_rate takes the bf16 rate)
        mode = args[0]
        passes = (1 if mode in ("proj", "gates") else 2) if bf16 else 3
        x = t[0]
        if mode == "dx":
            dg, w_ih = t
            return passes * 2 * dg.numel() * w_ih.shape[-1]
        h = t[1].shape[-1] // 2 if mode in ("gates", "dw") else t[1].shape[-2] // 4
        g = 8 * h  # both directions' gate columns
        if mode == "proj":
            return passes * 2 * x.numel() * g
        if mode == "gates":  # and the activations
            rows = x.numel() // x.shape[-1]
            return passes * 2 * rows * g * (x.shape[-1] + h) + 4 * rows * g
        rows = x.numel() // x.shape[-1]
        return passes * 2 * rows * g * (x.shape[-1] + h + 1)
    if name == "bilstm_rec":  # per (row, step, direction): h W_hh^T and the cell
        xp, w_hh = t
        h = w_hh.shape[-1]
        return 2 * xp.numel() // (8 * h) * (8 * h * h + 10 * h)
    if name == "bilstm_cscan":  # per (row, step, direction, unit): c = f c + i g
        return 3 * t[0].numel() // 4
    if name == "bilstm_sweep":  # per (row, step, direction): the dh carry, the cell, c = f c + i g
        act, _, _, w_hh = t
        h = w_hh.shape[-1]
        return 2 * act.numel() // (8 * h) * (8 * h * h + 20 * h + 3 * h)
    if name.startswith("bilstm"):
        # x (or xp), the input rows; the last argument is a bias (4H) or,
        # for the v5 kernels, W_hh (H)
        x = t[1] if name in REVERSE_SWEEPS else t[0]
        xp = name in ("bilstm_fwd_xp", "bilstm_bwd_xp")
        h = t[-1].shape[-1] if xp else t[-1].shape[-1] // 4
        i = 0 if xp else x.shape[-1]
        steps = 2 * x.numel() // x.shape[-1]  # (model,) row, time step, direction
        # per step: the gate products 8H(I + H) (the v5 kernels take x W_ih^T
        # from xp: 8H H) and the cell; a reverse sweep adds the dh carry
        # (8H H) and, with dx and dW_cat = [x | h | 1]^T dgates in the
        # kernel, 8H I + 8H (I + H). The c rebuilds need only the i, f and g
        # gates: 6H(I + H), and c = f c + i g
        gates = 8 * h * (i + h)
        if name in ("bilstm_cbnd", "bilstm_cbndk", "bilstm_cseq"):
            return steps * (6 * h * (i + h) + 6 * h)
        if name in ("bilstm_segbwd", "bilstm_bwdc"):
            return steps * (3 * gates + 20 * h)
        if name in ("bilstm_bwd_split", "bilstm_bwd_xp"):
            return steps * (gates + 8 * h * h + 20 * h)
        return steps * (gates + 10 * h)
    if name == "stem_tail":  # BN, erf-GELU, dropout, the pool's compare
        return 13 * t[0].numel()
    if name == "stem_tail_bwd":  # BN rebuilt, GELU gradient, dgamma/dbeta sums
        return 16 * t[0].numel()
    if name == "infonce":
        p, b, d = t[0].shape
        return p * b * b * (2 * d + 6)
    if name == "conv_stem":  # same-padded conv, then BN, GELU and the pool
        x, w = t[0], t[1]
        bsz, steps, _ = x.shape
        o, c, k = w.shape
        return bsz * steps * o * (2 * c * k + 12)
    if name.startswith("flash"):
        q, k = t[0], t[1]
        per = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}[name]
        return q.shape[0] * q.shape[1] * k.shape[1] * (per * q.shape[2] + 4)
    if name == "fusion_head":
        bsz, f = t[0].shape
        hidden, ncls = t[7].shape[0], t[9].shape[0]
        # q|k|v and out projections of 3 rows, the 3x3 attention per head,
        # the shared layer and the two heads
        return bsz * (24 * f * f + 36 * f + 2 * f * hidden + 4 * hidden * ncls)
    raise KeyError(name)


def library_call(name: str, args):
    """One PyTorch call computing the kernel's function on the same inputs
    (``nn.LSTM`` in the inputs' dtype, cuDNN's in fp32;
    ``scaled_dot_product_attention``, whose backward computes dQ, dK and dV
    together), or None where there is none or for the S-axis cases. Timed
    beside the kernel only."""
    name = name.removesuffix("_bf16")
    t = tensors(args)
    if name in ("bilstm_gemm", "bilstm_rec", "bilstm_sweep", "bilstm_cscan"):
        return None  # a piece of rows 1, 9 and 11: no one call computes it
    if name.startswith("bilstm"):
        forward_only = name in ("bilstm_fwd", "bilstm_fwd_xp")
        if name == "bilstm_fwd":
            x = t[0]
            if x.dim() != 3:
                return None
            w_ih, w_hh, bias = lstm.stack_params(tuple(t[1:5]), tuple(t[5:9]))
        elif name in ("bilstm_fwd_xp", "bilstm_bwd_xp"):
            # the LSTM over xp: each direction's W_ih selects its 4H half
            x, w_hh = (t[0], t[1]) if name == "bilstm_fwd_xp" else (t[1], t[4])
            if x.dim() != 3:
                return None
            g = w_hh.shape[-2]
            eye, zero = torch.eye(g, device=x.device), torch.zeros(g, g, device=x.device)
            w_ih = torch.stack([torch.cat([eye, zero], 1), torch.cat([zero, eye], 1)])
            bias = torch.zeros(2, g, device=x.device)
        else:
            x, (w_ih, w_hh, bias) = ((t[0], t[2:5]) if name in ("bilstm_cbnd", "bilstm_cbndk",
                                                                 "bilstm_cseq")
                                     else (t[1], t[4:7]))
            if x.dim() != 3:
                return None
        net = torch.nn.LSTM(x.shape[-1], w_hh.shape[-1], batch_first=True, bidirectional=True,
                            device=x.device, dtype=x.dtype)
        with torch.no_grad():
            for d, sfx in enumerate(("", "_reverse")):
                getattr(net, f"weight_ih_l0{sfx}").copy_(w_ih[d])
                getattr(net, f"weight_hh_l0{sfx}").copy_(w_hh[d])
                getattr(net, f"bias_ih_l0{sfx}").copy_(bias[d])
                getattr(net, f"bias_hh_l0{sfx}").zero_()
        net.flatten_parameters()
        if forward_only:
            return lambda: net(x)
        dh = t[0] if name in REVERSE_SWEEPS else torch.ones(
            *x.shape[:-1], 2 * w_hh.shape[-1], device=x.device, dtype=x.dtype)

        def fwd_bwd():
            with torch.enable_grad():
                out, _ = net(x.detach().requires_grad_())
                out.backward(dh)

        return fwd_bwd
    if name == "flash_fwd":
        q, k, v = t[:3]
        return lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=1.0)
    if name in ("flash_bwd_dq", "flash_bwd_dkv"):
        q, k, v = (a.detach().clone().requires_grad_() for a in t[:3])
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q[None], k[None], v[None], scale=1.0)
        return lambda: torch.autograd.grad(out, (q, k, v), t[3][None], retain_graph=True)
    return None


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10-bit mantissa, to nearest, ties away
    from zero, as cvt.rna does); a bf16 tensor is exact in TF32."""
    if t.dtype != torch.float32:
        return t
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def gemm_check(name: str, label: str, mode: str, got, want, ref, one_pass) -> None:
    """Holds one GEMM case to its mode's bar against the fp64 products
    ``ref``: max |kernel - ref| <= GEMM_REL[mode] x max |ref|. Where the
    product has an fp32 operand, the bar must also be one that the same
    products on TF32-rounded operands (``one_pass``, what one TF32 pass
    computes at best) miss."""
    scale = ref.abs().max().item()
    err, err32, err_tf32 = ((v.double() - ref).abs().max().item()
                            for v in (got, want, one_pass))
    bar = GEMM_REL[mode] * scale
    fp32_operand = not name.endswith("_bf16") or mode in ("dx", "dw")
    print(f"gemm {name} {label}: against fp64, max |ref| {scale:.4g}; kernel {err:.3e} "
          f"({err / scale:.2e} of it), fp32 plain {err32:.3e} ({err32 / scale:.2e}), one TF32 "
          f"pass {err_tf32:.3e} ({err_tf32 / scale:.2e}); bar {GEMM_REL[mode]:.0e} of max |ref|")
    check(err <= bar, f"{name} {label}: {err:.3e} from the fp64 products > {bar:.3e}")
    check(not fp32_operand or err_tf32 > bar,
          f"{name} {label}: one TF32 pass ({err_tf32:.3e}) would meet the bar {bar:.3e}")


FLASH_OUTPUTS = {"flash_fwd": ("O", "LSE"), "flash_bwd_dq": ("dQ",),
                 "flash_bwd_dkv": ("dK", "dV")}


def flash_check(name: str, label: str, got, ref, scales=None) -> None:
    """Holds one flash case's outputs to FLASH_FP64_REL of their fp64
    scale: the forward's O and LSE of their largest entry, the backward's of
    ``scales`` (attention.flash_bwd_magnitudes)."""
    for i, (what, g, r) in enumerate(zip(FLASH_OUTPUTS[name], got, ref)):
        largest = r.abs().max().item()
        scale = largest if scales is None else scales[i].item()
        err = (g.double() - r).abs().max().item()
        print(f"{name} {label}: {what} against fp64, max |ref| {largest:.4g}, scale "
              f"{scale:.4g}; kernel {err:.3e} ({err / scale:.2e} of the scale, "
              f"{err / largest:.2e} of max |ref|); bar {FLASH_FP64_REL:.0e} of the scale")
        check(err <= FLASH_FP64_REL * scale,
              f"{name} {label}: {what} {err:.3e} from fp64 > {FLASH_FP64_REL * scale:.3e}")


def flash_ops_ms(name: str, args) -> float:
    """The least time for a flash case's operations: its products (two in
    the forward, three for dQ, four for dK/dV) as three TF32 passes on the
    tensor cores, fp32-accurate as the kernels run them, and the softmax's
    elementwise work (4 operations a score) on the fp32 CUDA cores."""
    q, k = tensors(args)[:2]
    scores = q.shape[0] * q.shape[1] * k.shape[1]
    per = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}[name]
    return (3 * per * scores * q.shape[2] / PEAK_TF32_FLOPS + 4 * scores / PEAK_FP32_FLOPS) * 1e3


def flash_registers(report: str) -> list[str]:
    """One line per instantiation of the flash kernels (head dim D, streamed
    tile) from ptxas's report: its registers and spills."""
    lines, kernel = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for \S*(flash_\w+_kernel)ILi(\d+)ELi(\d+)E", line)
        if m:
            tile = "kBk" if m.group(1) != "flash_bwd_dkv_kernel" else "kBq"
            kernel = f"{m.group(1)}<D={m.group(2)}, {tile}={m.group(3)}>"
            spills = "no spill line"
        elif "Function properties for" in line:
            kernel = None
        elif kernel and "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{kernel}: {regs} registers; {spills}")
            kernel = None
    return lines


def moved_bytes(name: str, args, res) -> int:
    """Bytes one call must move: each input read once, each output written
    once. The c scan's function reads only the i, f and g columns of its
    activations (6H of each row's 8H)."""
    ins = tensors(args)
    nbytes = sum(x.numel() * x.element_size() for x in ins + tensors(res))
    if name == "bilstm_cscan":
        nbytes -= ins[0].numel() * ins[0].element_size() // 4
    return nbytes


def peak_rate(name: str, args) -> float:
    """The card's peak rate for the type of one case's operations: the
    recurrence and the sweep compute in fp32 in both forms; the GEMM's
    bf16 x bf16 products (the bf16 form's proj and gates) at the bf16 rate,
    its products with an fp32 operand at the TF32 rate, counted per pass
    (:func:`operations`); any other bf16 form at the bf16 rate."""
    if name.startswith(("bilstm_rec", "bilstm_sweep", "bilstm_cscan")):
        return PEAK_FP32_FLOPS
    if name.startswith("bilstm_gemm"):
        bf16_only = name.endswith("_bf16") and args[0] in ("proj", "gates")
        return PEAK_BF16_FLOPS if bf16_only else PEAK_TF32_FLOPS
    return PEAK_BF16_FLOPS if name.endswith("_bf16") else PEAK_FP32_FLOPS


def case_results(name: str, items: list) -> dict:
    """Holds each (label, kernel call, plain call, inputs) of one kernel to
    its tolerance (for a bf16 output, its tolerance plus BF16_RTOL of the
    plain value) and times it; returns the largest error and the kernel,
    plain, bound and library times summed over the cases (the library time
    None where no case has a library call)."""
    _, _, tol = KERNELS[name]
    out = dict(err=0.0, ms=0.0, plain_ms=0.0, ops_ms=0.0, bytes_ms=0.0, bound_ms=0.0,
               library_ms=None, case_ms={})
    for label, kern, plain, args, *exact in items:
        res = kern()
        got, want = outputs(name, res), outputs(name, plain())
        torch.cuda.synchronize()
        check(len(got) == len(want) and all(g.shape == w.shape for g, w in zip(got, want)),
              f"{name} {label}: outputs differ in shape")
        if exact and name.startswith("flash"):
            flash_check(name, label, got, *exact[0]())
        elif exact:
            gemm_check(name, label, args[0], got[0], want[0], *exact[0]())
        diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
        e = max(d.max().item() for d in diffs)
        ok = all(bool((d <= tol + (BF16_RTOL if w.dtype == BF16 else 0.0) * w.float().abs()).all())
                 for d, w in zip(diffs, want))
        limit = f"{tol}{' + 1 ulp' if any(w.dtype == BF16 for w in want) else ''}"
        check(ok, f"{name} {label}: max |err| {e:.3e} > {limit}")
        nbytes = moved_bytes(name, args, res)
        ops_ms = (flash_ops_ms(name, args) if name.startswith("flash")
                  else operations(name, args, res) / peak_rate(name, args) * 1e3)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        tk, tp = time_ms(kern), time_ms(plain)
        call = library_call(name, args)
        tl = time_ms(call) if call is not None else None
        print(f"kernel {name} {label}: max |err| {e:.3e} (limit {limit}), {tk:.4f} ms, plain "
              f"{tp:.4f} ms, library {'none' if tl is None else f'{tl:.4f} ms'}, bound "
              f"{max(ops_ms, bytes_ms):.4f} ms ({nbytes / 1e6:.3f} MB, "
              f"{operations(name, args, res) / 1e9:.4f} GFLOP)")
        out["err"] = max(out["err"], e)
        out["case_ms"][label] = (tk, tl)
        out["ms"] += tk
        out["plain_ms"] += tp
        out["ops_ms"] += ops_ms
        out["bytes_ms"] += bytes_ms
        out["bound_ms"] += max(ops_ms, bytes_ms)
        if tl is not None:
            out["library_ms"] = (out["library_ms"] or 0.0) + tl
    out["bound_by"] = "operations" if out["ops_ms"] >= out["bytes_ms"] else "bytes"
    return out


def kernel_results(cases: dict, loso_cases: dict, counts: dict) -> list[dict]:
    """One entry per kernel a path launched: ``ms``, ``plain_ms``,
    ``bound_ms`` and ``library_ms`` summed over its one-model cases;
    ``loso_ms``, ``loso_plain_ms`` and ``loso_bound_ms`` over its S=24
    cases. A bf16 form that no path launched (the InfoNCE kernel's: the
    bf16 step's InfoNCE features are fp32, as in JAX) is held and timed all
    the same, and reported under ``bf16_*`` keys of its fp32 form's entry."""
    results, case_ms = {}, {}
    for name, items in cases.items():
        source, replaces, _ = KERNELS[name]
        check(bool(items), f"{name}: no case")
        r = case_results(name, items)
        case_ms[name] = r["case_ms"]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": counts[name], "max_abs_err": r["err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"]}
        if name in loso_cases:
            lr = case_results(name, loso_cases[name])
            entry.update(loso_ms=lr["ms"], loso_plain_ms=lr["plain_ms"],
                         loso_bound_ms=lr["bound_ms"])
            entry["max_abs_err"] = max(entry["max_abs_err"], lr["err"])
        results[name] = entry
    for name in [n for n in results if n.endswith("_bf16") and not counts[n]]:
        entry = results.pop(name)
        results[name.removesuffix("_bf16")].update(
            {f"bf16_{k}": v for k, v in entry.items() if k not in ("name", "route", "source",
                                                                 "replaces")})
    # the backward pair against SDPA's backward, which computes dQ, dK and dV
    # in one call (timed beside each case of the two)
    for label, (dq_ms, sdpa_dq) in case_ms["flash_bwd_dq"].items():
        dkv_ms, sdpa_dkv = case_ms["flash_bwd_dkv"][label]
        print(f"flash backward {label}: dQ {dq_ms:.4f} + dK/dV {dkv_ms:.4f} = "
              f"{dq_ms + dkv_ms:.4f} ms; SDPA's backward {sdpa_dq:.4f} / {sdpa_dkv:.4f} ms "
              f"(timed beside dQ / dK/dV); pair over SDPA {(dq_ms + dkv_ms) / sdpa_dq:.3f}")
    unlaunched = [name for name, entry in results.items() if not entry["launches"]]
    check(not unlaunched, f"kernels no path launched: {unlaunched}")
    return list(results.values())


def profile_window(label: str, fn, top: int = 25, show: tuple[str, ...] = ()) -> None:
    """Device time by kernel over ``fn()`` under torch.profiler, against the
    host clock of the same window: the ``top`` kernels, and every kernel
    whose name holds one of ``show``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds = synced(fn)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    print(f"profile {label}: {seconds * 1e3:.3f} ms on the host clock under the profiler, "
          f"device time {total / 1e3:.3f} ms over {sum(e.count for e in events)} kernel launches")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < top or any(name in e.key for name in show):
            print(f"profile {label} {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
                  f"{e.key[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one train epoch of each trainer with torch.profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:  # beside the builds, one nvcc more
        report = pool.submit(ptxas_report, "flash_attn")
        libs = build_all()
        registers = flash_registers(report.result())
    print(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in libs))
    # each kernel at every head dim and tile, but the forward at D = 128 and
    # 128 keys (its two stages do not fit a block's shared memory, so it is
    # not built) and the backward at D = 128 but at 32 rows (its ring holds
    # 32-row stages whatever the tile)
    tiles, dims = len(attention.TILES), len(attention.HEAD_DIMS)
    forms = dims * tiles - 1 + 2 * ((dims - 1) * tiles + 1)
    check(len(registers) == forms, f"ptxas reported {len(registers)} of {forms} flash kernels")
    for line in registers:
        print(f"ptxas {line}")
    # the backward forms up to D = 64 keep their working set in registers
    spilling = [line for line in registers if "bwd" in line and "D=128" not in line
                and not line.endswith(", 0 bytes spill stores, 0 bytes spill loads")]
    check(not spilling, f"backward flash forms at D <= 64 spill: {spilling}")

    model, first, serve_counts, (pool, plan, fp32_logits) = serving_phase(device)
    serve_bf16_counts = serving_bf16_phase(model, pool, plan, fp32_logits)
    serve_v5_counts = serving_v5_phase(model, pool, plan, fp32_logits)
    full = hci_dataset(device)
    trainer = make_trainer(full)
    train_counts = training_phase(trainer)
    idx, mask = trainer.train_data.epoch_plan(BATCH, np.random.default_rng(SEED + 2))
    batch, mask = trainer.train_data.gather(idx[0]), mask[0]
    gradient_parity(trainer, batch, mask)
    vt = make_loso_trainer(full)
    loso = loso_phase(vt)
    loso_step_parity(full)
    schedule_counts = loso_schedules_phase(full)
    schedule_gradient_parity(full)
    loso_bf16_counts, vt16 = loso_bf16_phase(full, loso)
    b512_counts = loso_b512_phase(full)
    memhacl_counts, (encoder, projector, classifier), (emotion, train, val) = memhacl_phase(
        device)
    attention_counts, mha, x_attn = attention_phase(device)
    if args.profile:
        profile_window("train epoch", lambda: trainer.train_epoch(EPOCHS + 1), show=("cscan",))
        profile_window("LOSO train epoch", vt.train_epoch, top=30, show=("cscan",))
        profile_window("LOSO bf16 train epoch", vt16.train_epoch, top=30, show=("cscan",))
        for schedule in ("v5", "v6", "v8"):  # the other schedules with dx and dW_cat in GEMMs
            vts = make_loso_trainer(full, lstm_schedule=schedule)
            vts.train_epoch()  # warm-up: first launches, cuBLAS handles
            profile_window(f"LOSO {schedule} train epoch", vts.train_epoch, top=30)
            del vts
        profile_window("ME-MHACL pretrain epoch", lambda: memhacl_pretrain(
            encoder, projector, emotion, num_epochs=1, batch_size=MEMHACL_BATCH, verbose=False))
        profile_window("ME-MHACL finetune epoch", lambda: memhacl_finetune(
            encoder, None, classifier, train, val, num_epochs=1, batch_size=MEMHACL_BATCH,
            verbose=False), show=("fusion_head",))

    phases = (serve_counts, serve_bf16_counts, serve_v5_counts, train_counts, loso["counts"],
              schedule_counts, loso_bf16_counts, b512_counts, memhacl_counts, attention_counts)
    counts = {name: sum(c[name] for c in phases) for name in KERNELS}
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.set_grad_enabled(False)  # plain versions must not record autograd graphs
    cases = {name: [] for name in KERNELS}
    serving_kernel_cases(model, first["eeg"], cases)
    training_kernel_cases(trainer.model, batch, mask, gen, cases)
    loso_cases = loso_kernel_cases(vt, gen)
    schedule_kernel_cases(vt, gen, cases, loso_cases)
    memhacl_kernel_cases(encoder, classifier, val, cases)
    attention_kernel_cases(mha, x_attn, gen, cases)
    dropout_check(trainer.model, batch, gen)
    # the bf16 forms: the eval model forward cast to bf16, the bf16 LOSO step
    serving_kernel_cases(copy.deepcopy(model).to(BF16), first["eeg"].to(BF16), cases)
    loso_cases.update(loso_kernel_cases(vt16, gen, one_model=cases))
    print(json.dumps({"kernels": kernel_results(cases, loso_cases, counts)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, LOSO training, phased
curriculum, SimCLR, ME-MHACL and attention paths, bf16 LOSO and phased training,
bf16 serving and bf16 attention, the serving artifacts of ``torch.export`` and the int8
serving forward, the BiLSTM's other kernel schedules, the trainers'
checkpoints and the evaluation of a saved model, the command-line
drivers, and the DSP, EEG features and electrode graph, on one CUDA card,
and check them.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py            # the checks below
    python3 chip_smoke.py --profile  # also torch.profiler windows over train epochs

It needs a CUDA card and exits non-zero without one. In order, it

1. turns TF32 off for matmuls and cuDNN convs (the plain versions are the
   fp32 reference) and builds every kernel in
   ``multimodal_sentiment_aanalysis_tpu_torch/csrc`` with nvcc, one process
   per source, all at once, and beside them prints ptxas's registers and
   spills of each instantiation of the three flash kernels (``nvcc -Xptxas
   -v``), failing if a backward form at D <= 64 spills, and of their bf16
   forms (``csrc/flash_attn_bf16.cu`` and, the backward on wgmma and TMA,
   ``csrc/flash_bwd_bf16.cu``; every head dim 16-128 and tile), failing if
   any spills, and of the stem
   tail's forward (its four forms) and the serving conv stem; then the
   ``dsp`` phase (``ops.dsp``, ``ops.features``, ``ops.graph``): prints
   scipy's version; on the synthetic MAHNOB-HCI raw EEG stack (480 x 32 x
   585, ``make_synthetic_hci_data()["raw_data"]["eeg"]``) with the counters
   reset just before, ``butterworth_filter(x, 256, 1, 70)``, the 60 Hz
   notch of each (585, 32) trial along axis 0 through
   ``batched(filter_data_notch, 60, 5, fs=256)``, ``batched`` time-domain
   (480, 128) and frequency-domain (480, 5, 96) features, trial 0's
   ``re_data_slide(..., 128, 0.5, is_filter=True, norm_method="z_score")``,
   ``initialize_graph(64, 32)`` and the fp64 band-pass of the stack as
   float64; checks one launch of the filter kernel per filter call over the
   whole stack (``sos_filtfilt`` 9, ``sos_filtfilt_f64`` 1), each result
   against the same call on CPU copies through the plain versions (filters
   1e-4 of the max |y| in fp32, 1e-10 in fp64; PSD 1e-4, DE 2e-3, bin power
   and time-domain features 1e-4 relative; the graph 1e-6) and 8 series of
   the fp64 band-pass against ``scipy.signal.filtfilt`` (1e-5); prints the
   phase's seconds;
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
   serving's; then in bf16 under v5 (two launches of the v5 forward's bf16
   form, ``bilstm_fwd_xp_bf16``, per request, no other kernel; against
   fp32 serving at the bf16 bar above); then ``export_serving`` of the same model into four artifacts
   (batch 64 with ``use_pallas=True``, batch-polymorphic fp32 and bf16,
   batch 64 under v5), each saved to a file, loaded with ``load_serving``
   (no launch while tracing) and run over the same 100 requests with the
   counters reset just before: launches per request exactly the path's
   (``bilstm_fwd`` 2, plus ``conv_stem`` 2 with ``use_pallas``;
   ``bilstm_fwd_bf16`` 2; ``bilstm_fwd_xp`` 2), logits within 1e-5 of the
   largest |logit| of the closure's on the same requests (bit-equality
   printed), the polymorphic fp32 one also at batches 1, 3 and 512 and in a
   fresh ``python3 -c`` process that imports torch and the op library
   alone (never the port's ``models``, ``train`` or ``eval.serving``);
   export seconds, artifact MB, the loaded ms/batch beside the closure's,
   and the ops' dispatch cost (host us per call through each op against its
   CUDA implementation called directly);
   then ``build_quantized_serving_forward`` with fp32 and with bf16 glue
   over the same requests and a request each of 16 and 17 rows: two
   launches of row 1's recurrence (``bilstm_rec``, ``bilstm_rec_bf16``) a
   request and no other kernel, logits against fp32 serving at the JAX
   package's bar (max gap 0.1 of the largest |logit|, argmax agreement
   0.9), the 16-row request against the CPU plain int8 path at the CPU
   tests' bar, ms/batch;
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
   v9's; then the same in bf16 (``compute_dtype``/``moment_dtype=
   "bfloat16"``, v9 then v5, v6, v8 and v9.1 from the same init): the
   schedule's bf16 forms once per layer and step for all 24 models (the
   held-out evaluation in the fp32 forms), no other schedule's, ms/step
   and peak memory, and each schedule's epoch-2 per-subject train loss
   within 1e-2 relative of bf16 v9's and within 0.1 of the same schedule's
   fp32 trainer's; then one LOSO step's gradients (``dropout=0.0``, one fixed batch)
   under each schedule against v9's on the card (all 24 models) and subject
   0's against the CPU plain path, at the gradient-parity bar;
   then the phased curriculum (``cli.py phased``): ``VectorizedPhasedTrainer``
   over the 24 subjects (S=24, B=64, full width, reference dropout) through
   ``run(1, 1, 1, 1, 1)`` phase by phase, each phase's
   ``run_phase_on_device`` under ``set_sync_debug_mode("error")`` with the
   counters reset just before: every phase's launches (the whole step's
   kernels in ``eeg`` and ``fusion_arousal``, the forward's in ``eye``,
   ``pps`` and ``valence``: the parameters outside a phase's grad set enter
   its loss detached), finite per-subject losses, every parameter column
   outside the phase's update set bit-unchanged and every update-set
   tensor moved (in ``valence`` the valence head alone); then 2 timed
   ``fusion_arousal`` epochs (ms/step and samples/s/chip, counted as the JAX
   ``bench.py`` counts them, on the host clock and by CUDA events over the
   same window; ``--profile`` adds a profiled epoch); the same curriculum
   in bf16 (its forms' launches, each phase's per-subject loss within
   LOSS_GAP_LIMIT of fp32's); on a ``dropout=0.0`` copy, subjects 0 and 17
   of one ``valence`` and one ``eeg`` step against a single-subject
   ``MultiTaskTrainer`` step (loss, clipped gradients, BatchNorm stats,
   updated parameters); and ``MultiTaskTrainer`` for subject 0 through
   ``run(1, 1, 1, 1, 1)``'s host loop and fused phases, its launches
   checked; the phase's wall seconds;
   then the SimCLR stack (``cli.py simclr --vectorized``):
   ``VectorizedSimCLRTrainer`` over the 24 subjects (S=24, B=64, feat_dim
   256, 8 heads, EEG (32, 585), dropout 0.4 in the stem and 0.5 in the
   projector and classifier, each subject's balanced pairs of the synthetic
   set) through 2 pretrain and then 2 finetune epochs, each epoch under
   ``set_sync_debug_mode("error")`` with the counters reset just before:
   a pretrain step's launches (two train-mode views and the backward through
   both: 4 of each BiLSTM and stem-tail kernel, forward and backward, no
   InfoNCE), a finetune step's and the evaluation's (the frozen encoder's
   forward: 2 of each forward kernel), one launch for all 24 models; finite
   per-subject losses; the encoder and projector row and its BatchNorm stats
   bit-unchanged by the finetune; the second epoch of each timed (ms/step,
   pairs/s/chip for the pretrain, on the host clock and by CUDA events over
   the same window; ``--profile`` adds a profiled pretrain epoch); on a
   ``dropout=0.0`` copy, subjects 0 and 17 of one pretrain and one finetune
   step against the sequential engines' one-model steps (loss, gradients,
   BatchNorm stats, updated parameters); and ``contrastive_pretrain`` and
   ``finetune`` for subject 0, one epoch each, their launches checked; the
   phase's wall seconds. Its kernels run at the LOSO step's shapes, so the
   LOSO kernel cases of 8 cover them;
5. ME-MHACL (``cli.py memhacl``): ``make_synthetic_emotion_arrays(n=480)``
   on the card, the 80/20 split, full-width encoder, projection head and
   classifier (feat_dim 256, 8 heads) from seeded generators;
   ``memhacl_pretrain`` for 2 epochs on all 480 rows and ``memhacl_finetune``
   for 2 epochs, batch 32, with the launch counters reset just before;
   checks finite losses, that every parameter tensor moved, that the
   validation ran through the fused head (one launch per validation batch
   and epoch, no other kernel), and the fused-head logits of a validation
   batch against the module path on the card (1e-4) and on the CPU (1e-3);
   prints ms/step; then the validation forward again with the trained
   encoder and classifier cast to bf16, the counters reset just before
   (one launch of the fused head's bf16 form per validation batch, no
   other kernel), its bf16 logits against the fp32 ones at the JAX
   package's bf16 bar (rtol/atol 0.1);
6. attention: ``MultiheadAttention(256, 8)`` self-attention at B=64,
   T=585, forward and backward on the card with the counters reset just
   before (one launch of each flash kernel), against the CPU plain path
   (outputs 1e-3, gradients as in 3); then ``attention_bf16``: the same
   module and input cast to bf16, forward and backward with the counters
   reset just before (one launch of each flash kernel's bf16 form, no fp32
   flash kernel and no other kernel), bf16 outputs and gradients, all
   finite, each within 2e-2 of its largest entry of the same bf16 module on
   the CPU (the bf16 plain path) and within 0.1 of the fp32 module's on the
   card (the JAX package's bf16 bar), the phase's seconds;
7. checkpoints, on the trainers the earlier phases built: the LOSO
   trainer's ``save_state`` (early stop on, S=24, B=64), restored into a
   fresh ``make_loso_trainer`` (every tensor of the state and the
   generators bit-equal), then one host-plan epoch of both (launches per
   step PER_STEP's, per-subject losses within 1e-3 relative, the
   generators equal again), the file's MB and the seconds to save and to
   restore; subjects 0 and 17 from ``subject_variables`` to ``.pt`` files,
   evaluated by ``Tester.run`` on their held-out rows (one launch of each
   eval-forward kernel a batch, no InfoNCE: the forward takes no labels),
   their accuracies against ``vt.evaluate()`` at S=24 (a row may differ
   only where its top-two logit margin is under 1e-4, printed), the
   Tester's ms per batch, ``predict_single`` at B=1 on three rows against
   ``evaluate``'s probabilities (1e-5); the single-subject ``Trainer``'s
   state bit-equal after a restore, and ``test_with_loaded_model`` of its
   ``best_model.pt`` against ``trainer.test()`` (1e-5); the phased
   trainers' (24-subject and one-subject) state bit-equal after a restore
   and one ``fusion_arousal`` epoch of each pair (losses within 1e-3
   relative), and ``save_checkpoints``' 24 files, each loaded strictly into
   the flagship; whether sklearn, matplotlib and pandas are importable (the
   phase uses none of them); then the command-line drivers (the ``cli``
   phase): ``cli.main`` in this process at reference widths on the synthetic
   set (24 subjects, feat_dim 256, B=64) with ``--no-plots --quiet``, the
   counters reset just before each subcommand and read just after:
   ``inspect``; ``vloso --fused --early-stop --epochs 2 --save-state`` and
   ``--resume`` of that file for 1 epoch (launches exactly PER_STEP a step,
   PER_EVAL an epoch's held-out evaluation, TESTER_EVAL for each of the two
   final accuracies); ``single --subjects 0 --epochs 1``; ``phased
   --vectorized --epochs 1 1 1 1 1`` and ``eval`` of the subject-0 file its
   ``save_checkpoints`` wrote (accuracies equal to the ``Tester``'s on that
   trainer's ``subject_variables(0)``); ``phased --subjects 0 --epochs 1 0 0 1
   0 --history-dir``, with ``--synthetic`` and with ``--data`` of a
   ``save_pickle`` of the same dict (accuracies equal, metrics within 1e-3
   relative); ``simclr --vectorized`` and ``memhacl``, one pretrain and one
   finetune epoch each; ``export --synthetic`` (no launch while tracing,
   the payload's byte count the file's size, the artifact at B=64 against
   ``build_serving_forward`` of the seeded flagship within 1e-5 of the
   largest |logit|, row 1 twice); every other subcommand's launches nonzero on its
   path's kernels (rows 1, 2, 9, 11, 12, 13 and their pieces; no InfoNCE in
   ``simclr``; rows 1 and 2 in ``eval``; row 17 in ``memhacl``) and 0
   elsewhere, each results JSON with the JAX payload's keys and accuracies in
   [0, 1]; then ``python -m multimodal_sentiment_aanalysis_tpu_torch.cli
   inspect --synthetic`` in its own process, and ``torchrun --standalone
   --nproc-per-node 1 -m ...cli vloso --dp --epochs 1`` against the same
   command without ``--dp`` (``python -m``), each in its own process, the
   results JSON's accuracies equal; prints each subcommand's seconds and
   the phase's; then the ``parallel`` phase (``parallel/``, ROADMAP A13) at
   full width (feat_dim 256, EEG (32, 585), 24 subjects, B=64, dropout 0,
   TF32 off): one host-plan epoch of ``VectorizedLOSOTrainer(mesh=
   make_mesh())`` on a one-rank NCCL group in this process beside the
   unsharded trainer from the same seed (cuDNN's deterministic algorithms
   for both), per-subject losses, accuracies, parameters and BatchNorm
   stats bit-equal; then two ``gloo`` ranks on card 0 (``spawn_ranks``: a
   ``FileStore`` in a temporary directory, CUDA tensors; NCCL refuses two
   ranks on one device), each running the subject-sharded LOSO epoch (12
   models a rank; per-subject losses within 1e-5 relative of the
   unsharded run's, accuracies equal), ``MultiTaskTrainer(mesh=)``'s
   ``fusion_arousal`` epoch of subject 0 (loss within 1e-5 relative of the
   one-process trainer's, the largest parameter difference printed, the
   ranks' parameters bit-equal, the bytes each step all-reduces) and
   ``dryrun_multichip``'s flavours (its lines printed), and before the
   epoch one ``eeg`` and one ``fusion_arousal`` step's gradients at lr 0
   on a 64-row batch whose last 5 rows are padding, summed over the ranks,
   against the one-process step's (1e-5 of each tensor's largest entry plus
   1e-6 of the step's largest); each rank's
   launches of rows 1, 2, 9, 11, 12 and 13 printed and held above 0, and
   each run's ms/step beside the card's name and power limit (two ranks
   share one card: not a scale-out figure); and on the same two ranks
   tensor parallelism (``parallel/tp.py``, ROADMAP A13b) on a ``(data=1,
   model=2)`` mesh: the flagship sharded by JAX's specs, its eval forward
   within 1e-5 of the largest |logit| of the one-process model's, one SGD
   step (lr 1e-2) of the full objective at dropout 0 and one at the model's
   own dropout (0.4 / 0.3; both model ranks draw one process's stream), the
   gathered parameters held to the one-process step from the same seed
   (the loss within 1e-5 relative, each update within 1e-5 of the tensor's
   largest update plus 1e-6 of the step's largest, each BatchNorm running
   stat within 1e-5 of its largest entry), each rank's launches of rows 1,
   2, 9, 11, 12 and 13 in each TP step held above 0, the replicated
   parameters bit-equal on the two ranks, ten more TP steps' ms/step
   and the bytes and calls each all-reduces, and three more under
   torch.profiler (host ms, device ms, host ms in the all-reduces); with
   two cards, the LOSO epoch and the TP checks again over NCCL on two
   cards, else a line that says they were skipped; then rows 2 and 12 on
   a TP rank's channel shard: each of the two stem stages at B=64 split in
   two, each shard's keep bits bit for bit against the unsharded layer's
   columns and the CPU Philox model, at the stage's pool its output and
   codes bit for bit against the unsharded kernel's columns and within
   row 2's tolerance of the plain version, row 12 on its code within row
   12's tolerance of the plain version, and row 2's time on the shard
   beside the full width's, each with its bytes bound;
8. holds every kernel against its plain PyTorch version at the shapes its
   paths give it (real activations of the first request, train batch,
   validation batch or attention input; for the S=24 cases the LOSO
   trainer's stacked weights and seeded activations; the flash kernels also
   at a 200-query / 100-key and a 9-row shape, their bf16 forms at the
   ``attention_bf16`` phase's bf16 q, k, v and the same two shapes in bf16,
   also against fp64 at bf16 bars: O within 1e-2 of its largest entry,
   LSE 1e-5, dQ, dK and dV 1e-2 of their scale,
   ``tests/test_torch_port_flash_bf16.py``; delta as ``attention.
   flash_delta`` forms it, and each bf16 backward case run twice and held
   bit-equal, and split into host and device time), and each bf16 form at the
   bf16 paths' shapes (the bf16 serving model's activations, the bf16 LOSO
   trainer's weights cast to bf16 with seeded bf16 activations, and subject
   0 alone), the six kernels of the other BiLSTM schedules and their bf16
   forms at S=24 and at subject 0 (the fp32 LOSO trainer's weights, seeded
   activations; the bf16 trainer's weights in bf16, bf16 activations; rows 8,
   7 and 5 are the GEMM and the sweep at K=1 over the full c, row 6 the
   GEMM and the c scan at K=1), and the pieces that rows 1, 9, 11, 6, 8, 7
   and 5 launch (the tensor-core GEMM at its five products: projection,
   gate recompute, dx, dW_cat, gate recompute from xp; the recurrence; the
   c scan, fp32 only, its one form, at K=4 and at K=1, row 6's share of the
   v8 and v6 backward; the sweep, at K=4 and, in fp32, at K=1 over the
   full c) at each layer of the training
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
   their softmax at the fp32 rate, the flash kernels' bf16 forms' products
   as one bf16 pass at the bf16 rate; the conv stem's products as three TF32
   passes plus its epilogue at the fp32 rate; the InfoNCE similarities as
   three TF32 passes, one bf16 pass in its bf16 form, plus ~6 fp32
   operations a score), prints each attention
   case's backward pair (dQ + dK/dV), fp32 and bf16, against SDPA's
   backward in the same dtype, and checks
   the stem tail's dropout (keep share 1 - p within 5 sigma, every output
   exactly 0 or GELU(y) / (1 - p)); the stem tail also at p = 0.4 with
   its seeds given (S=1 and S=24, fp32 and bf16) against the plain version
   fed the CPU Philox model's mask (``conv_stem_train.keep_mask_plain``),
   its keep bits at pool 1 against that model bit for bit at each LOSO
   stage's shape (S=24 and subject 0 alone, fp32 and bf16), and its
   one-model cases split into the wrapper's host time and the device time
   under torch.profiler; the conv stem also against fp64 (1e-5 of the
   largest entry, a bar one TF32 pass misses,
   ``tests/test_torch_port_stem_rows23.py``); the InfoNCE kernel (row 13)
   at the step's shapes (one model's 3 problems on one shared row, the
   LOSO step's P=72 with per-problem rows and mixed validity) and on two
   independent sets of features at P=72 with each model's row shared by
   its 3 problems, at B=64 and B=512, also against fp64 (1e-5 of each
   loss, a bar one TF32 pass misses in fp32,
   ``tests/test_torch_port_infonce_tc.py``), and each of its cases split
   into host and device time, the tile kernel apart from the mean kernel;
   the stem tail's backward (row 12: ``dy`` at the conv's full length, its
   partials summed) and the fused head (row 17, fp32 and bf16, B=32 and 37;
   fp32 also against fp64, 1e-5 of the largest |logit|, a bar one TF32 pass
   misses, ``tests/test_torch_port_rows12_17.py``), each case split into
   host and device time, with ptxas's registers and spills of each form of
   the two kernels; the IIR filter kernel's two forms (fp32 and fp64) at
   the ``dsp`` phase's band-pass of the 480 x 32 series (their plain
   version, ~46,000 launches a call, timed over 3 calls; no library call
   computes ``filtfilt``);
9. prints the card's name and power limit, one JSON line of per-kernel
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
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from unittest import mock

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_sentiment_aanalysis_tpu_torch import (
    MultimodalTransformerModel,
    cli,
    build_all,
    build_serving_forward,
    launch_counts,
    reset_launch_counts,
)
from multimodal_sentiment_aanalysis_tpu_torch.data import (
    DeviceDataset,
    assemble_features,
    build_contrastive_pairs,
    epoch_batch_indices,
    loso_split,
    make_synthetic_emotion_arrays,
    make_synthetic_hci_data,
    random_split_indices,
    save_pickle,
    subject_ids_array,
)
from multimodal_sentiment_aanalysis_tpu_torch.eval import (
    Tester,
    build_quantized_serving_forward,
    export_serving,
    load_serving,
)
from multimodal_sentiment_aanalysis_tpu_torch.kernels import (
    attention,
    contrastive,
    conv_stem,
    conv_stem_train,
    fusion_head,
    iir,
    lstm,
    ptxas_report,
)
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    Classifier,
    MEMHACLClassifier,
    MEMHACLEncoder,
    MultiheadAttention,
    MultiModalEncoder,
    ProjectionHead,
)
from multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model import init_parameters
from multimodal_sentiment_aanalysis_tpu_torch.ops import (
    all_frequency_features,
    all_timedomain_features,
    batched,
    butterworth_filter,
    filter_data_notch,
    initialize_graph,
    re_data_slide,
)
from multimodal_sentiment_aanalysis_tpu_torch.ops.losses import masked_cross_entropy
from multimodal_sentiment_aanalysis_tpu_torch.train import (
    PHASE_ORDER,
    PHASES,
    MultiTaskTrainer,
    Trainer,
    VectorizedLOSOTrainer,
    VectorizedPhasedTrainer,
    VectorizedSimCLRTrainer,
    apply_grad_mask,
    clip_by_global_norm,
    clip_rows_by_global_norm,
    contrastive_pretrain,
    finetune,
    memhacl_finetune,
    memhacl_logits,
    memhacl_pretrain,
)
from multimodal_sentiment_aanalysis_tpu_torch.train.simclr import finetune_step, pretrain_step
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
# a gradient whose exact value is 0 (a bias before a BatchNorm): each path's
# at most this share of the largest gradient (float noise is ~1e-6 of it)
NOISE_REL = 1e-4
DROPOUT_P = 0.4
TIMED_CALLS = 20
LOSO_FUSED_EPOCHS = 2
LOSO_SCHEDULE_EPOCHS = 2  # fused epochs of each schedule's trainer, fp32 and bf16
PARITY_SUBJECTS = (0, 17)  # LOSO models checked against a single-model Trainer step
LOSO_LR = 1e-4             # the trainers' default learning rate
# the kernels each call of rows 1, 9, 11, 6, 8, 7 and 5 launches on a train
# step's path (each call also counts once under the row's own name): the
# projection GEMM and the recurrence; the c scan (row 9, and row 6 at K=1);
# the gate-recompute, dx and dW_cat GEMMs and the sweep (row 11, and row 8 at
# K=1 over the full c); the gate-recompute GEMM and the sweep at K=1 (row 7);
# the gates-from-xp GEMM and the sweep at K=1 (row 5). Rows 9, 10 and 6 run
# there only inside the v9, v9.1, v8 and v6 layer backwards, which compute the
# gate activations once for the scan and the sweep (the GEMM counted under row
# 11, 8 or 7); a call of row 9, 10 or 6 alone launches that GEMM too
ROW_KERNELS = {"bilstm_fwd": {"bilstm_gemm": 1, "bilstm_rec": 1},
               "bilstm_cbnd": {"bilstm_cscan": 1},
               "bilstm_cbndk": {"bilstm_cscan": 1},
               "bilstm_segbwd": {"bilstm_gemm": 3, "bilstm_sweep": 1},
               "bilstm_cseq": {"bilstm_cscan": 1},
               "bilstm_bwdc": {"bilstm_gemm": 3, "bilstm_sweep": 1},
               "bilstm_bwd_split": {"bilstm_gemm": 1, "bilstm_sweep": 1},
               "bilstm_bwd_xp": {"bilstm_gemm": 1, "bilstm_sweep": 1}}
# kernels with one form, which a bf16 path launches too: the c scan reads
# the fp32 gate activations in both
ONE_FORM = ("bilstm_cscan",)


def with_row_kernels(per: dict) -> dict:
    """``per`` (launches by kernel) with the launches of the kernels that
    the rows of ROW_KERNELS make, in the same form (fp32 or bf16), added."""
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


def bf16_forms(per: dict) -> dict:
    """``per`` (launches by kernel) in the bf16 forms, but the InfoNCE
    kernel and the one-form kernels."""
    return {(name if name in ("infonce", *ONE_FORM) else f"{name}_bf16"): n
            for name, n in per.items()}


PER_STEP_BF16 = bf16_forms(PER_STEP)
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
# bf16 schedules against bf16 v9 from the same init and plans: the same
# function, rounded to bf16 at other places (v5 rounds its projection);
# per-subject epoch-2 train loss, relative
BF16_SCHEDULE_LOSS_GAP = 1e-2
LOSO_B512 = 512       # the JAX bench's vloso_bf16_b512 batch
# the phased curriculum: run(1, 1, 1, 1, 1), then 2 timed fusion_arousal
# epochs. A step launches the whole step's kernels where the phase's loss
# reaches the EEG encoder, its forward's kernels elsewhere (the encoder
# enters those phases' loss detached, so no backward runs there)
PHASED_EPOCHS, PHASED_TIMED_EPOCHS = (1, 1, 1, 1, 1), 2
PHASE_STEP = {phase: PER_STEP if phase in ("eeg", "fusion_arousal") else PER_EVAL
              for phase in PHASE_ORDER}
LOSS_GAP_LIMIT = 0.1  # bf16 against fp32 epoch-2 train loss, relative, per subject
# the SimCLR stack (cli.py simclr --vectorized): 2 pretrain and 2 finetune
# epochs of the 24-subject trainer at its default learning rates. A pretrain
# step encodes two views in train mode and runs the backward through both; a
# finetune step and the evaluation after each finetune epoch run the frozen
# encoder's forward alone (eval mode, no graph); no InfoNCE kernel (the
# two-view NT-Xent is plain tensor math, as in JAX) and no flash kernel (the
# fusion attention has length 3)
SIMCLR_EPOCHS, SIMCLR_PRETRAIN_LR, SIMCLR_FINETUNE_LR = 2, 1e-3, 1e-4
SIMCLR_PRE_STEP = with_row_kernels(dict(bilstm_fwd=4, bilstm_cbnd=4, bilstm_segbwd=4,
                                        stem_tail=4, stem_tail_bwd=4))
SIMCLR_FT_STEP = with_row_kernels(dict(bilstm_fwd=2, stem_tail=2))
# the checkpoints phase: the Tester's eval forward takes no labels, so no
# InfoNCE: rows 1 and 2 twice a batch, one launch for the batch
TESTER_EVAL = with_row_kernels(dict(bilstm_fwd=2, stem_tail=2))
TIE_MARGIN = 1e-4    # top-two logit margin under which S=1 and S=24 may disagree on a row
PREDICT_ATOL = 1e-5  # predict_single at B=1 against evaluate's rows
CKPT_ATOL = 1e-5     # test_with_loaded_model against trainer.test() on the same weights
# a resumed epoch against the saved trainer's, per subject, relative: card
# training is not bit-reproducible (gradient parity is bounded at 1e-3)
RESUME_RTOL = 1e-3
# bf16 serving against fp32 serving: the JAX package's bar (tests/test_serving.py)
SERVE_BF16_TOL, SERVE_BF16_ARGMAX = 0.1, 0.9
# a loaded artifact against its closure on the same requests, over the
# largest |logit|: the same ops in the same order
EXPORT_REL = 1e-5
# the polymorphic artifact's other batches (the pool rows drawn with replacement)
EXPORT_BATCHES = (1, 3, 512)
# the int8 forward against the CPU plain int8 path on the same rows, at the
# CPU tests' bar (tests/test_torch_port_quantization.py): with fp32 glue
# each row within QUANT_ROW_ATOL but at most QUANT_FLIPPED_ROWS of the rows,
# which hold an activation code rounded the other way at a .5 and may differ
# by QUANT_FLIPPED_REL of the largest |logit|; with bf16 glue QUANT_BF16_ATOL
QUANT_ROW_ATOL, QUANT_FLIPPED_ROWS, QUANT_FLIPPED_REL, QUANT_BF16_ATOL = 1e-5, 0.25, 0.05, 2e-2
QUANT_ROWS = (16, 17)  # requests of 16 rows or fewer pad torch._int_mm's rows to 17
# the GEMM of rows 1 and 11 against its products in fp64, per mode: max
# |err| over max |ref| (gemm_check)
GEMM_REL = {"proj": 1e-5, "gates": 1e-5, "dx": 1e-5, "dw": 1e-5, "gates_xp": 1e-5}
# the flash kernels (3xTF32 on the tensor cores) against fp64 (flash_check):
# max |err| of the forward's O and LSE over their max |ref|, and of the
# backward's dQ, dK and dV over their scale, the largest entry of each one's
# sum of absolute terms (attention.flash_bwd_magnitudes: 2.2-5.1x the
# largest entry at these shapes, and finite where dQ and dK cancel to 0 at
# Tk = 1); one TF32 pass misses it at the attention phase's shape and at
# 200 / 100, the fp32 plain version meets it
# (tests/test_torch_port_flash_fwd_tc.py, tests/test_torch_port_flash_bwd_tc.py)
FLASH_FP64_REL = 1e-5
# the flash kernels' bf16 forms (one bf16 pass a product, P and dS rounded
# to bf16, bf16 O, dQ, dK and dV) against fp64 on the same bf16 inputs
# (flash_check), per output: O within 1e-2 of its largest entry (bf16 rounds
# O to 2^-9 of itself and P to 2^-9 of each term), LSE within 1e-5 (fp32
# from exact products), dQ, dK and dV within 1e-2 of their scale
# (tests/test_torch_port_flash_bf16.py; 3.3e-3 and 3.8e-3 the largest
# measured on the H100)
FLASH_BF16_FP64_REL = {"O": 1e-2, "LSE": 1e-5, "dQ": 1e-2, "dK": 1e-2, "dV": 1e-2}
# the attention_bf16 phase: the bf16 module on the card against the same
# module on the CPU (the bf16 plain path), and against the fp32 module on
# the card, each output and gradient within this share of its largest
# fp32 / CPU entry: bf16 rounds the same values at the same points on the
# two devices, summed in other orders; against fp32, the JAX package's
# bf16 bar (SERVE_BF16_TOL)
ATTN_BF16_CPU_REL, ATTN_BF16_FP32_REL = 2e-2, 0.1
# row 13 (3xTF32 on the tensor cores in fp32) against fp64 (infonce_check):
# |err| of each loss over that loss, on two independent sets of features (with
# n1 as n2, the model's own call, a row's diagonal outweighs the rest at
# temperature 0.01 and every loss sits at -log(1e-12) whatever the products);
# one TF32 pass misses it in fp32 (tests/test_torch_port_infonce_tc.py)
INFONCE_FP64_REL = 1e-5
# the serving conv stem (3xTF32 on the tensor cores) against fp64
# (conv_check): max |err| over the largest fp64 entry, a bar one TF32 pass
# misses (tests/test_torch_port_stem_rows23.py)
CONV_FP64_REL = 1e-5
# the stem tail's dropout seeds, one per model, given explicitly so that its
# keep mask can be held bit for bit against the CPU Philox model
# (conv_stem_train.keep_mask_plain) whatever a generator's state
STEM_SEED_BASE = 2 ** 40 + 12345
BF16_RTOL = 2.0 ** -7  # a bf16 output of a bf16 form: one ulp of the value on top of its atol
# ME-MHACL: the MAHNOB-HCI trial count of the other phases, the reference
# batch, full width
MEMHACL_N, MEMHACL_BATCH, MEMHACL_EPOCHS, MEMHACL_F, MEMHACL_HEADS = 480, 32, 2, 256, 8
HEAD_ATOL = 1e-4  # fused head against the module path on the card
# the fused head (3xTF32 on the tensor cores in fp32) against fp64
# (head_check): max |err| of the logits over the largest fp64 |logit|, a bar
# one TF32 pass misses (tests/test_torch_port_rows12_17.py)
HEAD_FP64_REL = 1e-5
# DSP (ops.dsp, ops.features, ops.graph) on the synthetic MAHNOB-HCI raw EEG
# stack (480 trials x 32 channels x 585 samples): the 1-70 Hz order-4
# band-pass at fs 256 (4 sections, padlen 27), the 60 Hz notch (Q 5)
DSP_FS, DSP_BAND, DSP_NOTCH = 256, (1, 70), (60, 5)
# one launch per filter call over the whole stack: the fp32 band-pass, the
# notch, the five sub-bands of the differential entropy, the windowed
# trial's band-pass and notch; the fp64 band-pass
DSP_LAUNCHES = {"sos_filtfilt": 9, "sos_filtfilt_f64": 1}
# against the same calls on CPU copies (the plain versions): the filters at
# 1e-4 (fp32) and 1e-10 (fp64) of the output's max |y|; the features at
# tests/test_ops_dsp.py's bars (PSD 1e-4 and DE 2e-3 absolute, bin power
# 1e-4 relative) and the time-domain ones at 1e-4 relative; the graph at
# 1e-6; 8 series of the fp64 band-pass against scipy.signal.filtfilt (the
# (b, a) form) at 1e-5
DSP_REL, DSP_F64_REL, DSP_GRAPH_ATOL, DSP_SCIPY_ATOL = 1e-4, 1e-10, 1e-6, 1e-5
DSP_PSD_ATOL, DSP_DE_ATOL, DSP_FEATURE_RTOL = 1e-4, 2e-3, 1e-4
# the filter's plain version is ~46,000 launches a call: timed over 3
PLAIN_CALLS = {"sos_filtfilt": 3, "sos_filtfilt_f64": 3}
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
PEAK_FP64_FLOPS = 34e12  # CUDA-core fp64, the filter's fp64 form (H100 SXM data sheet)

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
    "bilstm_gemm": (CSRC + "lstm_gemm.cu", JAX_KERNELS + "lstm.py:527,1227,401", 1e-3),
    "bilstm_rec": (CSRC + "lstm_fwd.cu", JAX_KERNELS + "lstm.py:527", 1e-4),
    "bilstm_sweep": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:1227,819,691,401", 1e-4),
    "stem_tail": (CSRC + "stem_tail.cu", JAX_KERNELS + "conv_stem_train.py:265", 1e-5),
    "stem_tail_bwd": (CSRC + "stem_tail.cu", JAX_KERNELS + "conv_stem_train.py:368", 1e-3),
    "infonce": (CSRC + "infonce.cu", JAX_KERNELS + "contrastive.py:61", 1e-4),
}
# the other schedules' kernels, rows 4-8 and 10, and their bf16 forms (fp32
# arithmetic on bf16 operands, as the fp32 forms'); the v8 sweep's dW_cat
# sums B*T rows as bilstm_segbwd's does (rows 8, 7 and 5 are row 11's pieces
# at K=1 over the full c: the sweep reads c from c_seq and the GEMM's
# activations, from x or, row 5, from xp; row 6's c is the c scan at K=1 over
# the same GEMM's activations)
SCHEDULE_ROWS = {
    "bilstm_fwd_xp": (CSRC + "lstm_fwd.cu", JAX_KERNELS + "lstm.py:310", 1e-4),
    "bilstm_bwd_xp": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:401", 1e-4),
    "bilstm_cseq": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:623", 1e-4),
    "bilstm_bwd_split": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:691", 1e-4),
    "bilstm_bwdc": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:819", 1e-3),
    "bilstm_cbndk": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:1115", 1e-4),
}
KERNELS = {
    **TRAINING_KERNELS,
    **{f"{name}_bf16": entry for name, entry in TRAINING_KERNELS.items()},
    "conv_stem": (CSRC + "conv_stem.cu", JAX_KERNELS + "conv_stem.py:64", 1e-4),
    "flash_fwd": (CSRC + "flash_attn.cu", JAX_KERNELS + "attention.py:67", 1e-4),
    "flash_bwd_dq": (CSRC + "flash_attn.cu", JAX_KERNELS + "attention.py:159", 1e-3),
    "flash_bwd_dkv": (CSRC + "flash_attn.cu", JAX_KERNELS + "attention.py:184", 1e-3),
    # their bf16 forms against their bf16 plain versions: a bf16 output within
    # 1e-2 plus BF16_RTOL of itself (the kernel's P rounds at its key tile's
    # running max, the plain version's at the row's max; bf16 outputs sum
    # 585 rounded terms), LSE within 1e-2
    "flash_fwd_bf16": (CSRC + "flash_attn_bf16.cu", JAX_KERNELS + "attention.py:67", 1e-2),
    "flash_bwd_dq_bf16": (CSRC + "flash_bwd_bf16.cu", JAX_KERNELS + "attention.py:159", 1e-2),
    "flash_bwd_dkv_bf16": (CSRC + "flash_bwd_bf16.cu", JAX_KERNELS + "attention.py:184", 1e-2),
    "fusion_head": (CSRC + "fusion_head.cu", JAX_KERNELS + "fusion_head.py:40", HEAD_ATOL),
    # its bf16 form: fp32 arithmetic on bf16 operands, bf16 logits
    "fusion_head_bf16": (CSRC + "fusion_head.cu", JAX_KERNELS + "fusion_head.py:40", HEAD_ATOL),
    # row 9's c scan (row 6's at K=1), one form: the plain version's
    # rounding, step by step
    "bilstm_cscan": (CSRC + "lstm_bwd.cu", JAX_KERNELS + "lstm.py:1026,623", 1e-6),
    **SCHEDULE_ROWS,
    **{f"{name}_bf16": entry for name, entry in SCHEDULE_ROWS.items()},
    # port-only: the JAX package's lax.scan filter (no Pallas kernel); the
    # tolerance is relative to the output's max |y| (RELATIVE_TOL)
    "sos_filtfilt": (CSRC + "iir.cu", "multimodal_sentiment_aanalysis_tpu/ops/dsp.py:85",
                     DSP_REL),
    "sos_filtfilt_f64": (CSRC + "iir.cu", "multimodal_sentiment_aanalysis_tpu/ops/dsp.py:85",
                         DSP_F64_REL),
}
RELATIVE_TOL = ("sos_filtfilt", "sos_filtfilt_f64")


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
# DSP, EEG features and the electrode graph
# --------------------------------------------------------------------------


def dsp_calls(x: torch.Tensor, x64: torch.Tensor) -> dict:
    """The ``dsp`` phase's calls on the raw EEG stack ``x (480, 32, 585)``
    and its float64 copy, on their device: the channel-major band-pass of
    the stack, the sample-major notch of each ``(585, 32)`` trial through
    ``batched`` (axis 0), both feature vectors of every trial, trial 0's
    filtered z-scored windows, the 64-graph batch, the fp64 band-pass."""
    trials = x.transpose(1, 2)  # (480, 585, 32)
    adj, indicator = initialize_graph(64, 32, device=x.device)
    return {"band-pass": butterworth_filter(x, DSP_FS, *DSP_BAND),
            "notch": batched(filter_data_notch, *DSP_NOTCH, fs=DSP_FS)(trials),
            "time features": batched(all_timedomain_features)(trials),
            "frequency features": batched(all_frequency_features)(trials),
            "windows": re_data_slide(trials[0], 1, 128, 0.5, is_filter=True,
                                     norm_method="z_score")[0],
            "adjacency": adj, "indicator": indicator,
            "band-pass fp64": butterworth_filter(x64, DSP_FS, *DSP_BAND)}


def dsp_check(label: str, got: torch.Tensor, want: torch.Tensor, atol: float,
              rtol: float = 0.0) -> float:
    """``got`` (the card's) against ``want`` (the CPU plain path's),
    elementwise within ``atol + rtol |want|``; returns the max |err|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"dsp {label}: {tuple(got.shape)} {got.dtype} against {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"dsp {label}: non-finite values")
    diff = (got.cpu().double() - want.double()).abs()
    err = diff.max().item()
    check(bool((diff <= atol + rtol * want.double().abs()).all()),
          f"dsp {label}: max |err| {err:.3e} over atol {atol:.3e} + rtol {rtol}")
    print(f"dsp {label}: {tuple(got.shape)}, max |err| {err:.3e} against the CPU plain path "
          f"(atol {atol:.3e}, rtol {rtol})")
    return err


def dsp_phase(device: torch.device, smi: str) -> tuple[dict, torch.Tensor]:
    """The port's DSP, features and graph on the full synthetic raw EEG stack
    (ROADMAP A12): the calls of :func:`dsp_calls` with the counters reset
    just before and held to one launch per filter call after, each result
    against the same call on CPU copies (the plain versions), and 8 series
    of the fp64 band-pass against scipy. Returns the launch counts and the
    stack on the card."""
    import scipy
    from scipy import signal

    t0 = time.perf_counter()
    print(f"dsp: scipy {scipy.__version__}")
    raw = make_synthetic_hci_data(seed=SEED)["raw_data"]["eeg"]  # (480, 32, 585) fp32
    x = torch.from_numpy(raw).to(device)
    x64 = x.double()
    out, seconds, counts = counted(lambda: dsp_calls(x, x64), launches(DSP_LAUNCHES, 1), "dsp")
    print(f"dsp launches: { {k: n for k, n in counts.items() if n} }; the calls took "
          f"{seconds:.3f} s ({smi})")
    ref = dsp_calls(x.cpu(), x64.cpu())
    shapes = {"band-pass": (480, 32, 585), "notch": (480, 585, 32), "time features": (480, 128),
              "frequency features": (480, 5, 96), "adjacency": (64, 32, 32),
              "indicator": (64 * 32,), "band-pass fp64": (480, 32, 585)}
    for label, shape in shapes.items():
        check(tuple(out[label].shape) == shape, f"dsp {label}: shape {tuple(out[label].shape)}")
    for label in ("band-pass", "notch", "windows"):
        dsp_check(label, out[label], ref[label], DSP_REL * ref[label].abs().max().item())
    ref64 = ref["band-pass fp64"]
    dsp_check("band-pass fp64", out["band-pass fp64"], ref64,
              DSP_F64_REL * ref64.abs().max().item())
    dsp_check("time features", out["time features"], ref["time features"], 0.0,
              DSP_FEATURE_RTOL)
    got, want = out["frequency features"], ref["frequency features"]
    dsp_check("PSD", got[..., :32], want[..., :32], DSP_PSD_ATOL)
    dsp_check("DE", got[..., 32:64], want[..., 32:64], DSP_DE_ATOL)
    dsp_check("bin power", got[..., 64:], want[..., 64:], 0.0, DSP_FEATURE_RTOL)
    dsp_check("adjacency", out["adjacency"], ref["adjacency"], DSP_GRAPH_ATOL)
    check(out["adjacency"].stride(0) == 0, "dsp adjacency: the batch is a copy, not a broadcast")
    check(torch.equal(out["indicator"].cpu(), ref["indicator"]), "dsp indicator differs")
    b, a = signal.butter(4, [2 * DSP_BAND[0] / DSP_FS, 2 * DSP_BAND[1] / DSP_FS], "bandpass")
    want = signal.filtfilt(b, a, raw[0, :8].astype(np.float64))
    err = np.abs(out["band-pass fp64"][0, :8].cpu().numpy() - want).max()
    check(err <= DSP_SCIPY_ATOL, f"dsp fp64 band-pass against scipy: {err:.3e}")
    print(f"dsp fp64 band-pass, 8 series against scipy.signal.filtfilt: max |err| {err:.3e} "
          f"(atol {DSP_SCIPY_ATOL})")
    print(f"dsp phase: {time.perf_counter() - t0:.1f} s")
    return counts, x


def dsp_kernel_cases(x: torch.Tensor, cases: dict) -> None:
    """The filter kernel's two forms at the ``dsp`` phase's band-pass: the
    480 x 32 series of the raw EEG stack, fp32 and float64."""
    from scipy import signal

    b, a = signal.butter(4, [2 * DSP_BAND[0] / DSP_FS, 2 * DSP_BAND[1] / DSP_FS], "bandpass")
    sos, padlen = signal.tf2sos(b, a), 3 * max(len(a), len(b))  # as ops.dsp.filtfilt designs it
    for name, dtype in (("sos_filtfilt", torch.float32), ("sos_filtfilt_f64", torch.float64)):
        flat = x.reshape(-1, x.shape[-1]).to(dtype)
        s_t = torch.as_tensor(sos, dtype=dtype, device=x.device)
        z_t = torch.as_tensor(signal.sosfilt_zi(sos), dtype=dtype, device=x.device)
        args = (flat, s_t, z_t, padlen)
        cases[name].append(("raw EEG 480x32x585, 1-70 Hz", partial(iir.sos_filtfilt, *args),
                            partial(iir.sos_filtfilt_plain, *args), args))


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
    return model, first, counts, (pool, plan, outs)


def serving_bf16_phase(model, pool: DeviceDataset, plan: torch.Tensor, fp32_logits: list,
                       schedule: str = "v9") -> tuple[dict, list]:
    """The requests through ``build_serving_forward(compute_dtype=bf16,
    lstm_schedule=schedule)``: two launches a request of the schedule's
    forward in its bf16 form (v9: row 1, v5: row 4) and no other kernel,
    fp32 logits, agreement with (v9) fp32 serving. Returns the path's launch
    counts and logits."""
    path = "serving_bf16" + ("" if schedule == "v9" else f"_{schedule}")
    fwd = build_serving_forward(model, compute_dtype=BF16, lstm_schedule=schedule)
    first = pool.gather(plan[0])
    fwd(first["eeg"], first["eye"], first["pps"])  # warm-up: bf16 cuBLAS/cuDNN handles
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, ms = serve({path: fwd}, pool, plan)
    counts = launch_counts()
    expected = {name: 0 for name in KERNELS}
    expected.update(with_row_kernels({f"{SCHEDULE_KERNELS[schedule][0]}_bf16": 2 * REQUESTS}))
    print(f"bf16 serving ({schedule}) launches over {REQUESTS} requests: {counts}")
    check(counts == expected, f"bf16 serving ({schedule}) launch counts {counts} != {expected}")
    worst, excess, agree = 0.0, 0.0, 1.0
    for head in (0, 1):  # arousal, valence
        lo = torch.cat([res[head] for res in outs[path]])
        hi = torch.cat([res[head] for res in fp32_logits])
        check(lo.dtype == torch.float32 and lo.shape == hi.shape
              and bool(torch.isfinite(lo).all()), "bf16 serving: logits not finite fp32")
        diff = (lo - hi).abs()
        worst = max(worst, diff.max().item())
        excess = max(excess, (diff - SERVE_BF16_TOL * (1 + hi.abs())).max().item())
        agree = min(agree, (lo.argmax(-1) == hi.argmax(-1)).double().mean().item())
    print(f"serve {path}: {REQUESTS} requests x {BATCH}, {ms[path]:.4f} ms/batch "
          f"(host clock around synchronised runs); against fp32 serving: max |diff| "
          f"{worst:.3e}, within rtol/atol {SERVE_BF16_TOL}: {excess <= 0}, argmax agreement "
          f"{agree:.4f} (the lower head; limit {SERVE_BF16_ARGMAX})")
    check(excess <= 0 and agree >= SERVE_BF16_ARGMAX,
          f"bf16 serving ({schedule}) disagrees with fp32 serving")
    return counts, outs[path]


def serving_v5_phase(model, pool: DeviceDataset, plan: torch.Tensor,
                     fp32_logits: list) -> tuple[dict, list]:
    """The requests through ``build_serving_forward(lstm_schedule="v5")``:
    two launches of the v5 forward per request and no other kernel, logits
    within SCHEDULE_SERVE_ATOL of (v9) fp32 serving's. Returns the launch
    counts and the logits."""
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
    return counts, outs["serving_v5"]


def logit_gap(got: list, want: list) -> tuple[float, float, bool]:
    """Max |diff| of two runs' logits over every request and head, the
    largest |logit| of ``want``, and whether they are bit-equal."""
    pairs = [(a, b) for res, ref in zip(got, want) for a, b in zip(res, ref)]
    gap = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    scale = max(b.float().abs().max().item() for _, b in pairs)
    return gap, scale, all(torch.equal(a, b) for a, b in pairs)


EXPORTS = {  # artifact -> export_serving keywords, launches per request
    "fixed64_use_pallas": (dict(batch_size=BATCH, use_pallas=True),
                           dict(bilstm_fwd=2, conv_stem=2)),
    "poly_fp32": (dict(), dict(bilstm_fwd=2)),
    "poly_bf16": (dict(compute_dtype=BF16), dict(bilstm_fwd_bf16=2)),
    "fixed64_v5": (dict(batch_size=BATCH, lstm_schedule="v5"), dict(bilstm_fwd_xp=2)),
}
# the fresh process: torch and the op library only, the artifact run on the
# saved request, its gap to the closure, the modules it never imported
FRESH_LOAD = """
import json, sys
import torch
import multimodal_sentiment_aanalysis_tpu_torch.kernels.library
from multimodal_sentiment_aanalysis_tpu_torch.kernels import launch_counts
art, req = sys.argv[1:3]
r = torch.load(req)
t0 = __import__("time").perf_counter()
module = torch.export.load(art).module()
with torch.no_grad():
    a, v = module(r["eeg"], r["eye"], r["pps"])
torch.cuda.synchronize()
p = "multimodal_sentiment_aanalysis_tpu_torch."
print(json.dumps({
    "seconds": __import__("time").perf_counter() - t0,
    "gap": max((a - r["a"]).abs().max().item(), (v - r["v"]).abs().max().item()),
    "launches": {k: n for k, n in launch_counts().items() if n},
    "imported": sorted(n for n in sys.modules if n.startswith(
        (p + "models", p + "train", p + "eval.serving", "jax",
         "multimodal_sentiment_aanalysis_tpu.")))}))
"""


def export_phase(model, pool: DeviceDataset, plan: torch.Tensor, closures: dict,
                 smi: str) -> dict:
    """``torch.export`` artifacts of the serving model (``eval/export.py``):
    each of EXPORTS exported, saved to a file and loaded back, then the
    requests served through it with the counters reset just before
    (launches per request exactly its path's, logits within EXPORT_REL of
    the closure's on the same requests); the polymorphic fp32 artifact also
    at EXPORT_BATCHES; one artifact loaded and run in a fresh process that
    imports torch and the op library alone. Prints export seconds, artifact
    MB and the loaded ms/batch beside the closure's. Returns the launch
    counts of the loaded artifacts' runs."""
    t0 = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    first = pool.gather(plan[0])
    with tempfile.TemporaryDirectory() as tmp:
        for name, (kw, per_request) in EXPORTS.items():
            path = os.path.join(tmp, f"{name}.pt2")
            reset_launch_counts()
            blob, export_s = synced(lambda kw=kw, path=path: export_serving(model, path, **kw))
            traced = {k: n for k, n in launch_counts().items() if n}
            check(not traced, f"export {name}: tracing launched kernels {traced}")
            fwd, load_s = synced(lambda path=path: load_serving(path))
            fwd(first["eeg"], first["eye"], first["pps"])  # warm-up: first launches, handles
            torch.cuda.synchronize()
            reset_launch_counts()
            outs, ms = serve({name: fwd}, pool, plan)
            counts = launch_counts()
            expected = {k: 0 for k in KERNELS}
            expected.update(with_row_kernels({k: n * REQUESTS for k, n in per_request.items()}))
            check(counts == expected, f"export {name}: launch counts {counts} != {expected}")
            add_counts(total, counts)
            closure = build_serving_forward(model, **{k: v for k, v in kw.items()
                                                      if k != "batch_size"})
            _, closure_ms = serve({"closure": closure}, pool, plan)
            gap, scale, equal = logit_gap(outs[name], closures[name])
            check(all(a.dtype == torch.float32 and a.shape == (BATCH, 3)
                      and bool(torch.isfinite(a).all()) for res in outs[name] for a in res),
                  f"export {name}: logits not finite fp32 (B, 3)")
            print(f"export {name}: {export_s:.3f} s to export, {load_s:.3f} s to load, "
                  f"{len(blob) / 1e6:.3f} MB; {REQUESTS} requests x {BATCH}: loaded "
                  f"{ms[name]:.4f} ms/batch, closure {closure_ms['closure']:.4f} ms/batch (host "
                  f"clock around synchronised runs, {smi}); logits against the closure's: max "
                  f"|diff| {gap:.3e} of scale {scale:.3e}, bit-equal {equal}; launches per "
                  f"request {per_request}")
            check(gap <= EXPORT_REL * scale, f"export {name}: logits disagree with the closure")
            if name != "poly_fp32":
                continue
            gen = torch.Generator(device=pool.device).manual_seed(SEED + 7)
            for b in EXPORT_BATCHES:
                rows = pool.gather(torch.randint(0, POOL, (b,), generator=gen,
                                                 device=pool.device))
                args = (rows["eeg"], rows["eye"], rows["pps"])
                reset_launch_counts()
                got = fwd(*args)
                counts = launch_counts()
                check(counts == {k: 0 for k in KERNELS} | with_row_kernels({"bilstm_fwd": 2}),
                      f"export {name} at batch {b}: launch counts {counts}")
                add_counts(total, counts)
                gap, scale, _ = logit_gap([got], [closure(*args)])
                print(f"export {name} at batch {b}: max |diff| to the closure {gap:.3e} "
                      f"of scale {scale:.3e}")
                check(got[0].shape == (b, 3) and gap <= EXPORT_REL * scale,
                      f"export {name} at batch {b}: logits disagree with the closure")
            req = os.path.join(tmp, "request.pt")
            a, v = closure(first["eeg"], first["eye"], first["pps"])
            torch.save({**first, "a": a, "v": v}, req)
            proc = subprocess.run([sys.executable, "-c", FRESH_LOAD, path, req],
                                  capture_output=True, text=True, timeout=600,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
            check(proc.returncode == 0, f"export {name}: the fresh process failed "
                  f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
            fresh = json.loads(proc.stdout.strip().splitlines()[-1])
            want = with_row_kernels({"bilstm_fwd": 2})
            print(f"export {name} in a fresh process (torch and the op library alone): "
                  f"{fresh}")
            check(not fresh["imported"] and fresh["launches"] == want
                  and fresh["gap"] <= EXPORT_REL * scale,
                  f"export {name}: the fresh process imported {fresh['imported']}, launched "
                  f"{fresh['launches']} (want {want}), gap {fresh['gap']}")
    dispatch_cost(model, smi)
    print(f"export phase: {time.perf_counter() - t0:.1f} s wall ({smi})")
    return total


DISPATCH_CALLS, DISPATCH_WINDOWS = 50, 3


def dispatch_cost(model, smi: str) -> None:
    """The custom ops' dispatch cost: host microseconds per call of each
    serving op through its wrapper (``torch.ops.msa_torch.*``) against its
    CUDA implementation called directly, on the same operands, at the
    serving shape (layer 0 of the BiLSTM at B=64, S=1, and the LOSO step's
    S=24; the first conv stage), in alternating windows of DISPATCH_CALLS
    calls with no sync inside (the host's issue rate); the median of
    DISPATCH_WINDOWS windows each. The launches these calls make are
    outside every checked count."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    w = [t.detach() for t in lstm.stack_params(*model.eeg_net.bilstm.layer_params(0))]
    x = torch.randn(BATCH, 146, w[0].shape[-1], device=dev, generator=gen)
    w24 = [t.expand(24, *t.shape).contiguous() for t in w]
    tc = model.eeg_net.temp_conv
    scale, shift = conv_stem.fold_bn(tc[1].weight, tc[1].bias, tc[1].running_mean,
                                     tc[1].running_var, tc[0].bias)
    eeg = torch.randn(BATCH, 585, 32, device=dev, generator=gen)
    cases = {
        "bilstm_fwd S=1": (lstm.bilstm_fwd, lstm.bilstm_fwd_cuda, (x, *w)),
        "bilstm_fwd S=24": (lstm.bilstm_fwd, lstm.bilstm_fwd_cuda,
                            (x.expand(24, *x.shape).contiguous(), *w24)),
        "conv_stem": (conv_stem.fused_conv_bn_gelu_pool, conv_stem.conv_stem_cuda,
                      (eeg, tc[0].weight.detach(), scale.detach(), shift.detach(), 7, 4)),
    }
    with torch.no_grad():
        for name, (op, direct, args) in cases.items():
            times = {"op": [], "direct": []}
            for _ in range(DISPATCH_WINDOWS):
                for label, fn in (("op", op), ("direct", direct)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(DISPATCH_CALLS):
                        fn(*args)
                    times[label].append((time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
                    torch.cuda.synchronize()
            med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
            print(f"dispatch {name}: host us/call through the op {med['op']:.1f}, the CUDA "
                  f"implementation directly {med['direct']:.1f}: the op's cost "
                  f"{med['op'] - med['direct']:.1f} us/call (median of {DISPATCH_WINDOWS} "
                  f"windows of {DISPATCH_CALLS} calls, {smi})")


def quantized_agreement(got: list, fp32: list) -> tuple[float, float]:
    """The int8 logits against fp32 serving's at the JAX package's bar: the
    largest gap over the largest |fp32 logit| and the lowest argmax
    agreement, over both heads."""
    rel, agree = 0.0, 1.0
    for head in (0, 1):
        lo = torch.cat([res[head] for res in got])
        hi = torch.cat([res[head] for res in fp32])
        rel = max(rel, (lo - hi).abs().max().item() / hi.abs().max().item())
        agree = min(agree, (lo.argmax(-1) == hi.argmax(-1)).double().mean().item())
    return rel, agree


def quantized_phase(model, pool: DeviceDataset, plan: torch.Tensor, fp32_logits: list,
                    smi: str) -> dict:
    """``build_quantized_serving_forward`` (``eval/quantization.py``) with
    fp32 and with bf16 glue over the serving requests and one request each
    of QUANT_ROWS rows, the counters reset just before each: two launches
    of row 1's recurrence (``bilstm_rec``, ``bilstm_rec_bf16`` for bf16
    glue) a request and no other kernel; logits against fp32 serving at the
    JAX package's bar (max gap at most 0.1 of the largest |logit|, argmax
    agreement at least 0.9); the 16-row request against the CPU plain int8
    path at the CPU tests' bar. Prints ms/batch. Returns the launch
    counts."""
    t0 = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    first = pool.gather(plan[0])
    cpu_model = copy.deepcopy(model).cpu()
    closure = build_serving_forward(model)
    for glue in (torch.float32, BF16):
        label = f"int8 {str(glue).removeprefix('torch.')} glue"
        rec = "bilstm_rec" if glue == torch.float32 else "bilstm_rec_bf16"
        fwd = build_quantized_serving_forward(model, 256, glue)
        fwd(first["eeg"], first["eye"], first["pps"])  # warm-up: first launches, handles
        torch.cuda.synchronize()
        reset_launch_counts()
        outs, ms = serve({label: fwd}, pool, plan)
        counts = launch_counts()
        expected = {k: 2 * REQUESTS if k == rec else 0 for k in KERNELS}
        check(counts == expected, f"{label}: launch counts {counts} != {expected}")
        add_counts(total, counts)
        rel, agree = quantized_agreement(outs[label], fp32_logits)
        print(f"serve {label}: {REQUESTS} requests x {BATCH}, {ms[label]:.4f} ms/batch (host "
              f"clock around synchronised runs, {smi}); against fp32 serving: max gap "
              f"{rel:.4f} of the largest |logit| (limit {SERVE_BF16_TOL}), argmax agreement "
              f"{agree:.4f} (limit {SERVE_BF16_ARGMAX})")
        check(rel <= SERVE_BF16_TOL and agree >= SERVE_BF16_ARGMAX,
              f"{label}: disagrees with fp32 serving")
        for b in QUANT_ROWS:
            rows = {k: v[:b] for k, v in first.items()}
            args = (rows["eeg"], rows["eye"], rows["pps"])
            reset_launch_counts()
            got = fwd(*args)
            counts = launch_counts()
            check(counts == {k: 2 if k == rec else 0 for k in KERNELS},
                  f"{label} at {b} rows: launch counts {counts}")
            add_counts(total, counts)
            check(all(a.shape == (b, 3) and a.dtype == torch.float32
                      and bool(torch.isfinite(a).all()) for a in got),
                  f"{label} at {b} rows: logits not finite fp32 ({b}, 3)")
            rel, agree = quantized_agreement([got], [closure(*args)])
            check(rel <= SERVE_BF16_TOL and agree >= SERVE_BF16_ARGMAX,
                  f"{label} at {b} rows: disagrees with fp32 serving ({rel}, {agree})")
            if b != QUANT_ROWS[0]:
                continue
            with torch.no_grad():
                cpu = build_quantized_serving_forward(cpu_model, 256, glue)(
                    *(a.cpu() for a in args))
            gaps = torch.stack([(g.cpu() - c).abs().amax(-1) for g, c in zip(got, cpu)]).amax(0)
            scale = max(c.abs().max().item() for c in cpu)
            flipped = (gaps > QUANT_ROW_ATOL).double().mean().item()
            print(f"{label} at {b} rows against the CPU plain int8 path: max |diff| "
                  f"{gaps.max().item():.3e} (scale {scale:.3e}), rows beyond "
                  f"{QUANT_ROW_ATOL}: {flipped:.4f}")
            if glue == torch.float32:
                check(flipped <= QUANT_FLIPPED_ROWS
                      and gaps.max().item() <= QUANT_FLIPPED_REL * scale,
                      f"{label}: disagrees with the CPU plain int8 path")
            else:
                check(gaps.max().item() <= QUANT_BF16_ATOL,
                      f"{label}: disagrees with the CPU plain int8 path")
    print(f"quantized phase: {time.perf_counter() - t0:.1f} s wall ({smi})")
    return total


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
            lambda a=args: conv_stem.fused_conv_bn_gelu_pool_plain(*a), args,
            lambda a=args: conv_stem.fused_conv_bn_gelu_pool_plain(
                *(v.double() for v in a[:4]), *a[4:])))
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
        seeds = stem_seeds(1, y.device)
        cases["stem_tail"].append((
            f"train pool {pool} {shape} batch stats, p {DROPOUT_P}, writes the code",
            lambda a=args, sd=seeds, p=pool: conv_stem_train.stem_tail_fwd_seeded(
                *a, DROPOUT_P, p, sd),
            lambda a=args, k=keep_mask(seeds, shape), p=pool: conv_stem_train.fused_stage_train_plain(
                *a, p, 1e-5, DROPOUT_P, k, with_code=True),
            (*args, seeds, keep_mask(seeds, shape))))
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
    # the step's three problems share its labels, mask and temperature: one row
    args = (n, n, batch["arousal"][None], mask[None], model.temperature.reshape(1))
    cases["infonce"].append((
        f"G 3 {tuple(n.shape[1:])} one shared row", lambda a=args: contrastive.infonce(*a),
        lambda a=args: infonce_rows_plain(*a), args))


def lstm_piece_cases(x, w, h_seq, dh, c_bnd, label: str, sfx: str = "") -> dict:
    """The pieces of rows 1, 9 and 11 at one layer's shapes: the GEMM at its
    five products (the fifth, row 5's gates from xp, over this layer's
    projection), the recurrence, the c scan (fp32 cases only: it has one
    form) and the sweep, each (label, kernel call, plain call, the tensors
    the call reads). The sweep's kernel call overwrites a copy of the
    activations (the copy is timed with it)."""
    w_ih, w_hh, bias = w
    xp = lstm.bilstm_gemm_plain("proj", x, *w)  # fp32, row 1's recurrence reads it
    xp_v5 = xp.to(w_hh.dtype)  # the gates_xp product reads the v5 projection, bf16 in bf16
    act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
    dg = lstm.bilstm_sweep_plain(act, dh, c_bnd, w_hh)
    reads = {"proj": (x, w_ih, bias), "gates": (x, h_seq, w_ih, w_hh, bias), "dx": (dg, w_ih),
             "dw": (x, h_seq, dg), "gates_xp": (xp_v5, h_seq, w_hh)}

    def exact(mode: str):
        """The mode's products in fp64, on the operands as given and on
        their TF32 roundings (bias and xp aside: both are added, not
        multiplied)"""
        ref = lstm.bilstm_gemm_plain(mode, *(a.double() for a in (x, *w)), h_seq=h_seq.double(),
                                     dg=dg.double(), xp=xp_v5.double())
        one_pass = lstm.bilstm_gemm_plain(
            mode, *(tf32_round(a).double() for a in (x, w_ih, w_hh)), bias.double(),
            h_seq=tf32_round(h_seq).double(), dg=tf32_round(dg).double(), xp=xp_v5.double())
        return ref, one_pass

    pieces = {
        "bilstm_gemm" + sfx: [
            (f"{mode} {label}",
             lambda m=mode: lstm.bilstm_gemm(m, x, *w, h_seq=h_seq, dg=dg, xp=xp_v5),
             lambda m=mode: lstm.bilstm_gemm_plain(m, x, *w, h_seq=h_seq, dg=dg, xp=xp_v5),
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


def schedule_epochs(full: DeviceDataset, label: str, **dtypes) -> tuple[dict, dict]:
    """The LOSO trainer (S=24, B=64, early stop) under each BiLSTM schedule
    (v9 first) from the v9 phase's init, ``dtypes`` its
    ``compute_dtype``/``moment_dtype``: LOSO_SCHEDULE_EPOCHS fused epochs
    of one epoch a call under the sync check, each held to the schedule's
    launches (its kernels once per layer and step for all 24 models, in the
    bf16 forms for a bf16 trainer, whose held-out evaluation runs the fp32
    forms; no other schedule's), with its ms/step and peak device memory.
    Returns the launch counts and each schedule's per-subject train loss
    of each epoch."""
    total = {name: 0 for name in KERNELS}
    losses = {}
    for schedule in ("v9", *OTHER_SCHEDULES):
        gc.collect()  # the last schedule's trainer (its closures hold it in cycles)
        torch.cuda.empty_cache()
        vt = make_loso_trainer(full, lstm_schedule=schedule, **dtypes)
        s_n, n_train = vt.n_subjects, vt.train_idx.shape[1]
        steps = -(-n_train // BATCH)
        per_step, per_eval = schedule_per_step(schedule)
        if vt.compute_dtype == BF16:
            per_step = bf16_forms(per_step)
        expected = {name: steps * per_step.get(name, 0) + per_eval.get(name, 0) for name in KERNELS}
        losses[schedule] = []
        for epoch in range(1, LOSO_SCHEDULE_EPOCHS + 1):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, seconds, counts = fused_epochs_checked(vt, 1, expected,
                                                        f"{label} {schedule} epoch {epoch}")
            peak = torch.cuda.max_memory_allocated()
            for name in KERNELS:
                total[name] += counts[name]
            out = out[0]
            losses[schedule].append(out[:, 0] / np.maximum(out[:, 3], 1.0))
            print(f"{label} {schedule} fused epoch {epoch}: train loss mean "
                  f"{losses[schedule][-1].mean():.6f}; smoke reading (host clock around a "
                  f"synchronised run, no host sync inside): {seconds * 1e3 / steps:.3f} ms/step of "
                  f"{s_n} x {BATCH} with the held-out evaluation, "
                  f"{s_n * n_train / seconds:.1f} samples/s/chip; torch.cuda.max_memory_allocated "
                  f"{peak / 2 ** 30:.3f} GiB, {(peak - base) / 2 ** 30:.3f} GiB above the "
                  f"{base / 2 ** 30:.3f} GiB held before the epoch")
        train_launches = {name: (n - per_eval.get(name, 0)) / steps for name, n in counts.items() if n}
        print(f"{label} {schedule} launches per step ({s_n} models, the evaluation's taken out): "
              f"{train_launches}")
        del vt, out
    gc.collect()
    torch.cuda.empty_cache()
    return total, losses


def loss_gap(got: list, want: list) -> float:
    """The largest relative per-subject gap of two runs' train losses."""
    return max((np.abs(a - b) / np.abs(b)).max() for a, b in zip(got, want))


def loso_schedules_phase(full: DeviceDataset) -> tuple[dict, dict]:
    """Each BiLSTM schedule's fp32 LOSO trainer (:func:`schedule_epochs`),
    each epoch's per-subject train loss against v9's. Returns the launch
    counts and the losses."""
    total, losses = schedule_epochs(full, "LOSO")
    for schedule in OTHER_SCHEDULES:
        gap = loss_gap(losses[schedule], losses["v9"])
        print(f"LOSO {schedule} against v9 from the same init and plans: largest relative "
              f"per-subject train-loss gap over {LOSO_SCHEDULE_EPOCHS} fused epochs {gap:.3e} "
              f"(limit {SCHEDULE_LOSS_GAP})")
        check(gap <= SCHEDULE_LOSS_GAP, f"LOSO {schedule} parts from v9")
    return total, losses


def loso_bf16_schedules_phase(full: DeviceDataset, fp32: dict) -> dict:
    """Each BiLSTM schedule's bf16 LOSO trainer (``compute_dtype`` and
    ``moment_dtype="bfloat16"``, :func:`schedule_epochs`): the last
    epoch's per-subject train loss against the bf16 v9 trainer's from the
    same init and plans (BF16_SCHEDULE_LOSS_GAP) and against the same
    schedule's fp32 trainer's (``fp32``: its losses; LOSS_GAP_LIMIT).
    Returns the launch counts."""
    total, losses = schedule_epochs(full, "LOSO bf16", compute_dtype="bfloat16",
                                    moment_dtype="bfloat16")
    for schedule in ("v9", *OTHER_SCHEDULES):
        last = [losses[schedule][-1]]
        fp32_gap = loss_gap(last, [fp32[schedule][-1]])
        v9_gap = loss_gap(last, [losses["v9"][-1]])
        print(f"LOSO bf16 {schedule} epoch {LOSO_SCHEDULE_EPOCHS} train loss from the same init "
              f"and plans: largest relative per-subject gap to bf16 v9 {v9_gap:.3e} (limit "
              f"{BF16_SCHEDULE_LOSS_GAP}), to fp32 {schedule} {fp32_gap:.3e} (limit "
              f"{LOSS_GAP_LIMIT})")
        check(v9_gap <= BF16_SCHEDULE_LOSS_GAP and fp32_gap <= LOSS_GAP_LIMIT,
              f"LOSO bf16 {schedule} parts from bf16 v9 or from fp32 {schedule}")
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
    (the trainer's stacked weights, seeded activations) to ``loso_cases``,
    and subject 0's share to ``cases``: for a bf16 trainer their bf16
    forms, on its weights cast to bf16 and bf16 activations (``xp`` the
    projection rounded to bf16, as the v5 schedule's bf16 matmul writes it;
    ``c_seq`` fp32). For an fp32 trainer also the pieces of the v8 and v6
    layer backwards after their one gate GEMM: the c scan at K=1 (row 6
    there) and the sweep at K=1 over the full c, the piece rows 8, 7 and 5
    launch (its kernel call overwrites a copy of the activations, timed with
    it). Call under ``no_grad``."""
    device = vt.device
    dtype = vt.compute_dtype or torch.float32
    sfx = "_bf16" if dtype == BF16 else ""
    pd = {n: p.to(dtype) for n, p in vt._param_dict(vt.params).items()}
    s_n = vt.n_subjects
    randn = lambda *shape: torch.randn(shape, device=device, generator=gen).to(dtype)
    x = randn(s_n, BATCH, vt.data.arrays["eeg"].shape[2] // 8, pd["eeg_net.temp_conv.6.weight"].shape[1])
    for k in range(2):
        part = lambda name, sfx: pd[f"eeg_net.bilstm.{name}_l{k}{sfx}"]
        w = (torch.stack([part("weight_ih", ""), part("weight_ih", "_reverse")], 1),
             torch.stack([part("weight_hh", ""), part("weight_hh", "_reverse")], 1),
             torch.stack([part("bias_ih", "") + part("bias_hh", ""),
                          part("bias_ih", "_reverse") + part("bias_hh", "_reverse")], 1))
        h_seq = lstm.bilstm_fwd_plain(x, *w)
        c_seq = lstm.bilstm_cseq_plain(x, h_seq, *w)
        xp = lstm._projection(x.float(), w[0].float(), w[2].float()).to(dtype)
        # row 5 reads the v5 forward's h and c over that xp, as on the v5 path
        hc_xp = lstm.bilstm_fwd_xp_plain(xp, w[1])
        dh = randn(*h_seq.shape)
        label = f"layer {k} {tuple(x.shape)}"
        for name, args in (("bilstm_fwd_xp", (xp, w[1])),
                           ("bilstm_bwd_xp", (dh, xp, *hc_xp, w[1])),
                           ("bilstm_cseq", (x, h_seq, *w)),
                           ("bilstm_bwd_split", (dh, x, h_seq, c_seq, *w)),
                           ("bilstm_bwdc", (dh, x, h_seq, c_seq, *w)),
                           ("bilstm_cbndk", (x, h_seq, *w))):
            fn, plain = getattr(lstm, name), getattr(lstm, name + "_plain")
            a0 = tuple(a[0] for a in args)
            loso_cases.setdefault(name + sfx, []).append((
                f"S={s_n} {label}", lambda a=args, f=fn: f(*a), lambda a=args, p=plain: p(*a),
                args))
            cases[name + sfx].append((f"subject 0 of S={s_n} {label}", lambda a=a0, f=fn: f(*a),
                                      lambda a=a0, p=plain: p(*a), a0))
        if not sfx:
            act = lstm.bilstm_gemm_plain("gates", x, *w, h_seq=h_seq)
            args = (act, dh, c_seq, w[1])
            for what, a, into in ((f"S={s_n}", args, loso_cases),
                                  (f"subject 0 of S={s_n}", tuple(t[0] for t in args), cases)):
                into["bilstm_cscan"].append((
                    f"{what} {label} K 1 (row 6 in the v8 and v6 backward)",
                    lambda a=a: lstm.bilstm_cscan(a[0], 1),
                    lambda a=a: lstm.bilstm_cscan_plain(a[0], 1), a[:1]))
                into["bilstm_sweep"].append((
                    f"{what} {label} K 1 (rows 8, 7 and 5)",
                    lambda a=a: lstm.bilstm_sweep(a[0].clone(), *a[1:], 1),
                    lambda a=a: lstm.bilstm_sweep_plain(*a, 1), a))
        x = h_seq


def loso_stem_stages(vt: VectorizedLOSOTrainer) -> list[tuple]:
    """The LOSO step's two stem stages: (conv shape (S, B, T, C), BatchNorm
    prefix, pool)."""
    tc = "eeg_net.temp_conv"
    pd = vt._param_dict(vt.params)
    t_eeg = vt.data.arrays["eeg"].shape[2]
    return [((vt.n_subjects, BATCH, t_eeg, pd[f"{tc}.1.weight"].shape[1]), f"{tc}.1", 4),
            ((vt.n_subjects, BATCH, t_eeg // 4, pd[f"{tc}.6.weight"].shape[1]), f"{tc}.6", 2)]


def stem_seeds(s_n: int, device: torch.device) -> torch.Tensor:
    """One int64 dropout seed per model, given to the stem tail."""
    return STEM_SEED_BASE + 7919 * torch.arange(s_n, device=device, dtype=torch.int64)


_KEEP_MASKS: dict = {}


def keep_mask(seeds: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``conv_stem_train.keep_mask_plain`` at DROPOUT_P (the CPU Philox
    model), on the seeds' device; computed once per seeds and shape."""
    key = (tuple(seeds.tolist()), tuple(shape))
    if key not in _KEEP_MASKS:
        _KEEP_MASKS[key] = conv_stem_train.keep_mask_plain(seeds.cpu(), shape, DROPOUT_P).to(
            seeds.device)
    return _KEEP_MASKS[key]


def mask_check(vt: VectorizedLOSOTrainer, gen: torch.Generator) -> None:
    """Row 2's keep bits against the CPU Philox model, bit for bit: at pool
    1 the code of every element is its keep bit. Each LOSO stage's conv
    shape at S=24 and its subject 0 alone (S=1), fp32 and bf16, p =
    DROPOUT_P, the seeds given."""
    for shape, _, _ in loso_stem_stages(vt):
        seeds = stem_seeds(shape[0], vt.device)
        keep = keep_mask(seeds, shape)
        conv = torch.randn(shape, device=vt.device, generator=gen)
        ones = torch.ones(shape[0], shape[-1], device=vt.device)
        zeros = torch.zeros_like(ones)
        for dtype in (torch.float32, BF16):
            x = conv.to(dtype)
            _, code = conv_stem_train.stem_tail_fwd_seeded(x, ones, zeros, zeros, ones,
                                                           DROPOUT_P, 1, seeds)
            _, one = conv_stem_train.stem_tail_fwd_seeded(x[0], ones[0], zeros[0], zeros[0],
                                                          ones[0], DROPOUT_P, 1, seeds[:1])
            same = torch.equal(code, keep.int()) and torch.equal(one, keep[0].int())
            print(f"stem-tail keep mask {tuple(shape)} {dtype} p {DROPOUT_P}: the kernel's keep "
                  f"bits at S={shape[0]} and at subject 0 alone equal the CPU Philox model's "
                  f"bit for bit: {same} (keep share {keep.double().mean().item():.6f})")
            check(same, "stem-tail keep mask differs from the CPU Philox model")


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

    def add(name, label, fn, plain, args, one=None, exact=None):
        more = (lambda: exact(args),) if exact else ()
        cases[name + sfx].append((f"S={s_n} {label}", lambda: fn(*args), lambda: plain(*args),
                                  args, *more))
        if one_model is not None:
            a0 = one or tuple(a[0] if isinstance(a, torch.Tensor) else a for a in args)
            more = (lambda: exact(a0),) if exact else ()
            one_model[name + sfx].append((f"subject 0 of S={s_n} {label}", lambda: fn(*a0),
                                          lambda: plain(*a0), a0, *more))

    width = pd["eeg_net.temp_conv.6.weight"].shape[1]  # feat_dim
    t_eeg = vt.data.arrays["eeg"].shape[2]
    for conv_shape, bn, pool in loso_stem_stages(vt):
        y = randn(*conv_shape)
        mean = y.mean((1, 2))
        var = (y * y).mean((1, 2)) - mean * mean
        args = (y, pd[f"{bn}.weight"].contiguous(), pd[f"{bn}.bias"].contiguous(), mean, var)
        add("stem_tail", f"pool {pool} {conv_shape} batch stats, writes the code",
            lambda *a, p=pool: conv_stem_train.stem_tail_fwd(*a, 0.0, p),
            lambda *a, p=pool: conv_stem_train.fused_stage_train_plain(*a, p, with_code=True),
            args)
        # p > 0 with the seeds given: the plain version fed the CPU Philox
        # model's mask (a bool tensor: no byte the kernel moves)
        seeds = stem_seeds(s_n, device)
        add("stem_tail", f"pool {pool} {conv_shape} batch stats, p {DROPOUT_P}, writes the code",
            lambda *a, p=pool: conv_stem_train.stem_tail_fwd_seeded(*a[:5], DROPOUT_P, p, a[5]),
            lambda *a, p=pool: conv_stem_train.fused_stage_train_plain(
                *a[:5], p, 1e-5, DROPOUT_P, a[6], with_code=True),
            (*args, seeds, keep_mask(seeds, conv_shape)))
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
    # the step's form, each model's row shared by its 3 problems, on two
    # independent sets of features (held to fp64 too: infonce_check), at B=64
    # and at the B=512 of vloso_bf16_b512 (460 real rows wrap-padded to 512)
    n_train = vt.train_idx.shape[1]
    for b in (BATCH, LOSO_B512):
        n1, n2 = F.normalize(randn(2, p_n, b, width), dim=3, eps=1e-12)
        cols = np.arange(b) % n_train
        labels = vt.data.arrays["arousal"][torch.as_tensor(vt.train_idx[:, cols], device=device)]
        valid = torch.ones(s_n, b, device=device)
        if b == BATCH:
            valid[1::2, tail:] = 0.0  # every other model on the epoch's last batch
        else:
            valid[:, n_train:] = 0.0  # the one step's wrap-padded rows
        args = (n1, n2, labels.contiguous(), valid, pd["temperature"].contiguous())
        add("infonce", f"P={p_n} {(b, width)} two views, each model's row shared by its 3",
            contrastive.infonce, infonce_rows_plain, args, one=(n1[:3], n2[:3], *(
                a[:1] for a in args[2:])), exact=infonce_fp64)
    return cases


# --------------------------------------------------------------------------
# the phased curriculum: the 24 subjects' 5-phase curricula at once, and one
# subject's
# --------------------------------------------------------------------------


def make_phased_trainer(full: DeviceDataset, dropout: float | None = None,
                        **kw) -> VectorizedPhasedTrainer:
    """``cli.py phased`` on the synthetic set: one model per held-out
    subject, all 24 trained through the curriculum together (subject s from
    seed SEED + s)."""
    model = MultimodalTransformerModel(feat_dim=256, dropout=dropout, device=full.device)
    return VectorizedPhasedTrainer(model, full, N_SUBJECTS, EX_NUMS, batch_size=BATCH, seed=SEED,
                                   verbose=False, **kw)


def phased_expected(phase: str, epochs: int, steps: int, evals: int,
                    step: dict | None = None) -> dict:
    """The launches of ``epochs`` epochs of ``phase``: ``steps`` train steps
    of ``step`` (PHASE_STEP's) and ``evals`` evaluation batches an epoch."""
    step = PHASE_STEP[phase] if step is None else step
    return {name: epochs * (steps * step.get(name, 0) + evals * PER_EVAL.get(name, 0))
            for name in KERNELS}


def on_device_checked(fn, expected: dict, label: str) -> tuple:
    """``fn()`` under ``set_sync_debug_mode("error")`` (any host sync raises),
    the launch counters reset just before and held to ``expected`` after.
    Returns its result, the host-clock and the CUDA-event seconds of the
    synchronised run, and the launch counts."""
    reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.record()
    torch.cuda.synchronize()
    seconds, device_s = time.perf_counter() - t0, start.elapsed_time(end) / 1e3
    counts = launch_counts()
    check(counts == expected, f"{label} launch counts {counts} != {expected}")
    return out, seconds, device_s, counts


def phased_on_device(vt: VectorizedPhasedTrainer, phase: str, epochs: int,
                     expected: dict, label: str) -> tuple[dict, float, float, dict]:
    """``vt.run_phase_on_device(phase, epochs)`` under
    ``set_sync_debug_mode("error")``, the counters reset just before, its
    launches held to ``expected``; then the read-back (``record_phase``).
    Returns the per-subject metrics of the last epoch, the host-clock and
    the CUDA-event seconds of the synchronised run, and the launch counts."""
    out, seconds, device_s, counts = on_device_checked(
        lambda: vt.run_phase_on_device(phase, epochs), expected, f"{label} {phase}")
    vt.record_phase(phase, out)
    train = {k: v[-1] for k, v in vt.metrics["train"].items()}
    check(all(np.isfinite(v).all() for v in train.values())
          and all(np.isfinite(v[-1]).all() for v in vt.metrics["test"].values()),
          f"{label} {phase}: non-finite per-subject metrics")
    return train, seconds, device_s, counts


def phased_curriculum(vt: VectorizedPhasedTrainer, label: str, per_step: dict,
                      update_check: bool) -> tuple[dict, dict]:
    """``vt.run(1, 1, 1, 1, 1)`` phase by phase (``run_phase`` is
    ``run_phase_on_device`` and ``record_phase``), each phase under the sync
    check with its launches held to ``per_step`` (phase -> one step's) and
    the evaluation's; with ``update_check`` every column outside the phase's
    update set must stay bit for bit as it was and every update-set tensor
    move. Returns the launch counts and each phase's per-subject train loss."""
    n_train = vt.train_idx.shape[1]
    steps, evals = -(-n_train // BATCH), -(-vt.ex_nums // BATCH)
    total, losses = {name: 0 for name in KERNELS}, {}
    for phase, epochs in zip(PHASE_ORDER, PHASED_EPOCHS):
        cols = vt.layout.columns(PHASES[phase].update_modules)
        before = vt.params.clone() if update_check else None
        train, seconds, _, counts = phased_on_device(
            vt, phase, epochs, phased_expected(phase, epochs, steps, evals, per_step[phase]),
            label)
        for name in KERNELS:
            total[name] += counts[name]
        losses[phase] = train["loss"]
        moved = ""
        if update_check:
            inside = torch.zeros(vt.params.shape[1], dtype=torch.bool, device=vt.device)
            for a, b in cols:
                inside[a:b] = True
            changed = vt.params != before
            frozen_ok = not bool(changed[:, ~inside].any())
            bounds = np.cumsum([0, *vt.layout.sizes]).tolist()
            still = [n for n, a, b in zip(vt.layout.names, bounds[:-1], bounds[1:])
                     if any(lo <= a < hi for lo, hi in cols) and not bool(changed[:, a:b].any())]
            every_subject = bool(changed[:, inside].any(1).all())
            moved = (f"; columns outside the update set bit-unchanged: {frozen_ok}; update-set "
                     f"tensors that did not move: {still or 'none'}; every subject's update "
                     f"set moved: {every_subject}")
            check(frozen_ok and not still and every_subject,
                  f"{label} {phase}: update mask broken{moved}")
            del before, changed
        print(f"{label} {phase} ({epochs} epoch of {steps} steps of {vt.n_subjects} x {BATCH}, "
              f"{evals} evaluation batch): train loss mean {train['loss'].mean():.6f} (subjects "
              f"{train['loss'].min():.6f} to {train['loss'].max():.6f}); launches {counts}; "
              f"{seconds:.3f} s wall (host clock around the synchronised run, no host sync "
              f"inside){moved}")
    if update_check:
        print(f"{label} valence phase moved the valence head alone "
              f"(update columns {vt.layout.columns(PHASES['valence'].update_modules)})")
    return total, losses


def bn_fed_biases(model: nn.Module) -> set[str]:
    """The biases of the Linear and Conv1d layers that feed a BatchNorm in a
    Sequential: in train mode the BatchNorm takes out their batch mean, so
    their exact gradient is 0 and what either path computes is float noise."""
    out = set()
    for prefix, seq in model.named_modules():
        if isinstance(seq, nn.Sequential):
            for i, (a, b) in enumerate(zip(seq, list(seq)[1:])):
                if isinstance(a, (nn.Linear, nn.Conv1d)) and isinstance(b, nn.BatchNorm1d):
                    out.add(f"{prefix}.{i}.bias")
    return out


def phased_step_parity(full: DeviceDataset) -> None:
    """A dropout=0.0 phased trainer's first step of ``valence`` and of
    ``eeg`` against a single-subject ``MultiTaskTrainer`` step of subjects
    PARITY_SUBJECTS from the same state on the same batch: loss, the
    clipped gradient on the phase's grad set, BatchNorm running stats and
    the updated parameters, at ``loso_step_parity``'s bars. The biases whose
    exact gradient is 0 (``bn_fed_biases``) are held apart: in a phase whose
    grad set lacks the large contrastive gradients, GRAD_RTOL's floor is
    too low to cover their noise (``fusion.0.bias`` in ``valence``), so
    there each path's gradient must be noise, within NOISE_REL of the grad
    set's largest entry."""
    for phase in ("valence", "eeg"):
        vt = make_phased_trainer(full, dropout=0.0)
        plans, masks = vt._phase_plans(1)
        idx = torch.as_tensor(plans[:, 0, 0], device=full.device)
        mask = torch.as_tensor(masks[:, 0, 0], device=full.device)
        init = {s: vt.subject_variables(s) for s in PARITY_SUBJECTS}
        vt.opt = vt._phase_optimizer(phase)
        batch = vt._gather(idx)
        batch["mask"] = mask
        vt.model.train()
        grads, sums = vt._clipped_grads(phase, batch)
        vt.opt.step(vt.params, grads)
        vt_grads = vt.layout.params(grads)
        for s in PARITY_SUBJECTS:
            model = MultimodalTransformerModel(feat_dim=256, dropout=0.0, device=full.device)
            mt = MultiTaskTrainer(model, full.subset(vt.train_idx[s]),
                                  full.subset(vt.test_idx[s]), batch_size=BATCH,
                                  seed=vt.subject_seeds[s], verbose=False)
            model.load_state_dict(init[s])
            opt = mt._optimizer(phase, mt.lr)
            model.train()
            one = full.gather(idx[s])
            one["mask"] = mask[s]
            apply_grad_mask(model, mt._masks(phase)[0])
            one_sums = mt._train_step(phase, one, opt)
            want = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
            noise = bn_fed_biases(model) & set(want)
            scale = max(g.abs().max().item() for g in want.values())
            noise_rel = max(max(want[n].abs().max().item(), vt_grads[n][s].abs().max().item())
                            for n in noise) / scale
            worst, worst_name, outliers, outlier_name = grad_agreement(
                {n: vt_grads[n][s] for n in want if n not in noise},
                {n: g for n, g in want.items() if n not in noise})
            after = vt.subject_variables(s)
            stat_err = max((after[n] - b).abs().max().item() for n, b in model.named_buffers()
                           if "running" in n)
            param_err = max((after[n] - p).abs().max().item()
                            for n, p in model.named_parameters())
            loss, t_loss = sums[s, 0].item(), one_sums[0].item()
            loss_err = abs(loss - t_loss) / abs(t_loss)
            print(f"phased {phase} step subject {s} vs single-subject MultiTaskTrainer step, "
                  f"dropout 0: loss {loss:.6f} vs {t_loss:.6f} (rel {loss_err:.3e}); clipped "
                  f"gradients on the grad set ({len(want)} tensors) worst scaled |diff| "
                  f"{worst:.3e} at {worst_name}, largest share above {GRAD_RTOL}: {outliers:.3e}"
                  f"{' at ' + outlier_name if outlier_name else ''} (limit {GRAD_OUTLIERS}); the "
                  f"{len(noise)} biases before a BatchNorm at most {noise_rel:.3e} of the largest "
                  f"gradient (limit {NOISE_REL}); BN "
                  f"running stats max |diff| {stat_err:.3e} (limit 1e-4); updated parameters max "
                  f"|diff| {param_err:.3e} (limit {2 * LOSO_LR + 1e-6:.3e})")
            check(loss_err <= 1e-4 and outliers <= GRAD_OUTLIERS and noise_rel <= NOISE_REL
                  and stat_err <= 1e-4 and param_err <= 2 * LOSO_LR + 1e-6,
                  f"phased {phase} subject {s} disagrees with the single-subject trainer")
            for p in model.parameters():
                p.requires_grad_(True)
        del vt, grads
        gc.collect()
        torch.cuda.empty_cache()


def make_multitask_trainer(full: DeviceDataset, fused: bool, seed: int = SEED,
                           dropout: float | None = None, mesh=None) -> MultiTaskTrainer:
    """``MultiTaskTrainer`` for subject TEST_SUBJECT, full width (batch data
    parallelism over ``mesh``'s ranks when given)."""
    tr_idx, te_idx = loso_split(N_SUBJECTS, EX_NUMS, TEST_SUBJECT)
    model = MultimodalTransformerModel(feat_dim=256, dropout=dropout, device=full.device)
    return MultiTaskTrainer(model, full.subset(tr_idx), full.subset(te_idx), batch_size=BATCH,
                            seed=seed, fused_phases=fused, verbose=False, mesh=mesh)


def multitask_phase(full: DeviceDataset) -> tuple[dict, MultiTaskTrainer]:
    """``MultiTaskTrainer`` for subject 0 on the card:
    ``run(1, 1, 1, 1, 1, save=False, plot=False)`` through the host loop,
    then through ``fused_phases=True``, each run's launches held to the
    curriculum's. Returns the launch counts and the fused run's trainer."""
    tr_idx, te_idx = loso_split(N_SUBJECTS, EX_NUMS, TEST_SUBJECT)
    steps, evals = -(-len(tr_idx) // BATCH), -(-len(te_idx) // BATCH)
    expected = {name: 0 for name in KERNELS}
    for phase, epochs in zip(PHASE_ORDER, PHASED_EPOCHS):
        for name, n in phased_expected(phase, epochs, steps, evals).items():
            expected[name] += n
    total, results = {name: 0 for name in KERNELS}, {}
    for fused in (False, True):
        mt = make_multitask_trainer(full, fused)
        reset_launch_counts()
        test_m, seconds = synced(lambda: mt.run(*PHASED_EPOCHS, save=False, plot=False))
        counts = launch_counts()
        label = "fused phases" if fused else "host loop"
        check(counts == expected, f"MultiTaskTrainer {label} launch counts {counts} != "
                                  f"{expected}")
        check(all(math.isfinite(v) for split in ("train", "test")
                  for values in mt.metrics[split].values() for v in values),
              f"MultiTaskTrainer {label}: non-finite metrics")
        print(f"MultiTaskTrainer subject {TEST_SUBJECT}, {label}: run{PHASED_EPOCHS} "
              f"({steps} steps of {BATCH} an epoch, {evals} evaluation batch) in {seconds:.3f} s "
              f"wall; final test loss {test_m['loss']:.6f} a_acc {test_m['a_acc']:.4f} v_acc "
              f"{test_m['v_acc']:.4f}; launches equal the curriculum's: {counts == expected}")
        results[label] = test_m
        for name in KERNELS:
            total[name] += counts[name]
    gap = abs(results["fused phases"]["loss"] - results["host loop"]["loss"])
    print(f"MultiTaskTrainer fused against host loop, same seed: final test loss |diff| "
          f"{gap:.3e}")
    return total, mt


def phased_phase(full: DeviceDataset, profile: bool
                 ) -> tuple[dict, VectorizedPhasedTrainer, MultiTaskTrainer]:
    """The phased curriculum on the card: the 24-subject trainer through
    run(1, 1, 1, 1, 1) with its update masks checked, 2 timed
    ``fusion_arousal`` epochs, the bf16 curriculum against the fp32 one,
    subjects 0 and 17 against a single-subject step, and
    ``MultiTaskTrainer`` for one subject. Returns the launch counts and the
    fp32 24-subject and the one-subject trainers."""
    t_phase = time.perf_counter()
    vt = make_phased_trainer(full)
    s_n, n_train = vt.n_subjects, vt.train_idx.shape[1]
    steps, evals = -(-n_train // BATCH), -(-vt.ex_nums // BATCH)
    print(f"phased training: {s_n} subjects x {n_train} train / {vt.ex_nums} test samples, "
          f"{steps} steps of {s_n} x {BATCH} an epoch, feat_dim 256, dropout 0.4 (stem) / 0.3, "
          f"curriculum run{PHASED_EPOCHS}")
    total, fp32_losses = phased_curriculum(vt, "phased", PHASE_STEP, update_check=True)

    e = PHASED_TIMED_EPOCHS
    train, seconds, device_s, counts = phased_on_device(
        vt, "fusion_arousal", e, phased_expected("fusion_arousal", e, steps, evals),
        "phased timed")
    for name in KERNELS:
        total[name] += counts[name]
    print(f"phased fusion_arousal, {e} epochs timed: train loss mean {train['loss'].mean():.6f}; "
          f"smoke reading (host clock around a synchronised run, no host sync inside): "
          f"{seconds * 1e3 / (e * steps):.3f} ms/step of {s_n} x {BATCH} with the per-epoch "
          f"evaluation, {e * s_n * n_train / seconds:.1f} samples/s/chip; CUDA events over the "
          f"same window {device_s * 1e3 / (e * steps):.3f} ms/step, "
          f"{e * s_n * n_train / device_s:.1f} samples/s/chip")
    if profile:
        profile_window("phased fusion_arousal epoch",
                       lambda: vt.run_phase_on_device("fusion_arousal", 1), top=30)

    vt16 = make_phased_trainer(full, compute_dtype="bfloat16")
    counts16, bf16_losses = phased_curriculum(
        vt16, "phased bf16", {p: bf16_forms(step) for p, step in PHASE_STEP.items()},
        update_check=False)
    for name in KERNELS:
        total[name] += counts16[name]
    dtypes = (vt16.params.dtype, vt16.stats.dtype)
    check(dtypes == (torch.float32, torch.float32), f"phased bf16: state dtypes {dtypes}")
    for phase in PHASE_ORDER:
        gap = np.abs(bf16_losses[phase] - fp32_losses[phase]) / np.abs(fp32_losses[phase])
        print(f"phased {phase} epoch train loss, bf16 vs fp32 from the same init and plans: "
              f"relative gap per subject mean {gap.mean():.3e} max {gap.max():.3e} (limit "
              f"{LOSS_GAP_LIMIT})")
        check(gap.max() <= LOSS_GAP_LIMIT, f"phased bf16 {phase} parts from fp32")
    del vt16
    gc.collect()
    torch.cuda.empty_cache()

    phased_step_parity(full)
    mt_counts, mt = multitask_phase(full)
    for name in KERNELS:
        total[name] += mt_counts[name]
    print(f"phased phase: {time.perf_counter() - t_phase:.1f} s wall")
    return total, vt, mt


# --------------------------------------------------------------------------
# the SimCLR stack: the 24 subjects' pretrain and frozen finetune at once,
# and one subject's
# --------------------------------------------------------------------------


def simclr_modules(device: torch.device, dropout: float | None = None) -> tuple:
    """Full-width encoder, projection head and classifier (feat_dim 256, 8
    heads) from seeded generators, at the reference dropouts (stem 0.4,
    projector and classifier 0.5) or ``dropout`` at every site."""
    d_enc = 0.4 if dropout is None else dropout
    d = 0.5 if dropout is None else dropout
    return (MultiModalEncoder(256, dropout=d_enc, device=device,
                              generator=torch.Generator().manual_seed(SEED)),
            ProjectionHead(256, dropout=d, device=device,
                           generator=torch.Generator().manual_seed(SEED + 1)),
            Classifier(256, dropout=d, device=device,
                       generator=torch.Generator().manual_seed(SEED + 2)))


def make_simclr_trainer(full: DeviceDataset, dropout: float | None = None
                        ) -> VectorizedSimCLRTrainer:
    """``cli.py simclr --vectorized`` on the synthetic set: one encoder,
    projector and classifier per held-out subject, all 24 trained together."""
    return VectorizedSimCLRTrainer(*simclr_modules(full.device, dropout), full, N_SUBJECTS,
                                   EX_NUMS, pretrain_lr=SIMCLR_PRETRAIN_LR,
                                   finetune_lr=SIMCLR_FINETUNE_LR, batch_size=BATCH, seed=SEED,
                                   verbose=False)


def simclr_step_parity(full: DeviceDataset) -> None:
    """A dropout=0.0 SimCLR trainer's first pretrain step, then its first
    finetune step, against the sequential engines' one-model steps
    (``train.simclr.pretrain_step`` and ``finetune_step``) of subjects
    PARITY_SUBJECTS from the same state on the same rows: loss, gradients,
    BatchNorm running stats and updated parameters at
    ``loso_step_parity``'s bars (|diff| <= 2 lr + 1e-6 after Adam's first
    step), the biases before a BatchNorm held to be noise (NOISE_REL)."""
    vt = make_simclr_trainer(full, dropout=0.0)
    rows, labels = (torch.as_tensor(a[:, 0], device=full.device) for a in vt._pretrain_plans())
    init = {s: vt.subject_variables(s) for s in PARITY_SUBJECTS}
    vt.model.train()
    grads, loss = vt._pretrain_grad(vt.params, vt._stat_views, full.gather(rows[..., 0]),
                                    full.gather(rows[..., 1]), labels)
    vt.pre_opt.step(vt.params, grads)
    pre_grads = vt.layout.params(grads)

    idx, mask = (torch.as_tensor(a[:, 0], device=full.device) for a in vt._finetune_plans())
    batch = full.gather(idx)
    feat = vt._features(batch)
    vt.classifier.train()
    ft_grads, ft_loss = vt._finetune_grad(vt.clf_params, feat, batch, mask)
    vt.ft_opt.step(vt.clf_params, ft_grads)
    ft_grads = vt.clf_layout.params(ft_grads)
    for s in PARITY_SUBJECTS:
        enc, proj, clf = simclr_modules(full.device, dropout=0.0)
        enc.load_state_dict(init[s][0])
        proj.load_state_dict(init[s][1])
        clf.load_state_dict(init[s][2])
        enc.train()
        proj.train()
        opt = torch.optim.Adam([*enc.parameters(), *proj.parameters()], lr=SIMCLR_PRETRAIN_LR,
                               betas=(0.9, 0.999), eps=1e-8)
        one = pretrain_step(enc, proj, opt, full.gather(rows[s, :, 0]), full.gather(rows[s, :, 1]),
                            labels[s], vt.temperature, None)
        after = vt.subject_variables(s)  # both vectorized steps taken
        stages = [("pretrain", {"encoder": enc, "projector": proj}, pre_grads, loss[s].item(),
                   one.item(), SIMCLR_PRETRAIN_LR, after[:2])]
        # the finetune step from the vectorized pretrain step's encoder, so
        # that each step is held alone
        enc = copy.deepcopy(enc)
        enc.load_state_dict(after[0])
        opt = torch.optim.Adam(clf.parameters(), lr=SIMCLR_FINETUNE_LR, betas=(0.9, 0.999),
                               eps=1e-8)
        one = finetune_step(enc, clf, opt, full.gather(idx[s]), mask[s], None)
        stages.append(("finetune", {"": clf}, ft_grads, ft_loss[s].item(), one.item(),
                       SIMCLR_FINETUNE_LR, after[2:]))
        for stage, modules, vt_grads, got_loss, want_loss, lr, vt_after in stages:
            want, got, noise = {}, {}, set()
            for prefix, m in modules.items():
                pre = f"{prefix}." if prefix else ""
                for n, p in m.named_parameters():
                    want[pre + n], got[pre + n] = p.grad, vt_grads[pre + n][s]
                noise |= {pre + n for n in bn_fed_biases(m)}
            scale = max(g.abs().max().item() for g in want.values())
            noise_rel = max([max(want[n].abs().max().item(), got[n].abs().max().item())
                             for n in noise], default=0.0) / scale
            worst, worst_name, outliers, outlier_name = grad_agreement(
                {n: g for n, g in got.items() if n not in noise},
                {n: g for n, g in want.items() if n not in noise})
            stat_err = param_err = 0.0
            for m, sd in zip(modules.values(), vt_after):
                for n, t in m.state_dict().items():
                    err = (sd[n] - t).abs().max().item()
                    if "running" in n:
                        stat_err = max(stat_err, err)
                    elif "num_batches" not in n:
                        param_err = max(param_err, err)
            loss_err = abs(got_loss - want_loss) / abs(want_loss)
            print(f"SimCLR {stage} step subject {s} vs the sequential engine's step, dropout 0: "
                  f"loss {got_loss:.6f} vs {want_loss:.6f} (rel {loss_err:.3e}); gradients "
                  f"({len(want)} tensors) worst scaled |diff| {worst:.3e} at {worst_name}, largest "
                  f"share above {GRAD_RTOL}: {outliers:.3e}"
                  f"{' at ' + outlier_name if outlier_name else ''} (limit {GRAD_OUTLIERS}); the "
                  f"{len(noise)} biases before a BatchNorm at most {noise_rel:.3e} of the largest "
                  f"gradient (limit {NOISE_REL}); BN running stats max |diff| {stat_err:.3e} "
                  f"(limit 1e-4); updated parameters max |diff| {param_err:.3e} (limit "
                  f"{2 * lr + 1e-6:.3e})")
            check(loss_err <= 1e-4 and outliers <= GRAD_OUTLIERS and noise_rel <= NOISE_REL
                  and stat_err <= 1e-4 and param_err <= 2 * lr + 1e-6,
                  f"SimCLR {stage} subject {s} disagrees with the sequential engine")
    del vt, grads, ft_grads
    gc.collect()
    torch.cuda.empty_cache()


def simclr_sequential_phase(full: DeviceDataset) -> dict:
    """``cli.py simclr`` for subject 0 on the card: ``contrastive_pretrain``
    for 1 epoch on its balanced pairs and ``finetune`` for 1 epoch, each
    one's launches held to its steps'. Returns the launch counts."""
    tr_idx, te_idx = loso_split(N_SUBJECTS, EX_NUMS, TEST_SUBJECT)
    labels = {k: full.arrays[k].cpu().numpy()[tr_idx] for k in ("arousal", "valence")}
    pidx, plab = build_contrastive_pairs(labels["arousal"], labels["valence"],
                                         subject_ids_array(N_SUBJECTS, EX_NUMS)[tr_idx], seed=SEED)
    enc, proj, clf = simclr_modules(full.device)
    train, test = full.subset(tr_idx), full.subset(te_idx)
    pre_steps, ft_steps = -(-len(plab) // BATCH), -(-len(tr_idx) // BATCH)
    evals = -(-len(te_idx) // BATCH)
    total = {name: 0 for name in KERNELS}
    reset_launch_counts()
    (_, _, losses), pre_s = synced(lambda: contrastive_pretrain(
        enc, proj, train, pidx, plab, num_epochs=1, lr=SIMCLR_PRETRAIN_LR, batch_size=BATCH,
        seed=SEED, verbose=False))
    counts = launch_counts()
    expected = {name: pre_steps * SIMCLR_PRE_STEP.get(name, 0) for name in KERNELS}
    check(counts == expected, f"contrastive_pretrain launch counts {counts} != {expected}")
    for name in KERNELS:
        total[name] += counts[name]
    reset_launch_counts()
    (_, metrics), ft_s = synced(lambda: finetune(
        enc, None, clf, train, test, num_epochs=1, lr=SIMCLR_FINETUNE_LR, batch_size=BATCH,
        seed=SEED, verbose=False))
    counts = launch_counts()
    expected = {name: (ft_steps + evals) * SIMCLR_FT_STEP.get(name, 0) for name in KERNELS}
    check(counts == expected, f"finetune launch counts {counts} != {expected}")
    for name in KERNELS:
        total[name] += counts[name]
    check(all(math.isfinite(v) for v in (*losses, *metrics["loss_history"], metrics["a_acc"],
                                         metrics["v_acc"])), "SimCLR sequential: non-finite")
    print(f"SimCLR sequential engines, subject {TEST_SUBJECT}: contrastive_pretrain 1 epoch of "
          f"{pre_steps} steps over {len(plab)} pairs, loss {losses[0]:.6f}, {pre_s:.3f} s wall; "
          f"finetune 1 epoch of {ft_steps} steps and {evals} evaluation batch, loss "
          f"{metrics['loss_history'][0]:.6f} a_acc {metrics['a_acc']:.4f} v_acc "
          f"{metrics['v_acc']:.4f}, {ft_s:.3f} s wall; launches equal the steps': True")
    return total


def simclr_phase(full: DeviceDataset, profile: bool) -> dict:
    """The SimCLR stack on the card: the 24-subject trainer through
    SIMCLR_EPOCHS pretrain then finetune epochs, each under the sync check
    with its launches held to its steps' (one launch for all 24 models), the
    pair row and its BatchNorm stats bit-unchanged by the finetune, the
    second epoch of each timed; subjects 0 and 17 against the sequential
    steps; the sequential engines for one subject. Returns the launch
    counts."""
    t_phase = time.perf_counter()
    vt = make_simclr_trainer(full)
    s_n, n_train = vt.n_subjects, vt.train_idx.shape[1]
    nb, nb_ft = -(-int(vt.n_pairs.max()) // BATCH), -(-n_train // BATCH)
    print(f"SimCLR training: {s_n} subjects, {int(vt.n_pairs.min())}-{int(vt.n_pairs.max())} "
          f"balanced pairs each, pretrain {nb} steps of {s_n} x {BATCH} pairs an epoch (two "
          f"views), finetune {nb_ft} steps of {s_n} x {BATCH} of {n_train} train rows and one "
          f"evaluation of {vt.test_idx.shape[1]} held-out rows an epoch; feat_dim 256, 8 heads, "
          f"dropout 0.4 (stem) / 0.5 (projector, classifier); lr {SIMCLR_PRETRAIN_LR} / "
          f"{SIMCLR_FINETUNE_LR}")
    total = {name: 0 for name in KERNELS}
    stages = (("pretrain", vt.pretrain_epoch_on_device, nb, SIMCLR_PRE_STEP, 0),
              ("finetune", vt.finetune_epoch_on_device, nb_ft, SIMCLR_FT_STEP, 1))
    for stage, run_epoch, steps, per_step, evals in stages:
        expected = {name: (steps + evals) * per_step.get(name, 0) for name in KERNELS}
        if stage == "finetune":
            row = (vt.params.clone(), vt.stats.clone())
        for e in range(1, SIMCLR_EPOCHS + 1):
            out, seconds, device_s, counts = on_device_checked(
                run_epoch, expected, f"SimCLR {stage} epoch {e}")
            for name in KERNELS:
                total[name] += counts[name]
            loss = (out[0] if stage == "finetune" else out).cpu().numpy()
            check(bool(np.isfinite(loss).all()), f"SimCLR {stage} epoch {e}: non-finite losses")
            line = (f"SimCLR {stage} epoch {e}: loss mean {loss.mean():.6f} (subjects "
                    f"{loss.min():.6f} to {loss.max():.6f})")
            if stage == "finetune":
                acc = out[1].cpu().numpy()
                check(bool(((acc >= 0) & (acc <= 1)).all()), "SimCLR finetune: accuracies")
                line += f", held-out a_acc {acc[:, 0].mean():.4f} v_acc {acc[:, 1].mean():.4f}"
            print(f"{line}; launches {({k: n for k, n in counts.items() if n})}; {seconds:.3f} s "
                  f"wall (host clock around the "
                  f"synchronised run, no host sync inside)")
            if e == SIMCLR_EPOCHS:
                rate = (f", {s_n * steps * BATCH / seconds:.1f} pairs/s/chip by the host clock, "
                        f"{s_n * steps * BATCH / device_s:.1f} by CUDA events"
                        if stage == "pretrain" else
                        f" with the evaluation, {s_n * n_train / seconds:.1f} samples/s/chip")
                print(f"SimCLR {stage} epoch {e} timed: smoke reading {seconds * 1e3 / steps:.3f} "
                      f"ms/step of {s_n} x {BATCH} (host clock), CUDA events over the same "
                      f"window {device_s * 1e3 / steps:.3f} ms/step{rate}")
        if stage == "finetune":
            frozen = torch.equal(vt.params, row[0]) and torch.equal(vt.stats, row[1])
            print(f"SimCLR finetune left the encoder and projector row and its BatchNorm stats "
                  f"bit-unchanged: {frozen}")
            check(frozen, "SimCLR finetune moved the frozen row")
            del row
    if profile:
        profile_window("SimCLR pretrain epoch", vt.pretrain_epoch_on_device, top=30,
                       show=("stem_tail",), share="stem_tail")
    del vt
    gc.collect()
    torch.cuda.empty_cache()
    simclr_step_parity(full)
    seq = simclr_sequential_phase(full)
    for name in KERNELS:
        total[name] += seq[name]
    print(f"SimCLR phase: {time.perf_counter() - t_phase:.1f} s wall")
    return total


# --------------------------------------------------------------------------
# checkpoints: full-state save and restore, evaluation of a saved model
# --------------------------------------------------------------------------


def counted(fn, expected: dict, label: str) -> tuple:
    """``fn()`` synchronised, the launch counters reset just before and held
    to ``expected`` after. Returns its result, the host-clock seconds and
    the launch counts."""
    reset_launch_counts()
    out, seconds = synced(fn)
    counts = launch_counts()
    check(counts == expected, f"{label} launch counts {counts} != {expected}")
    return out, seconds, counts


def launches(per: dict, n: int) -> dict:
    """``n`` times ``per`` (one call's launches by kernel), every kernel."""
    return {name: n * per.get(name, 0) for name in KERNELS}


def add_counts(total: dict, counts: dict) -> None:
    for name in KERNELS:
        total[name] += counts[name]


def differing(a: dict, b: dict) -> list[str]:
    """The names whose tensors differ in dtype or in any bit."""
    return [n for n in a if not (a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]))]


def saved_and_restored(obj, path: str, make_fresh) -> tuple:
    """``obj.save_state(path)`` and a fresh trainer's ``restore_state``:
    returns the fresh trainer, the file's MB and the seconds to save and to
    restore (host clock, the card synchronised); removes the file."""
    _, save_s = synced(lambda: obj.save_state(path))
    mb = os.path.getsize(path) / 1e6
    fresh = make_fresh()
    _, restore_s = synced(lambda: fresh.restore_state(path))
    os.remove(path)
    return fresh, mb, save_s, restore_s


def resumed_gap(label: str, losses: list, smi: str) -> None:
    """Per-subject losses of the saved and the restored trainer's next
    epoch, relative: card training is not bit-reproducible, so RESUME_RTOL."""
    gap = np.abs(np.asarray(losses[1]) - np.asarray(losses[0])) / np.abs(np.asarray(losses[0]))
    print(f"{label}: the next epoch's train loss, restored against saved trainer: relative gap "
          f"max {gap.max():.3e} (limit {RESUME_RTOL}) ({smi})")
    check(gap.max() <= RESUME_RTOL, f"{label}: the restored trainer parts from the saved one")


def loso_checkpoint(vt: VectorizedLOSOTrainer, full: DeviceDataset, tmp: str, smi: str) -> dict:
    """The LOSO trainer's full state to a file and into a fresh trainer:
    every tensor and the generators bit-equal, then one host-plan epoch of
    both (launches per step PER_STEP's, losses within RESUME_RTOL, the
    generators equal again). Returns the launch counts."""
    total = {name: 0 for name in KERNELS}
    steps = -(-vt.train_idx.shape[1] // BATCH)
    fresh, mb, save_s, restore_s = saved_and_restored(
        vt, os.path.join(tmp, "loso_state.pt"), lambda: make_loso_trainer(full))

    def generators_equal() -> bool:
        return (torch.equal(vt.generator.get_state(), fresh.generator.get_state())
                and torch.equal(vt.plan_generator.get_state(), fresh.plan_generator.get_state())
                and vt.host_rng.bit_generator.state == fresh.host_rng.bit_generator.state)

    state = vt._state_tensors()
    differ, gens = differing(state, fresh._state_tensors()), generators_equal()
    print(f"LOSO save_state: {len(state)} tensors ({', '.join(state)}), {mb:.1f} MB, saved in "
          f"{save_s:.3f} s, restored into a fresh trainer in {restore_s:.3f} s (host clock) "
          f"({smi}); tensors that differ: {differ or 'none'}; generators and host generator "
          f"equal: {gens}")
    check(not differ and gens, "LOSO restore is not bit-equal")
    losses = []
    for label, t in (("saved", vt), ("restored", fresh)):
        tm, seconds, counts = counted(t.train_epoch, launches(PER_STEP, steps),
                                      f"LOSO {label} trainer's epoch")
        add_counts(total, counts)
        losses.append(tm["loss"])
        print(f"LOSO {label} trainer, one host-plan epoch: {seconds * 1e3 / steps:.3f} ms/step "
              f"(host clock), launches per step PER_STEP's ({smi})")
    resumed_gap("LOSO resume", losses, smi)
    check(generators_equal(), "LOSO generators part after the resumed epoch")
    print("LOSO generators and host generator equal after the epoch: True")
    del fresh
    return total


def tester_checkpoint(vt: VectorizedLOSOTrainer, full: DeviceDataset, tmp: str,
                      smi: str) -> dict:
    """Subjects PARITY_SUBJECTS' models from ``vt.subject_variables`` to
    ``.pt`` files, evaluated by ``Tester.run`` on their held-out rows at
    S=1 against ``vt.evaluate()`` at S=24 (per-head accuracy; a row may
    differ only where its top-two logit margin is under TIE_MARGIN), the
    Tester's launches, its ms per batch, and ``predict_single`` at B=1 on
    three rows against ``evaluate``'s. Returns the launch counts."""
    total = {name: 0 for name in KERNELS}
    ev, _, counts = counted(vt.evaluate, launches(TESTER_EVAL, 1), "LOSO evaluate")
    add_counts(total, counts)
    for sid in PARITY_SUBJECTS:
        path = os.path.join(tmp, f"subject{sid}.pt")
        torch.save(vt.subject_variables(sid), path)
        test = full.subset(vt.test_idx[sid])
        n, batches = len(test), -(-len(test) // BATCH)
        tester = Tester(make_model(full.device), test)
        res, seconds, counts = counted(lambda: tester.run(path, verbose=True, plot_dir=None),
                                       launches(TESTER_EVAL, batches), f"Tester subject {sid}")
        add_counts(total, counts)
        os.remove(path)
        for head, key in (("arousal", "a_acc"), ("valence", "v_acc")):
            r = res[head]
            got, want = round(r["accuracy"] * n), round(float(ev[key][sid]) * n)
            top2 = np.sort(np.log(r["probabilities"]), 1)[:, -2:]
            margin = top2[:, 1] - top2[:, 0]
            close = np.flatnonzero(margin < TIE_MARGIN)
            print(f"Tester subject {sid} {head} (S=1): accuracy {got}/{n}; vt.evaluate() "
                  f"(S=24) {want}/{n}; rows with a top-two logit margin under {TIE_MARGIN}: "
                  f"{[(int(i), float(margin[i])) for i in close] or 'none'}")
            check(abs(got - want) <= len(close), f"Tester subject {sid} {head}: accuracy "
                                                  f"{got}/{n} against vt.evaluate() {want}/{n}")
        timed = TIMED_CALLS * batches
        reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(TIMED_CALLS):
            tester.evaluate(verbose=False)
        end.record()
        torch.cuda.synchronize()
        host_ms, device_ms = (time.perf_counter() - t0) * 1e3 / timed, start.elapsed_time(end) / timed
        counts = launch_counts()
        check(counts == launches(TESTER_EVAL, timed), f"Tester timed launch counts {counts}")
        add_counts(total, counts)
        print(f"Tester subject {sid}: {n} held-out rows in {batches} batch; launches "
              f"{TESTER_EVAL} a batch; evaluate {host_ms:.3f} ms per batch (host clock, "
              f"{TIMED_CALLS} calls, each with its read-back), {device_ms:.3f} by CUDA events "
              f"({smi})")
        rows = (0, n // 2, n - 1)
        singles, _, counts = counted(
            lambda: [tester.predict_single({k: test.arrays[k][i].cpu().numpy()
                                            for k in ("eeg", "eye", "pps")}) for i in rows],
            launches(TESTER_EVAL, len(rows)), f"predict_single subject {sid}")
        add_counts(total, counts)
        err = max(float(np.abs(one[head]["probabilities"] - res[head]["probabilities"][i]).max())
                  for i, one in zip(rows, singles) for head in ("arousal", "valence"))
        print(f"predict_single subject {sid}, rows {rows} at B=1: probabilities against "
              f"evaluate's max |diff| {err:.3e} (limit {PREDICT_ATOL}); launches {TESTER_EVAL} "
              f"a row")
        check(err <= PREDICT_ATOL, f"predict_single subject {sid} parts from evaluate")
    return total


def trainer_checkpoint(trainer: Trainer, full: DeviceDataset, tmp: str, smi: str) -> dict:
    """``Trainer``'s full state into a fresh trainer, bit-equal, and
    ``test_with_loaded_model`` of its ``best_model.pt`` against
    ``trainer.test()``. Returns the launch counts."""
    total = {name: 0 for name in KERNELS}
    evals = -(-len(trainer.test_data) // BATCH)
    fresh, mb, save_s, restore_s = saved_and_restored(
        trainer, os.path.join(tmp, "trainer_state.pt"), lambda: make_trainer(full))
    a, b = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
    same = {
        "model": not differing(trainer.model.state_dict(), fresh.model.state_dict()),
        "contrastive weight": torch.equal(trainer.contrastive_weight, fresh.contrastive_weight),
        "AdamW": a["param_groups"] == b["param_groups"] and all(
            torch.equal(v, b["state"][k][name]) for k, st in a["state"].items()
            for name, v in st.items()),
        "generators": (torch.equal(trainer.generator.get_state(), fresh.generator.get_state())
                       and trainer.host_rng.bit_generator.state
                       == fresh.host_rng.bit_generator.state),
        "schedules and histories": (trainer.scheduler, trainer.early, trainer.train_loss,
                                    trainer.test_loss) == (fresh.scheduler, fresh.early,
                                                           fresh.train_loss, fresh.test_loss),
    }
    print(f"Trainer save_state: {mb:.1f} MB, saved in {save_s:.3f} s, restored in "
          f"{restore_s:.3f} s (host clock) ({smi}); bit-equal: {same}")
    check(all(same.values()), f"Trainer restore is not bit-equal: {same}")
    del fresh
    trainer.checkpoint_dir = tmp
    trainer._save("best_model.pt")
    want, _, counts = counted(trainer.test, launches(PER_EVAL, evals), "Trainer test")
    add_counts(total, counts)
    other = make_trainer(full)  # its own init; the trainer-level weight is no part of the file
    with torch.no_grad():
        other.contrastive_weight.copy_(trainer.contrastive_weight)
    got, seconds, counts = counted(
        lambda: other.test_with_loaded_model(os.path.join(tmp, "best_model.pt")),
        launches(PER_EVAL, evals), "test_with_loaded_model")
    add_counts(total, counts)
    err = max(abs(g - w) for g, w in zip(got, want))
    print(f"test_with_loaded_model(best_model.pt) on a fresh trainer: {got} against "
          f"trainer.test() {want}, max |diff| {err:.3e} (limit {CKPT_ATOL}); {seconds:.3f} s "
          f"with the load ({smi})")
    check(err <= CKPT_ATOL, "test_with_loaded_model parts from trainer.test()")
    del other
    return total


def phased_checkpoint(vp: VectorizedPhasedTrainer, mt: MultiTaskTrainer, full: DeviceDataset,
                      tmp: str, smi: str) -> dict:
    """The phased trainers' full state into fresh trainers (another seed for
    the one-subject trainer), bit-equal, then one ``fusion_arousal`` epoch
    of each pair (launches the curriculum's, losses within RESUME_RTOL);
    ``save_checkpoints``' 24 files, each loaded strictly. Returns the launch
    counts."""
    total = {name: 0 for name in KERNELS}
    steps, evals = -(-vp.train_idx.shape[1] // BATCH), -(-vp.ex_nums // BATCH)
    fresh, mb, save_s, restore_s = saved_and_restored(
        vp, os.path.join(tmp, "phased_state.pt"), lambda: make_phased_trainer(full))
    lanes = lambda t: {f"{ph}.{k}": v for ph, d in t._phase_sched.items() for k, v in d.items()}
    arrays = lambda t: [a for d in t.metrics.values() for v in d.values() for a in v] + [
        t._last_test[k] for k in sorted(t._last_test)]
    same = {
        "rows": not differing({"params": vp.params, "stats": vp.stats},
                              {"params": fresh.params, "stats": fresh.stats}),
        "generators": (torch.equal(vp.generator.get_state(), fresh.generator.get_state())
                       and [r.bit_generator.state for r in vp.host_rngs]
                       == [r.bit_generator.state for r in fresh.host_rngs]),
        "lanes": vp._phase_epochs == fresh._phase_epochs and lanes(vp).keys() == lanes(
            fresh).keys() and not differing(lanes(vp), lanes(fresh)),
        "metrics": len(arrays(vp)) == len(arrays(fresh)) and all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(arrays(vp), arrays(fresh))),
    }
    print(f"phased save_state: {mb:.1f} MB, saved in {save_s:.3f} s, restored in "
          f"{restore_s:.3f} s (host clock) ({smi}); bit-equal: {same}")
    check(all(same.values()), f"phased restore is not bit-equal: {same}")
    losses = []
    for label, t in (("saved", vp), ("restored", fresh)):
        _, seconds, counts = counted(lambda: t.run_phase("fusion_arousal", 1),
                                     phased_expected("fusion_arousal", 1, steps, evals),
                                     f"phased {label} trainer's epoch")
        add_counts(total, counts)
        losses.append(t.metrics["train"]["loss"][-1])
        print(f"phased {label} trainer, one fusion_arousal epoch: {seconds:.3f} s with the "
              f"evaluation ({smi})")
    resumed_gap("phased resume", losses, smi)
    del fresh
    paths, seconds = synced(lambda: vp.save_checkpoints(os.path.join(tmp, "subjects")))
    model = MultimodalTransformerModel(feat_dim=256, device=full.device)
    for sid, path in enumerate(paths):
        model.load_state_dict(torch.load(path, map_location=full.device, weights_only=True),
                              strict=True)
        check(not differing(model.state_dict(), vp.subject_variables(sid)),
              f"subject {sid}'s checkpoint does not hold its model")
    shutil.rmtree(os.path.join(tmp, "subjects"))
    print(f"phased save_checkpoints: {len(paths)} files in {seconds:.3f} s ({smi}), e.g. "
          f"{os.path.basename(paths[0])}; each loads strictly into MultimodalTransformerModel "
          f"and holds its subject's model")
    check(len(paths) == N_SUBJECTS, f"save_checkpoints wrote {len(paths)} files")

    m_steps = -(-len(mt.train_data) // BATCH)
    m_evals = -(-len(mt.test_data) // BATCH)
    fresh, mb, save_s, restore_s = saved_and_restored(
        mt, os.path.join(tmp, "multitask_state.pt"),
        lambda: make_multitask_trainer(full, fused=True, seed=SEED + 1))
    same = {
        "model": not differing(mt.model.state_dict(), fresh.model.state_dict()),
        "generators": (torch.equal(mt.generator.get_state(), fresh.generator.get_state())
                       and mt.host_rng.bit_generator.state == fresh.host_rng.bit_generator.state),
        "schedulers, metrics, test_person": (mt.schedulers, mt.metrics, mt.test_person)
                                           == (fresh.schedulers, fresh.metrics, fresh.test_person),
    }
    print(f"MultiTaskTrainer save_state: {mb:.1f} MB, saved in {save_s:.3f} s, restored into a "
          f"trainer of another seed in {restore_s:.3f} s (host clock) ({smi}); bit-equal: {same}")
    check(all(same.values()), f"MultiTaskTrainer restore is not bit-equal: {same}")
    losses = []
    for label, t in (("saved", mt), ("restored", fresh)):
        _, seconds, counts = counted(lambda: t.run(0, 0, 0, 1, 0, save=False, plot=False),
                                     phased_expected("fusion_arousal", 1, m_steps, m_evals),
                                     f"MultiTaskTrainer {label} epoch")
        add_counts(total, counts)
        losses.append([t.metrics["train"]["loss"][-1]])
    resumed_gap("MultiTaskTrainer resume", losses, smi)
    del fresh
    return total


def checkpoints_phase(trainer: Trainer, vt: VectorizedLOSOTrainer, vp: VectorizedPhasedTrainer,
                      mt: MultiTaskTrainer, full: DeviceDataset, smi: str) -> dict:
    """Full-state save and restore of the four trainers the earlier phases
    built, the Tester on two LOSO subjects' saved models, and
    ``test_with_loaded_model``. Returns the launch counts."""
    t0 = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for part in (lambda: loso_checkpoint(vt, full, tmp, smi),
                     lambda: tester_checkpoint(vt, full, tmp, smi),
                     lambda: trainer_checkpoint(trainer, full, tmp, smi),
                     lambda: phased_checkpoint(vp, mt, full, tmp, smi)):
            add_counts(total, part())
            gc.collect()
            torch.cuda.empty_cache()
    found = {m: importlib.util.find_spec(m) is not None for m in ("sklearn", "matplotlib",
                                                                   "pandas")}
    print(f"importable on this machine (the phase uses none of them): {found}")
    print(f"checkpoints phase: {time.perf_counter() - t0:.1f} s wall ({smi})")
    return total


# --------------------------------------------------------------------------
# the command-line drivers
# --------------------------------------------------------------------------

# the kernels each subcommand's path launches (rows 1, 2, 9, 11, 12 and 13 with
# the pieces rows 1, 9 and 11 launch; row 17 in ME-MHACL's validation); all
# others stay at 0, but the flash kernels in ME-MHACL, which launch only
# where its attention runs above length 8 (read from the counts)
CLI_TRAIN = ("bilstm_fwd", "stem_tail", "bilstm_cbnd", "bilstm_segbwd", "stem_tail_bwd")
CLI_PATHS = {"inspect": (), "vloso": (*CLI_TRAIN, "infonce"), "single": (*CLI_TRAIN, "infonce"),
             "phased": (*CLI_TRAIN, "infonce"), "simclr": CLI_TRAIN,
             "memhacl": ("fusion_head",), "eval": ("bilstm_fwd", "stem_tail")}
CLI_FREE = {"memhacl": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
# the JAX cli.py payloads' keys (vloso :422-431 with --early-stop, single
# :387-388, phased :181-182 and :269-279, simclr :318-326, memhacl :476, eval
# :493-496) and the accuracies among them
CLI_KEYS = {"vloso": {"mean_arousal_acc", "mean_valence_acc", "per_subject_arousal",
                      "per_subject_valence", "stop_epochs", "final_arousal_acc",
                      "final_valence_acc"},
            "single": {"per_subject", "mean_arousal_acc"},
            "phased": {"per_subject", "mean_arousal_acc", "mean_valence_acc"},
            "simclr": {"per_subject", "mean_arousal_acc", "mean_valence_acc"},
            "memhacl": {"a_acc", "v_acc", "loss_history"},
            "eval": {"arousal_accuracy", "valence_accuracy"}}
CLI_ACC_KEYS = ("mean_arousal_acc", "mean_valence_acc", "per_subject_arousal",
                "per_subject_valence", "final_arousal_acc", "final_valence_acc", "a_acc", "v_acc",
                "test_acc", "arousal_accuracy", "valence_accuracy")


def cli_accuracies(payload) -> list[float]:
    """Every accuracy in a results payload, however nested."""
    found = []
    for key, value in payload.items():
        if isinstance(value, dict):
            found += cli_accuracies(value)
        elif key in CLI_ACC_KEYS:
            found += value if isinstance(value, list) else [value]
    return found


def cli_run(name: str, argv: list[str], tmp: str, expected: dict | None = None):
    """``cli.main(argv)`` in this process with the counters reset just
    before and read just after; checks its results JSON (the JAX keys, plain
    numbers, accuracies finite and in [0, 1]) and its launches: ``expected``
    exactly, else nonzero on the subcommand's path and 0 elsewhere. Returns
    the payload (None for ``inspect``), the counts and the seconds."""
    command = argv[0]
    out = os.path.join(tmp, f"{name}.json")
    argv = [*argv, "--no-plots", "--quiet", "--checkpoint-dir", os.path.join(tmp, f"ckpt_{name}")]
    if command != "inspect":
        argv += ["--results-json", out]
    reset_launch_counts()
    _, seconds = synced(lambda: cli.main(argv))
    counts = launch_counts()
    print(f"cli {name}: {seconds:.3f} s; launches {({k: n for k, n in counts.items() if n})}")
    if expected is not None:
        check(counts == expected, f"cli {name} launch counts {counts} != {expected}")
    else:
        path = set(with_row_kernels({k: 1 for k in CLI_PATHS[command]}))
        missing = [k for k in path if not counts[k]]
        stray = [k for k in KERNELS if counts[k] and k not in path
                 and k not in CLI_FREE.get(command, ())]
        check(not missing and not stray,
              f"cli {name}: kernels of its path not launched {missing}, others launched {stray}")
    if command == "inspect":
        return None, counts, seconds
    with open(out) as f:
        text = f.read()
    payload = json.loads(text)
    check(set(payload) == CLI_KEYS[command],
          f"cli {name}: results keys {sorted(payload)} != the JAX payload's")
    accs = cli_accuracies(payload)
    check(bool(accs) and all(isinstance(a, (int, float)) and 0.0 <= a <= 1.0 for a in accs),
          f"cli {name}: accuracies not finite in [0, 1]: {accs}")
    print(f"cli {name} results: {text[:300].replace(chr(10), ' ')}")
    return payload, counts, seconds


def cli_export(device: torch.device, tmp: str, total: dict) -> float:
    """``cli export --synthetic`` (JAX ``cli.py:499-555``): a polymorphic
    artifact of the seeded flagship, no launch while it traces, the JAX
    payload (its byte count the file's size); the artifact loaded and run on
    64 rows (row 1 twice, nothing else), its logits within EXPORT_REL of
    ``build_serving_forward`` of the same flagship. Returns its seconds."""
    art, out = os.path.join(tmp, "serving.pt2"), os.path.join(tmp, "export.json")
    reset_launch_counts()
    _, seconds = synced(lambda: cli.main(["export", "--synthetic", "--output", art,
                                          "--results-json", out, "--quiet"]))
    traced = {k: n for k, n in launch_counts().items() if n}
    with open(out) as f:
        payload = json.load(f)
    print(f"cli export: {seconds:.3f} s; results {payload}")
    check(not traced, f"cli export: tracing launched kernels {traced}")
    check(payload == {"artifact_bytes": os.path.getsize(art), "output": art},
          f"cli export: results {payload} do not name the {os.path.getsize(art)}-byte file")
    rng = np.random.default_rng(SEED + 9)
    args = tuple(torch.as_tensor(rng.normal(size=(BATCH, *shape)).astype(np.float32),
                                 device=device) for shape in ((32, 585), (38,), (230,)))
    fwd = load_serving(art)
    reset_launch_counts()
    got = fwd(*args)
    counts = launch_counts()
    check(counts == {k: 0 for k in KERNELS} | with_row_kernels({"bilstm_fwd": 2}),
          f"cli export: the artifact's launch counts {counts}")
    add_counts(total, counts)
    flagship = MultimodalTransformerModel(feat_dim=256, device=device,
                                          generator=torch.Generator().manual_seed(42))
    gap, scale, _ = logit_gap([got], [build_serving_forward(flagship)(*args)])
    print(f"cli export: the artifact at B={BATCH} against build_serving_forward of the seeded "
          f"flagship: max |diff| {gap:.3e} of scale {scale:.3e}")
    check(gap <= EXPORT_REL * scale, "cli export: the artifact disagrees with the closure")
    return seconds


def cli_phase(device: torch.device, smi: str) -> dict:
    """The port's CLI (``multimodal_sentiment_aanalysis_tpu_torch.cli.main``)
    in this process at reference widths on the synthetic set (24 subjects,
    feat_dim 256, B=64), the depth cut: each subcommand's launches by kernel,
    its results JSON, and the entry point started as a user starts it.
    Returns the launch counts."""
    t0 = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    steps = -(-(N_SUBJECTS - 1) * EX_NUMS // BATCH)  # 460 training rows a model
    seconds = {}

    def vloso_expected(epochs: int) -> dict:
        # fused epochs with the early-stop lanes: steps and one held-out
        # evaluation an epoch, then the best and the final accuracies
        return {k: epochs * (steps * PER_STEP.get(k, 0) + PER_EVAL.get(k, 0))
                + 2 * TESTER_EVAL.get(k, 0) for k in KERNELS}

    vphased = []  # the vectorized phased trainer, kept where it writes its checkpoints
    keep_save = VectorizedPhasedTrainer.save_checkpoints

    def save_checkpoints(self, checkpoint_dir):
        vphased.append(self)
        return keep_save(self, checkpoint_dir)

    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "vloso_state.pt")
        pickle_path = os.path.join(tmp, "hci_data.pkl")
        save_pickle(make_synthetic_hci_data(seed=42), pickle_path)  # the CLI's default seed
        runs = [("inspect", ["inspect", "--synthetic"], None),
                ("vloso", ["vloso", "--synthetic", "--fused", "--early-stop", "--epochs", "2",
                           "--save-state", state], vloso_expected(2)),
                ("vloso_resume", ["vloso", "--synthetic", "--fused", "--early-stop", "--epochs",
                                  "1", "--resume", state], vloso_expected(1)),
                ("single", ["single", "--synthetic", "--subjects", "0", "--epochs", "1"], None),
                ("phased_vectorized", ["phased", "--synthetic", "--vectorized", "--epochs",
                                       "1", "1", "1", "1", "1"], None),
                ("phased", ["phased", "--synthetic", "--subjects", "0", "--epochs", "1", "0",
                            "0", "1", "0", "--history-dir", os.path.join(tmp, "history")],
                 None),
                ("phased_data", ["phased", "--data", pickle_path, "--subjects", "0", "--epochs",
                                 "1", "0", "0", "1", "0", "--history-dir",
                                 os.path.join(tmp, "history")], None),
                ("simclr_vectorized", ["simclr", "--synthetic", "--vectorized",
                                       "--pretrain-epochs", "1", "--finetune-epochs", "1"], None),
                ("memhacl", ["memhacl", "--synthetic", "--pretrain-epochs", "1",
                             "--finetune-epochs", "1"], None)]
        payloads = {}
        with mock.patch.object(VectorizedPhasedTrainer, "save_checkpoints", save_checkpoints):
            for name, argv, expected in runs:
                payloads[name], counts, seconds[name] = cli_run(name, argv, tmp, expected)
                add_counts(total, counts)
                if name == "phased_vectorized":
                    # eval of subject 0's file that save_checkpoints wrote
                    ckpt = os.path.join(tmp, f"ckpt_{name}")
                    (model_path,) = [p for p in os.listdir(ckpt) if p.startswith("TestPerson0_")]
                    payloads["eval"], counts, seconds["eval"] = cli_run(
                        "eval", ["eval", "--synthetic", "--subjects", "0", "--model-path",
                                 os.path.join(ckpt, model_path)], tmp)
                    add_counts(total, counts)
                gc.collect()
                torch.cuda.empty_cache()
        print(f"cli: the vloso state file {os.path.getsize(state) / 1e6:.1f} MB; the history CSV "
              f"{os.listdir(os.path.join(tmp, 'history'))}")
        seconds["export"] = cli_export(device, tmp, total)

    # --data of the pickle against --synthetic: the same arrays; the card's
    # training is not bit-reproducible, so the losses within RESUME_RTOL
    a, b = payloads["phased"], payloads["phased_data"]
    gap = max(abs(a["per_subject"]["0"][k] - b["per_subject"]["0"][k])
              / max(abs(a["per_subject"]["0"][k]), 1e-12) for k in a["per_subject"]["0"])
    check(cli_accuracies(a) == cli_accuracies(b) and gap <= RESUME_RTOL,
          f"cli phased: --data and --synthetic payloads differ: {a} / {b}")
    print(f"cli phased: --data and --synthetic payloads equal (accuracies equal, metrics "
          f"within {gap:.3e} relative)")
    # eval against the Tester on the trainer's subject 0, the same weights
    (vp,) = vphased
    test = vp.data.subset(vp.test_idx[0])
    model = MultimodalTransformerModel(feat_dim=256, device=device)
    r = Tester(model, test, state_dict=vp.subject_variables(0)).evaluate(verbose=False)
    want = {"arousal_accuracy": r["arousal"]["accuracy"],
            "valence_accuracy": r["valence"]["accuracy"]}
    check(payloads["eval"] == want, f"cli eval {payloads['eval']} != the Tester's {want}")
    print(f"cli eval: accuracies equal the Tester's on subject_variables(0): {want}")
    del vp, vphased, test, model
    gc.collect()
    torch.cuda.empty_cache()

    # the entry point as a user starts it, in its own process
    cmd = [sys.executable, "-m", "multimodal_sentiment_aanalysis_tpu_torch.cli", "inspect",
           "--synthetic"]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds["python -m cli inspect"] = time.perf_counter() - t1
    check(proc.returncode == 0 and "finite-check: OK" in proc.stdout and "on cuda" in proc.stdout,
          f"python -m ...cli inspect failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    print(f"cli python -m ... inspect --synthetic: exit 0, "
          f"{proc.stdout.strip().splitlines()[-2]}")
    seconds["torchrun vloso --dp"] = cli_dp_check()
    print("cli seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    print(f"cli phase: {time.perf_counter() - t0:.1f} s wall ({smi})")
    return total


# ---------------------------------------------------------------------------
# parallel (ROADMAP A13): subject sharding and batch data parallelism
# ---------------------------------------------------------------------------


def cli_dp_check() -> float:
    """``torchrun --nproc-per-node 1 -m ...cli vloso --dp --epochs 1`` and
    the same command without ``--dp`` (``python -m``), each in its own
    process: their results JSON's accuracies equal. Returns the seconds."""
    t0 = time.perf_counter()
    payloads = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for label, launcher, extra in (  # both at once, sharing the card
                ("torchrun --dp", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                   "--nproc-per-node", "1"], ["--dp"]),
                ("python -m", [sys.executable], [])):
            out = os.path.join(tmp, f"{len(extra)}.json")
            cmd = [*launcher, "-m", "multimodal_sentiment_aanalysis_tpu_torch.cli", "vloso",
                   "--synthetic", "--epochs", "1", "--quiet", "--checkpoint-dir", tmp,
                   "--results-json", out, *extra]
            procs[label] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        try:
            for label, (out, proc) in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                check(proc.returncode == 0,
                      f"cli {label} vloso failed (exit {proc.returncode}):\n{stdout}{stderr}")
                with open(out) as f:
                    payloads[label] = json.load(f)
        finally:  # no process outlives the check
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    a, b = (cli_accuracies(payloads[k]) for k in ("torchrun --dp", "python -m"))
    print(f"cli torchrun --nproc-per-node 1 ... vloso --dp --epochs 1: accuracies "
          f"{'equal to' if a == b else 'DIFFER from'} the run without --dp "
          f"(mean arousal {payloads['torchrun --dp']['mean_arousal_acc']:.4f})")
    check(a == b, f"cli vloso --dp under torchrun: {a} != {b}")
    return time.perf_counter() - t0

# rows 1, 2, 9, 11, 12 and 13: every rank of a sharded or DP run launches them
PARALLEL_ROWS = ("bilstm_fwd", "stem_tail", "bilstm_cbnd", "bilstm_segbwd", "stem_tail_bwd",
                 "infonce")
PARALLEL_LOSS_RTOL = 1e-5  # two ranks' LOSO losses against one process's
PARALLEL_DP_RTOL = 1e-5    # two ranks' MultiTaskTrainer epoch loss against one process's
# the summed DP gradients against one process's: 1e-5 of each tensor's
# largest entry plus 1e-6 of the step's largest (a bias before a BatchNorm
# has an exact gradient of 0, so float noise), the CPU test's bar
PARALLEL_GRAD_REL, PARALLEL_GRAD_TOP = 1e-5, 1e-6
DP_GRAD_PAD = 5  # padding rows at the end of the gradient check's batch
PARALLEL_LIMIT = 600.0     # seconds for a whole two-rank launch


def loso_rank_epoch(mesh, arrays: dict) -> dict:
    """One rank of a subject-sharded LOSO run: one host-plan epoch of the
    24 models (dropout 0, early stop off), its launches and accuracies,
    then a second epoch's ms/step (the first pays the process's first
    launches)."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.mesh import mesh_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = DeviceDataset(arrays, mesh_device(mesh))
    vt = make_loso_trainer(full, dropout=0.0, early_stop=False, mesh=mesh)
    steps = -(-vt.train_idx.shape[1] // BATCH)
    reset_launch_counts()
    tm = vt.train_epoch()
    out = {"epoch": tm, "eval": vt.evaluate(), "counts": launch_counts(), "models": vt.n_local}
    _, seconds = synced(vt.train_epoch)
    return {**out, "ms_step": seconds * 1e3 / steps}


def multitask_grads(mt: MultiTaskTrainer) -> dict:
    """One ``eeg`` and one ``fusion_arousal`` step's gradients on the first
    ``BATCH`` training rows, the last ``DP_GRAD_PAD`` masked out, at lr 0
    and without the clip, so the parameters stay as they are (the forwards
    move the BatchNorm running stats, as they do in the run held against
    it). Under a mesh each rank runs its block and the gradients come out
    summed over the ranks. Both phases run the stem tail's backward, where a
    ``dgamma`` summed over the ranks twice would come out W-fold."""
    from multimodal_sentiment_aanalysis_tpu_torch.train import apply_grad_mask

    idx = torch.arange(BATCH, device=mt.device)
    mask = (idx < BATCH - DP_GRAD_PAD).to(torch.float32)
    clip, mt.clip_norm = mt.clip_norm, math.inf
    out = {}
    try:
        for phase in ("eeg", "fusion_arousal"):
            mt.model.train()
            apply_grad_mask(mt.model, mt._masks(phase)[0])
            batch = mt.train_data.gather(mt._block(idx))
            batch["mask"] = mt._block(mask)
            mt._train_step(phase, batch, mt._optimizer(phase, 0.0), mask.sum())
            out[phase] = {n: p.grad.cpu() for n, p in mt.model.named_parameters()
                          if p.grad is not None}
            for p in mt.model.parameters():
                p.requires_grad_(True)
    finally:
        mt.clip_norm = clip
    return out


def grad_gap(got: dict, want: dict) -> tuple[float, str]:
    """The largest ratio of a gradient's difference to its bar, and where."""
    worst = (0.0, "")
    for phase, ref in want.items():
        check(got[phase].keys() == ref.keys(), f"DP gradients of {phase}: other parameters")
        top = max(float(r.abs().max()) for r in ref.values())
        for k, r in ref.items():
            bar = PARALLEL_GRAD_REL * float(r.abs().max()) + PARALLEL_GRAD_TOP * top
            ratio = float((got[phase][k] - r).abs().max()) / bar
            worst = max(worst, (ratio, f"{phase} {k}"))
    return worst


def multitask_rank_epoch(mesh, arrays: dict) -> dict:
    """One rank of ``MultiTaskTrainer(mesh=)``: the gradient check's steps
    (rank 0 returns the summed gradients), then one ``fusion_arousal`` epoch
    of subject 0 (dropout 0), its launches, ms/step and the bytes each step
    all-reduces."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel import collectives
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.mesh import mesh_device

    full = DeviceDataset(arrays, mesh_device(mesh))
    mt = make_multitask_trainer(full, fused=False, dropout=0.0, mesh=mesh)
    steps = -(-len(mt.train_data) // BATCH)
    grads = multitask_grads(mt)
    reset_launch_counts()
    out = {"metrics": mt.train_epoch_phase("fusion_arousal"), "counts": launch_counts(),
           "state": {k: v.cpu() for k, v in mt.model.state_dict().items()},
           "grads": grads if mesh.get_local_rank() == 0 else None}
    collectives.reset_traffic()  # a second epoch, timed
    _, seconds = synced(lambda: mt.train_epoch_phase("fusion_arousal"))
    return {**out, "ms_step": seconds * 1e3 / steps,
            "bytes_step": collectives.TRAFFIC["all_reduce_bytes"] / steps,
            "calls_step": collectives.TRAFFIC["all_reduce_calls"] / steps}


TP_MESH = (1, 2)       # (data, model): the two ranks of the phase
TP_TIMED_STEPS = 10    # TP train steps timed after the checked ones
TP_PROFILED_STEPS = 3  # TP train steps traced after the timed ones
TP_FWD_REL = 1e-5      # the TP eval forward against one process, of the largest |logit|
TP_LR = 1e-2           # SGD: a step's update is the gradient times the rate


def tp_step(model, batch: dict, optimizer, generator) -> torch.Tensor:
    """One SGD step of the full objective (CE on both heads plus the three
    InfoNCE terms); returns the loss."""
    optimizer.zero_grad()
    a, v, c1, c2, c3 = model(batch["eeg"], batch["eye"], batch["pps"],
                             labels=(batch["arousal"], batch["valence"], batch["mask"]),
                             generator=generator)
    loss = (masked_cross_entropy(a, batch["arousal"], batch["mask"])
            + masked_cross_entropy(v, batch["valence"], batch["mask"]) + c1 + c2 + c3)
    loss.backward()
    optimizer.step()
    return loss.detach()


def step_gap(got: dict, want: dict, init: dict) -> tuple[float, str, float, str]:
    """A stepped state against one process's: the largest ratio of a
    parameter's difference to the DP gradient check's bar on the updates
    (1e-5 of the tensor's largest update plus 1e-6 of the step's largest),
    and of a BatchNorm running stat's to 1e-5 of its largest entry; and
    where."""
    updates = {k: w - init[k] for k, w in want.items()
               if w.is_floating_point() and "running" not in k}
    top = max(float(u.abs().max()) for u in updates.values())
    worst, stats = (0.0, ""), (0.0, "")
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        diff = float((got[k].float() - w.float()).abs().max())
        if k in updates:
            bar = PARALLEL_GRAD_REL * float(updates[k].abs().max()) + PARALLEL_GRAD_TOP * top
            worst = max(worst, (diff / bar, k))
        else:
            stats = max(stats, (diff / (PARALLEL_GRAD_REL * float(w.abs().max())), k))
    return (*worst, *stats)


def tp_rank(mesh) -> dict:
    """One rank of tensor parallelism on a ``(data=1, model=2)`` mesh at
    full width (B=64, TF32 off), each check against the one-process model
    from the same seed, run beside it on this rank: the eval forward; one
    SGD step of the full objective at dropout 0 and one at the model's own
    dropout (0.4 / 0.3; the same dropout stream), with the TP step's
    launches; this rank's replicated parameters after them; then
    ``TP_TIMED_STEPS`` more TP steps, their ms/step and the bytes and calls
    each all-reduces; then :func:`tp_step_split`."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel import (collectives, gather_state_dict,
                                                                   make_mesh_2d,
                                                                   param_partition_specs,
                                                                   shard_by_specs)
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.dryrun import _example_batch
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.mesh import mesh_device, rank_seed
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.tp import DATA, MODEL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh_device(mesh)
    mesh2d = make_mesh_2d(*TP_MESH, device_type="cuda")
    batch = _example_batch(np.random.default_rng(SEED + 24), BATCH, device)
    seed = rank_seed(SEED + 5, mesh2d.get_local_rank(DATA))
    out = {"steps": {}, "index": mesh2d.get_local_rank(MODEL)}
    for label, dropout in (("dropout 0", 0.0), ("the model's dropout", None)):
        ref = MultimodalTransformerModel(device=device, dropout=dropout,
                                         generator=torch.Generator().manual_seed(SEED))
        sharded = shard_by_specs(mesh2d, ref, param_partition_specs(ref, TP_MESH[1]))
        init = {k: v.clone() for k, v in ref.state_dict().items()}
        if dropout == 0.0:
            ref.eval()
            sharded.eval()
            with torch.no_grad():
                want = ref(batch["eeg"], batch["eye"], batch["pps"])
                got = sharded(batch["eeg"], batch["eye"], batch["pps"])
            out["eval"] = max(float((g - w).abs().max()) / float(w.abs().max())
                              for g, w in zip(got, want))
        ref.train()
        sharded.train()
        ref_loss = tp_step(ref, batch, torch.optim.SGD(ref.parameters(), lr=TP_LR),
                           torch.Generator(device=device).manual_seed(seed))
        optimizer = torch.optim.SGD(sharded.parameters(), lr=TP_LR)
        generator = torch.Generator(device=device).manual_seed(seed)
        reset_launch_counts()
        loss = tp_step(sharded, batch, optimizer, generator)
        counts = launch_counts()
        gap = step_gap(gather_state_dict(sharded), ref.state_dict(), init)
        out["steps"][label] = {"loss": float(loss), "ref_loss": float(ref_loss), "gap": gap,
                               "counts": counts}
        out.setdefault("replicated", {}).update(
            {f"{label}: {k}": p.detach().cpu() for k, p in sharded.named_parameters()
             if not hasattr(p, "tp_axis")})
    collectives.reset_traffic()
    _, seconds = synced(lambda: [tp_step(sharded, batch, optimizer, generator)
                                 for _ in range(TP_TIMED_STEPS)])
    out["ms_step"] = seconds * 1e3 / TP_TIMED_STEPS
    out["bytes_step"] = collectives.TRAFFIC["all_reduce_bytes"] / TP_TIMED_STEPS
    out["calls_step"] = collectives.TRAFFIC["all_reduce_calls"] / TP_TIMED_STEPS
    out["split"] = tp_step_split(lambda: tp_step(sharded, batch, optimizer, generator))
    return out


def tp_step_split(step) -> dict:
    """``TP_PROFILED_STEPS`` TP steps under torch.profiler: their ms a step
    on the host clock, the device time of this process's launches, and the
    host time inside the all-reduces (the outermost profiler event whose
    name holds "allreduce": it includes the wait for the device work before
    each one, since gloo copies a CUDA tensor to the host)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds = synced(lambda: [step() for _ in range(TP_PROFILED_STEPS)])
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events if e.device_type.name == "CUDA")
    reduce = [e for e in events if e.device_type.name == "CPU"
              and "allreduce" in e.key.lower().replace("_", "")]
    outer = max(reduce, key=lambda e: e.cpu_time_total, default=None)
    return {"ms": seconds * 1e3 / TP_PROFILED_STEPS,
            "device_ms": device / 1e3 / TP_PROFILED_STEPS,
            "all_reduce_ms": 0.0 if outer is None else outer.cpu_time_total / 1e3
            / TP_PROFILED_STEPS,
            "all_reduce_event": None if outer is None else (outer.key, outer.count)}


def parallel_rank(mesh, arrays: dict) -> dict:
    """Everything one rank of the two-rank ``gloo`` run does."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.dryrun import dryrun_rank

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"loso": loso_rank_epoch(mesh, arrays), "dp": multitask_rank_epoch(mesh, arrays),
            "tp": tp_rank(mesh), "dryrun": dryrun_rank(mesh, print_lines=False)}


def tp_report(label: str, ranks: list, smi: str, total: dict) -> None:
    """The TP ranks' checks: forward and step gaps, launches, replicated
    parameters bit-equal across the model axis, ms/step and traffic."""
    for r, res in enumerate(ranks):
        check(res["eval"] <= TP_FWD_REL, f"{label} rank {r}: TP eval forward {res['eval']:.3e} "
              "of the largest |logit| from one process's")
        print(f"{label} rank {r} (model index {res['index']}): eval forward within "
              f"{res['eval']:.3e} of the largest |logit| of one process's (limit {TP_FWD_REL})")
        for step, got in res["steps"].items():
            add_counts(total, got["counts"])
            rows = rank_rows(f"{label} rank {r} {step}", got["counts"])
            loss_gap = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
            ratio, where, stats, stat_where = got["gap"]
            print(f"{label} rank {r} SGD step at {step}: loss {got['loss']:.6f}, "
                  f"{loss_gap:.3e} relative of one process's (limit {PARALLEL_DP_RTOL}); "
                  f"parameters: the largest difference {ratio:.3e} of its bar "
                  f"({PARALLEL_GRAD_REL} of the tensor's largest update + {PARALLEL_GRAD_TOP} of "
                  f"the step's), at {where}; BatchNorm running stats {stats:.3e} of "
                  f"{PARALLEL_GRAD_REL} of their largest entry, at {stat_where}; rows 1, 2, 9, "
                  f"11, 12, 13 launched {rows}")
            check(loss_gap <= PARALLEL_DP_RTOL and ratio <= 1.0 and stats <= 1.0,
                  f"{label} rank {r}: the TP step at {step} parts from one process's")
        print(f"{label} rank {r}: {TP_TIMED_STEPS} more TP steps at the model's dropout, "
              f"{res['ms_step']:.3f} ms/step; {res['bytes_step']:.0f} bytes all-reduced a step "
              f"in {res['calls_step']:.1f} calls ({smi}; "
              + ("two ranks share one card: not a scale-out figure)" if "gloo" in label
                 else "one card a rank)"))
        sp = res["split"]
        print(f"{label} rank {r}: {TP_PROFILED_STEPS} TP steps under torch.profiler, "
              f"{sp['ms']:.3f} ms/step on the host clock; this rank's device time "
              f"{sp['device_ms']:.3f} ms/step; host time in the all-reduces "
              f"{sp['all_reduce_ms']:.3f} ms/step (event {sp['all_reduce_event']}, the wait "
              f"for the device work before each included)")
    a, b = (res["replicated"] for res in ranks)
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    print(f"{label}: the {len(a) // 2} replicated parameters of each model after its step "
          f"{'bit-equal' if same else 'DIFFER'} on the two model ranks")
    check(same, f"{label}: replicated parameters differ across the model axis")


TP_STEM_STAGES = ((585, 64, 4), (146, 256, 2))  # (T, C, pool) of the stem's two stages


def stem_shard_check(device: torch.device, smi: str) -> None:
    """Rows 2 and 12 on a tensor-parallel rank's channel shard (the stem's
    two stages at B=64 split in two), each shard at p = DROPOUT_P: its keep
    bits (pool 1, its codes) against the unsharded layer's columns and the
    CPU Philox model's, bit for bit; at the stage's own pool, its pooled
    output and codes against the unsharded kernel's columns (bit for bit)
    and against the plain version fed the shard's CPU Philox mask (the
    output within row 2's tolerance, the codes equal but where two window
    entries tie within rounding, at most 1e-3 of them), and row 12 on the
    shard's own code against its plain version (dy and the summed partials
    within row 12's tolerance); then row 2's time at the shard width beside
    the full width's, each with its bytes bound (read conv and the four
    per-channel vectors once, write the pooled output and its codes once,
    at 3.35 TB/s)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    seeds = stem_seeds(1, device)
    fwd_tol, bwd_tol = TRAINING_KERNELS["stem_tail"][2], TRAINING_KERNELS["stem_tail_bwd"][2]
    for t, c, pool in TP_STEM_STAGES:
        shape, h = (BATCH, t, c), c // TP_MESH[1]
        conv = torch.randn(shape, device=device, generator=gen)
        gamma = 1.0 + 0.3 * torch.randn(c, device=device, generator=gen)
        beta = 0.1 * torch.randn(c, device=device, generator=gen)
        mean = conv.mean((0, 1))
        var = (conv * conv).mean((0, 1)) - mean * mean
        ones, zeros = torch.ones(c, device=device), torch.zeros(c, device=device)
        _, whole = conv_stem_train.stem_tail_fwd_seeded(conv, ones, zeros, zeros, ones,
                                                        DROPOUT_P, 1, seeds)
        whole_out, whole_code = conv_stem_train.stem_tail_fwd_seeded(
            conv, gamma, beta, mean, var, DROPOUT_P, pool, seeds)
        keep = keep_mask(seeds, shape).int()
        same = torch.equal(whole, keep)
        fwd_err = bwd_err = tied = 0.0
        for i in range(TP_MESH[1]):
            cols = slice(i * h, (i + 1) * h)
            x = conv[..., cols].contiguous()
            _, code = conv_stem_train.stem_tail_fwd_seeded(
                x, ones[:h], zeros[:h], zeros[:h], ones[:h], DROPOUT_P, 1, seeds,
                channels=(i * h, c))
            shard_keep = conv_stem_train.keep_mask_plain(seeds.cpu(), (BATCH, t, h), DROPOUT_P,
                                                         channels=(i * h, c)).to(device)
            same = (same and torch.equal(code, whole[..., cols])
                    and torch.equal(code, shard_keep.int()))
            bn = (gamma[cols].contiguous(), beta[cols].contiguous(), mean[cols].contiguous(),
                  var[cols].contiguous())
            out, code = conv_stem_train.stem_tail_fwd_seeded(x, *bn, DROPOUT_P, pool, seeds,
                                                             channels=(i * h, c))
            same = (same and torch.equal(out, whole_out[..., cols])
                    and torch.equal(code, whole_code[..., cols]))
            ref, ref_code = conv_stem_train.fused_stage_train_plain(
                x, *bn, pool, 1e-5, DROPOUT_P, shard_keep, with_code=True)
            fwd_err = max(fwd_err, float((out - ref).abs().max()))
            tied = max(tied, float((code != ref_code).double().mean()))
            inv = torch.rsqrt(bn[3] + 1e-5)
            scale = bn[0] * inv
            bwd_args = (x, torch.randn(out.shape, device=device, generator=gen), code, scale,
                        bn[1] - bn[2] * scale, bn[2], inv, DROPOUT_P, pool)
            dy, dg, db = conv_stem_train.stem_tail_bwd(*bwd_args)
            want = conv_stem_train.stem_tail_bwd_plain(*bwd_args)
            bwd_err = max(bwd_err, *(float((g - w).abs().max()) for g, w in
                                     zip((dy, dg.sum(0), db.sum(0)),
                                         (want[0], want[1].sum(0), want[2].sum(0)))))
        print(f"stem-tail keep mask {shape} split in {TP_MESH[1]} channel shards of {h}: each "
              f"shard's keep bits equal the unsharded layer's columns and the CPU Philox "
              f"model's, and at pool {pool} its output and codes the unsharded kernel's "
              f"columns, bit for bit: {same}")
        check(same, "stem-tail keep bits or outputs on a channel shard differ from the layer's")
        print(f"stem tail on the channel shards at pool {pool}: output max |err| {fwd_err:.3e} "
              f"of the plain version fed the shard's mask (limit {fwd_tol}), codes differing "
              f"{tied:.3e} (ties; limit 1e-3); row 12 on the shard's code: max |err| "
              f"{bwd_err:.3e} of its plain version (limit {bwd_tol})")
        check(fwd_err <= fwd_tol and tied <= 1e-3 and bwd_err <= bwd_tol,
              "rows 2 and 12 on a channel shard part from their plain versions")
        times = []
        for n, channels in ((c, None), (h, (h, c))):
            x = conv[..., :n].contiguous()
            ms = time_ms(lambda: conv_stem_train.stem_tail_fwd_seeded(
                x, gamma[:n], beta[:n], mean[:n], var[:n], DROPOUT_P, pool, seeds,
                channels=channels))
            moved = 4 * (BATCH * t * n + 4 * n + 2 * BATCH * (t // pool) * n)
            times.append(f"C={n}{' shard' if channels else ''} {ms:.4f} ms (bound "
                         f"{moved / 3.35e9:.4f} ms, {moved / 1e6:.2f} MB)")
        print(f"stem tail at B={BATCH} T={t} pool {pool} p {DROPOUT_P}, with codes: "
              + ", ".join(times) + f" ({smi})")


def rank_rows(label: str, counts: dict) -> dict:
    rows = {k: counts[k] for k in PARALLEL_ROWS}
    check(all(rows.values()), f"{label}: rows not launched on this rank: {rows}")
    return rows


def loso_gap(label: str, got: dict, want: dict, smi: str) -> None:
    """A sharded LOSO epoch's per-subject results against one process's."""
    gap = np.abs(got["epoch"]["loss"] - want["epoch"]["loss"]) / np.abs(want["epoch"]["loss"])
    same = all(np.array_equal(got[part][k], want[part][k])
               for part, keys in (("epoch", ("a_acc", "v_acc")), ("eval", ("a_acc", "v_acc")))
               for k in keys)
    print(f"{label}: per-subject losses within {gap.max():.3e} relative of one process's "
          f"(limit {PARALLEL_LOSS_RTOL}), accuracies {'equal' if same else 'DIFFER'} ({smi})")
    check(gap.max() <= PARALLEL_LOSS_RTOL and same, f"{label} parts from the one-process run")


def parallel_phase(full: DeviceDataset, smi: str) -> dict:
    """Subject sharding, batch data parallelism and tensor parallelism
    (``parallel/``) at full width: one NCCL rank in this process bit-equal
    to the unsharded trainer; two ``gloo`` ranks sharing card 0 (NCCL
    refuses two ranks on one device) for the subject-sharded LOSO epoch,
    ``MultiTaskTrainer(mesh=)``, the ``(data=1, model=2)`` TP checks
    (:func:`tp_rank`) and ``dryrun_multichip(2)``'s flavours; with two
    cards, the LOSO epoch and the TP checks over NCCL; row 2 on a channel
    shard (:func:`stem_shard_check`). Returns this process's launch counts
    plus the ranks'."""
    import torch.distributed as dist

    from multimodal_sentiment_aanalysis_tpu_torch.parallel import make_mesh
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.dryrun import spawn_ranks

    t0 = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    steps = -(-(N_SUBJECTS - 1) * EX_NUMS // BATCH)
    # 1. one NCCL rank in this process: the same program as the unsharded
    # trainer, so bit-equal (cuDNN's deterministic algorithms, as both run)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh(device_type="cuda")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"one-rank mesh: {dist.get_backend()} x {dist.get_world_size()}")
        runs = {}
        for label, kw in (("unsharded", {}), ("one NCCL rank", {"mesh": mesh})):
            vt = make_loso_trainer(full, dropout=0.0, early_stop=False, **kw)
            reset_launch_counts()
            tm = vt.train_epoch()
            counts = launch_counts()
            check(counts == launches(PER_STEP, steps), f"parallel {label}: launch counts {counts}")
            add_counts(total, counts)
            runs[label] = {"epoch": tm, "eval": vt.evaluate(), "params": vt.params.clone(),
                           "stats": vt.stats.clone()}
            reset_launch_counts()
            _, seconds = synced(vt.train_epoch)  # a second epoch, timed
            add_counts(total, launch_counts())
            print(f"parallel LOSO {label}: 24 models, host-plan epochs, the second "
                  f"{seconds * 1e3 / steps:.3f} ms/step ({smi})")
        dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    one, ref = runs["one NCCL rank"], runs["unsharded"]
    bit_equal = (all(np.array_equal(one[p][k], ref[p][k]) for p in ("epoch", "eval")
                     for k in ref[p])
                 and torch.equal(one["params"], ref["params"])
                 and torch.equal(one["stats"], ref["stats"]))
    print(f"parallel LOSO one NCCL rank against unsharded: losses, accuracies, parameters and "
          f"BatchNorm stats {'bit-equal' if bit_equal else 'DIFFER'}")
    check(bit_equal, "the one-rank NCCL mesh parts from the unsharded trainer")
    del runs, one
    gc.collect()
    torch.cuda.empty_cache()

    # the one-process MultiTaskTrainer epoch the two ranks are held to
    mt = make_multitask_trainer(full, fused=False, dropout=0.0)
    ref_grads = multitask_grads(mt)
    reset_launch_counts()
    mt_ref = mt.train_epoch_phase("fusion_arousal")
    mt_ref_state = {k: v.cpu() for k, v in mt.model.state_dict().items()}
    grad_bytes = sum(p.numel() * p.element_size() for p in mt.model.parameters())
    _, seconds = synced(lambda: mt.train_epoch_phase("fusion_arousal"))  # timed
    add_counts(total, launch_counts())
    print(f"parallel MultiTaskTrainer one process: fusion_arousal loss {mt_ref['loss']:.6f}; "
          f"a second epoch {seconds * 1e3 / steps:.3f} ms/step ({smi})")
    del mt
    gc.collect()
    torch.cuda.empty_cache()

    # 2. two gloo ranks on card 0
    arrays = {k: v.cpu().numpy() for k, v in full.arrays.items()}  # for the ranks to load
    t1 = time.perf_counter()
    ranks = spawn_ranks(parallel_rank, 2, (arrays,), backend="gloo", device_type="cuda",
                        timeout=PARALLEL_LIMIT, collective_timeout=120.0)
    print(f"parallel: two gloo ranks on card 0 started, ran and joined in "
          f"{time.perf_counter() - t1:.1f} s")
    for r, res in enumerate(ranks):
        for part in ("loso", "dp"):
            add_counts(total, res[part]["counts"])
            print(f"parallel rank {r} {part}: rows 1, 2, 9, 11, 12, 13 launched "
                  f"{rank_rows(f'rank {r} {part}', res[part]['counts'])}")
        print(f"parallel rank {r}: second epochs: LOSO {res['loso']['models']} models "
              f"{res['loso']['ms_step']:.3f} ms/step, MultiTaskTrainer "
              f"{res['dp']['ms_step']:.3f} ms/step ({smi}; two ranks share one card: not a "
              f"scale-out figure)")
    loso_gap("parallel LOSO two gloo ranks", ranks[0]["loso"], ref, smi)
    dp = ranks[0]["dp"]
    loss_gap = abs(dp["metrics"]["loss"] - mt_ref["loss"]) / abs(mt_ref["loss"])
    delta = max(float((dp["state"][k].float() - v.float()).abs().max())
                for k, v in mt_ref_state.items())
    same = all(torch.equal(ranks[1]["dp"]["state"][k], v) for k, v in dp["state"].items())
    print(f"parallel MultiTaskTrainer two gloo ranks: fusion_arousal loss "
          f"{dp['metrics']['loss']:.6f}, {loss_gap:.3e} relative of one process's (limit {PARALLEL_DP_RTOL}); largest "
          f"parameter difference {delta:.3e}; ranks' parameters "
          f"{'bit-equal' if same else 'DIFFER'}")
    check(loss_gap <= PARALLEL_DP_RTOL and same, "MultiTaskTrainer(mesh=) parts from one process")
    ratio, where = grad_gap(dp["grads"], ref_grads)
    print(f"parallel MultiTaskTrainer two gloo ranks: one eeg and one fusion_arousal step's "
          f"gradients ({BATCH} rows, {DP_GRAD_PAD} padding) summed over the ranks against one "
          f"process's: the largest difference {ratio:.3e} of its bar ({PARALLEL_GRAD_REL} of "
          f"the tensor's largest entry + {PARALLEL_GRAD_TOP} of the step's), at {where}")
    check(ratio <= 1.0, f"MultiTaskTrainer(mesh=) gradients part from one process's at {where}")
    print(f"parallel MultiTaskTrainer: {dp['bytes_step']:.0f} bytes all-reduced a step in "
          f"{dp['calls_step']:.1f} calls (the gradient row, at most {grad_bytes} bytes; the "
          f"BatchNorm sums and row counts; the gathered InfoNCE features, labels and mask)")
    tp_report("parallel TP (data=1, model=2) two gloo ranks", [res["tp"] for res in ranks], smi,
              total)
    for line in ranks[0]["dryrun"]:
        print(line)

    # 3. two cards over NCCL
    if torch.cuda.device_count() >= 2:
        nccl = spawn_ranks(loso_rank_epoch, 2, (arrays,), backend="nccl", device_type="cuda",
                           timeout=PARALLEL_LIMIT, collective_timeout=120.0)
        for r, res in enumerate(nccl):
            add_counts(total, res["counts"])
            rank_rows(f"NCCL rank {r}", res["counts"])
            print(f"parallel LOSO NCCL rank {r} of 2 cards: a second epoch "
                  f"{res['ms_step']:.3f} ms/step ({smi})")
        loso_gap("parallel LOSO two NCCL ranks on two cards", nccl[0], ref, smi)
        nccl_tp = spawn_ranks(tp_rank, 2, backend="nccl", device_type="cuda",
                              timeout=PARALLEL_LIMIT, collective_timeout=120.0)
        tp_report("parallel TP (data=1, model=2) two NCCL ranks on two cards", nccl_tp, smi,
                  total)
    else:
        print(f"parallel: the two-card NCCL runs (LOSO and TP) skipped: the machine has "
              f"{torch.cuda.device_count()} card")
    stem_shard_check(torch.device("cuda", 0), smi)
    print(f"parallel phase launches (this process and the ranks): "
          f"{({k: n for k, n in total.items() if n})}")
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s ({smi})")
    return total


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


def memhacl_bf16_phase(encoder, classifier, val: DeviceDataset) -> dict:
    """The ME-MHACL validation forward in bf16: the trained encoder and
    classifier cast to bf16, each validation batch through
    ``memhacl_logits`` (bf16 embeddings into the fused head's bf16 form),
    against the fp32 validation logits at the JAX package's bf16 bar.
    Returns the path's launch counts."""
    enc16, clf16 = copy.deepcopy(encoder).to(BF16), copy.deepcopy(classifier).to(BF16)
    idx, _ = val.epoch_plan(MEMHACL_BATCH, shuffle=False)
    batches = [val.gather(i) for i in idx]
    fp32 = [memhacl_logits(encoder, classifier, b["eeg"], b["eye"], b["pps"]) for b in batches]
    torch.cuda.synchronize()
    reset_launch_counts()
    lows = [memhacl_logits(enc16, clf16, b["eeg"].to(BF16), b["eye"].to(BF16), b["pps"].to(BF16))
            for b in batches]
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {name: 0 for name in KERNELS}
    expected["fusion_head_bf16"] = len(batches)
    print(f"ME-MHACL bf16 validation launches over {len(batches)} batches: {counts}")
    check(counts == expected, f"ME-MHACL bf16 launch counts {counts} != {expected}")
    excess, worst, agree = 0.0, 0.0, 1.0
    for head in (0, 1):
        lo = torch.cat([res[head] for res in lows])
        hi = torch.cat([res[head] for res in fp32])
        check(lo.dtype == BF16 and lo.shape == hi.shape and bool(torch.isfinite(lo).all()),
              "ME-MHACL bf16: logits not finite bf16")
        diff = (lo.float() - hi).abs()
        worst = max(worst, diff.max().item())
        excess = max(excess, (diff - SERVE_BF16_TOL * (1 + hi.abs())).max().item())
        agree = min(agree, (lo.argmax(-1) == hi.argmax(-1)).double().mean().item())
    print(f"ME-MHACL bf16 validation logits against fp32: max |diff| {worst:.3e}, within "
          f"rtol/atol {SERVE_BF16_TOL}: {excess <= 0}; argmax agreement {agree:.4f}")
    check(excess <= 0, "ME-MHACL bf16 validation disagrees with fp32")
    return counts


def memhacl_kernel_cases(encoder, classifier, val: DeviceDataset, cases: dict) -> None:
    """Adds the fused head at the validation batch (B=32) and at a ragged
    B=37, on the trained encoder's embeddings, in fp32 (also held to fp64:
    head_check) and in bf16 (embeddings and weights cast, against the plain
    version on the same bf16 values). Call under ``no_grad``."""
    encoder.eval()
    weights = fusion_head.head_weights(encoder.multihead_attn, classifier)
    for rows, what in ((MEMHACL_BATCH, "validation batch"), (37, "ragged")):
        batch = val.gather(np.arange(rows) % len(val))
        args = (*encoder.embed(batch["eeg"], batch["eye"], batch["pps"]), *weights)
        cases["fusion_head"].append((
            f"B={rows} F={MEMHACL_F} {what}",
            lambda a=args: fusion_head.fusion_head(*a, num_heads=MEMHACL_HEADS),
            lambda a=args: fusion_head.fusion_head_plain(*a, num_heads=MEMHACL_HEADS), args,
            lambda a=args: head_fp64(a)))
        low = tuple(t.to(BF16) for t in args)
        cases["fusion_head_bf16"].append((
            f"B={rows} F={MEMHACL_F} {what}",
            lambda a=low: fusion_head.fusion_head(*a, num_heads=MEMHACL_HEADS),
            lambda a=low: fusion_head.fusion_head_plain(*a, num_heads=MEMHACL_HEADS), low))


def head_fp64(args) -> tuple[tuple, tuple]:
    """A fused-head case's logits in fp64 on the same inputs, and in fp64 on
    its inputs rounded to TF32 (what one TF32 pass computes at best)."""
    return (fusion_head.fusion_head_plain(*(t.double() for t in args), num_heads=MEMHACL_HEADS),
            fusion_head.fusion_head_plain(*(tf32_round(t).double() for t in args),
                                          num_heads=MEMHACL_HEADS))


def head_check(name: str, label: str, got, ref, one_pass) -> None:
    """Holds one fused-head case to HEAD_FP64_REL of its largest fp64
    |logit|, a bar the TF32-rounded inputs must miss."""
    scale = max(r.abs().max().item() for r in ref)
    err, err_tf32 = (max((g.double() - r).abs().max().item() for g, r in zip(v, ref))
                     for v in (got, one_pass))
    print(f"{name} {label}: against fp64, max |logit| {scale:.4g}; kernel {err:.3e} "
          f"({err / scale:.2e} of it), one TF32 pass {err_tf32:.3e} ({err_tf32 / scale:.2e}); "
          f"bar {HEAD_FP64_REL:.0e} of max |logit|")
    check(err <= HEAD_FP64_REL * scale, f"{name} {label}: {err:.3e} from fp64")
    check(err_tf32 > HEAD_FP64_REL * scale,
          f"{name} {label}: one TF32 pass ({err_tf32:.3e}) would meet the bar")


def head_ops_ms(name: str, args) -> float:
    """The least time for a fused-head case's operations: the in, out and
    shared projections on the tensor cores as the kernel takes them (fp32:
    three TF32 passes each; bf16: the in projection one bf16 pass, the
    others two TF32 passes on the fp32 intermediates), the attention and
    the two heads at the fp32 rate."""
    x, hidden, ncls = args[0], args[7].shape[0], args[9].shape[0]
    bsz, f = x.shape
    macs_in, macs_rest = bsz * 9 * f * f, bsz * (3 * f * f + f * hidden)
    if name.endswith("_bf16"):
        dots = 2 * macs_in / PEAK_BF16_FLOPS + 2 * 2 * macs_rest / PEAK_TF32_FLOPS
    else:
        dots = 3 * 2 * (macs_in + macs_rest) / PEAK_TF32_FLOPS
    return (dots + bsz * (36 * f + 4 * hidden * ncls) / PEAK_FP32_FLOPS) * 1e3


# --------------------------------------------------------------------------
# attention over a long sequence: the flash kernels
# --------------------------------------------------------------------------


def attention_step(m: MultiheadAttention, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One self-attention forward of ``m`` over ``x`` and the backward of
    the sum of its squares (in fp32): the output and the named gradients."""
    x = x.detach().requires_grad_()
    y = m(x, x, x)
    (y.float() * y.float()).sum().backward()
    grads = {"input": x.grad, **{n: p.grad for n, p in m.named_parameters()}}
    m.zero_grad()
    return y.detach(), grads


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

    attention_step(card, x_card)  # warm-up: first launches, cuBLAS handles
    reset_launch_counts()
    (y, grads), seconds = synced(lambda: attention_step(card, x_card))
    counts = launch_counts()
    print(f"attention: MultiheadAttention({ATTN_E}, {ATTN_HEADS}) self-attention, B={ATTN_B}, "
          f"T={ATTN_T}, forward + backward {seconds * 1e3:.3f} ms (host clock around a "
          f"synchronised run); launches {counts}")
    expected = {name: 0 for name in KERNELS}
    expected.update(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    check(counts == expected, f"attention launch counts {counts} != {expected}")
    y_cpu, g_cpu = attention_step(cpu, x)
    out_err = (y.cpu() - y_cpu).abs().max().item()
    worst, worst_name, outliers, outlier_name = grad_agreement(grads, g_cpu)
    print(f"attention card vs CPU plain path: outputs max |diff| {out_err:.3e} (limit "
          f"{PATH_ATOL}); {len(g_cpu)} gradients, worst scaled |diff| {worst:.3e} at "
          f"{worst_name}; largest share above {GRAD_RTOL}: {outliers:.3e}"
          f"{' at ' + outlier_name if outlier_name else ''} (limit {GRAD_OUTLIERS})")
    check(bool(torch.isfinite(y).all()) and out_err <= PATH_ATOL and outliers <= GRAD_OUTLIERS,
          "attention on the card disagrees with the CPU")
    return counts, card, x_card


def largest_gap(got: dict, want: dict) -> tuple[float, str]:
    """The largest ``max |got - want|`` over ``max |want|`` of named
    tensors, and its name."""
    gaps = {n: ((got[n].double().cpu() - w.double().cpu()).abs().max()
                / w.double().abs().max()).item() for n, w in want.items()}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def attention_bf16_phase(mha: MultiheadAttention,
                         x: torch.Tensor) -> tuple[dict, MultiheadAttention, torch.Tensor]:
    """The attention phase's module and input cast to bf16, forward and
    backward through the flash kernels' bf16 forms: one launch of each and
    no other kernel; the output and every gradient against the same bf16
    module on the CPU (the bf16 plain path) and against the fp32 module on
    the card. Returns the launch counts, the bf16 module and its input."""
    t0 = time.perf_counter()
    y32, g32 = attention_step(mha, x)  # the fp32 run, outside the counted window
    card = copy.deepcopy(mha).to(BF16)
    x16 = x.to(BF16)
    attention_step(card, x16)  # warm-up: first launches
    reset_launch_counts()
    (y, grads), seconds = synced(lambda: attention_step(card, x16))
    counts = launch_counts()
    print(f"attention_bf16: MultiheadAttention({ATTN_E}, {ATTN_HEADS}) in bf16, B={ATTN_B}, "
          f"T={ATTN_T}, forward + backward {seconds * 1e3:.3f} ms (host clock around a "
          f"synchronised run); launches {counts}")
    expected = {name: 0 for name in KERNELS}
    expected.update(flash_fwd_bf16=1, flash_bwd_dq_bf16=1, flash_bwd_dkv_bf16=1)
    check(counts == expected, f"attention_bf16 launch counts {counts} != {expected}")
    check(y.dtype == BF16 and all(g.dtype == BF16 for g in grads.values()),
          "attention_bf16: an output or gradient is not bf16")
    check(bool(torch.isfinite(y).all()) and all(bool(torch.isfinite(g).all())
                                                for g in grads.values()),
          "attention_bf16: a non-finite output or gradient")
    y_cpu, g_cpu = attention_step(copy.deepcopy(card).cpu(), x16.cpu())
    cpu_gap = largest_gap({"output": y, **grads}, {"output": y_cpu, **g_cpu})
    fp32_gap = largest_gap({"output": y, **grads}, {"output": y32, **g32})
    print(f"attention_bf16 card vs CPU bf16 plain path: largest max |diff| over max |CPU| "
          f"{cpu_gap[0]:.3e} at {cpu_gap[1]} (limit {ATTN_BF16_CPU_REL}); against the fp32 "
          f"module on the card {fp32_gap[0]:.3e} at {fp32_gap[1]} (limit {ATTN_BF16_FP32_REL}); "
          f"phase {time.perf_counter() - t0:.1f} s")
    check(cpu_gap[0] <= ATTN_BF16_CPU_REL, "attention_bf16 on the card disagrees with the CPU")
    check(fp32_gap[0] <= ATTN_BF16_FP32_REL, "attention_bf16 disagrees with fp32")
    return counts, card, x16


def attention_kernel_cases(mha: MultiheadAttention, x: torch.Tensor, gen: torch.Generator,
                           cases: dict) -> None:
    """Adds the three flash kernels at the attention phase's own q, k, v
    (B H = 512, T = 585, Dh = 32), at 200 queries over 100 keys and at 9
    rows, seeded; each case also with its fp64 outputs (flash_check), the
    backward's with their scales. A bf16 module and input give the bf16
    forms' cases (``q`` scaled in bf16, as ``flash_mha`` scales it). Call
    under ``no_grad``."""
    dh = ATTN_E // ATTN_HEADS
    bh = ATTN_B * ATTN_HEADS
    bf16 = x.dtype == BF16
    sfx = "_bf16" if bf16 else ""

    def heads(t):
        return t.reshape(ATTN_B, ATTN_T, ATTN_HEADS, dh).transpose(1, 2).reshape(
            bh, ATTN_T, dh).contiguous()

    w, b = mha.in_proj_weight.chunk(3), mha.in_proj_bias.chunk(3)
    q, k, v = (heads(F.linear(x, wi, bi)) for wi, bi in zip(w, b))
    randn = lambda *shape: torch.randn(shape, device=x.device, generator=gen).to(x.dtype)
    scale = attention.scale_q if bf16 else lambda t: t / math.sqrt(dh)
    shapes = [(f"MHA self-attention {tuple(q.shape)}", scale(q), k, v)]
    for tq, tk in ((200, 100), (9, 9)):
        shapes.append((f"({bh}, {tq} q / {tk} k, {dh})", scale(randn(bh, tq, dh)),
                       randn(bh, tk, dh), randn(bh, tk, dh)))
    for label, q, k, v in shapes:
        o, lse = attention.flash_fwd_plain(q, k, v)
        do = randn(*q.shape)
        fwd_args = (q, k, v)
        bwd_args = (q, k, v, do, lse, attention.flash_delta(do, o))
        cases["flash_fwd" + sfx].append((
            label, lambda a=fwd_args: attention.flash_fwd(*a),
            lambda a=fwd_args: attention.flash_fwd_plain(*a), fwd_args,
            lambda a=fwd_args: (attention.flash_fwd_plain(*(t.double() for t in a)),)))
        cases["flash_bwd_dq" + sfx].append((
            label, lambda a=bwd_args: attention.flash_bwd_dq(*a),
            lambda a=bwd_args: attention.flash_bwd_dq_plain(*a), bwd_args,
            lambda a=bwd_args: flash_bwd_fp64("dq", a)))
        cases["flash_bwd_dkv" + sfx].append((
            label, lambda a=bwd_args: attention.flash_bwd_dkv(*a),
            lambda a=bwd_args: attention.flash_bwd_dkv_plain(*a), bwd_args,
            lambda a=bwd_args: flash_bwd_fp64("dkv", a)))


def flash_bf16_bit_equal(cases: dict) -> None:
    """Runs each bf16 forward and backward case twice and holds the two
    results bit for bit: one CTA owns each output and sums it in one order,
    no atomics. Launched after the counted phases, so the counts do not
    move."""
    for name in ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"):
        for label, kern, *_ in cases[name]:
            first, second = outputs(name, kern()), outputs(name, kern())
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            print(f"{name} {label}: two runs bit-equal: {same}")
            check(same, f"{name} {label}: two runs differ")


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


def time_ms(fn, calls: int = TIMED_CALLS) -> float:
    for _ in range(min(3, calls)):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


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
    name = name.removesuffix("_bf16").removesuffix("_f64")
    t = tensors(args)
    if name == "bilstm_gemm":
        # 2MNK per product and pass: three TF32 passes for fp32 x fp32
        # (fp32-accurate), two for bf16 x fp32 dgates (dx, dW_cat), one bf16
        # pass for bf16 x bf16 (proj, gates; peak_rate takes the bf16 rate)
        mode = args[0]
        passes = (1 if mode in ("proj", "gates", "gates_xp") else 2) if bf16 else 3
        x = t[0]
        if mode == "gates_xp":  # h_prev W_hh^T, then xp added and the activations
            xp, _, w_hh = t
            rows, g = xp.numel() // xp.shape[-1], xp.shape[-1]
            return passes * 2 * rows * g * w_hh.shape[-1] + 5 * rows * g
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
    if name == "sos_filtfilt":
        # per section and sample, y = b0 x + z0 (2), z0 = b1 x - a1 y + z1
        # (4), z1 = b2 x - a2 y (3); the forward pass over the L = T + 2
        # padlen samples of the odd extension, the reverse pass over the
        # L - padlen samples that reach an output
        x, sos = t[0], t[1]
        n, steps = x.shape
        padlen = args[3]
        return 9 * sos.shape[0] * n * (2 * (steps + 2 * padlen) - padlen)
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


def infonce_rows_plain(n1, n2, labels, valid, temp) -> torch.Tensor:
    """``contrastive.infonce_plain`` on rows shared by groups of problems
    (``labels (Q, B)``, Q dividing P, as ``contrastive.infonce`` takes them),
    repeated per problem."""
    per = lambda t: t.repeat_interleave(n1.shape[0] // temp.shape[0], 0)
    return contrastive.infonce_plain(n1, n2, per(labels), per(valid), per(temp))


def infonce_fp64(args) -> tuple[torch.Tensor, torch.Tensor]:
    """A row-13 case's losses in fp64 on the same inputs, and in fp64 on its
    features rounded to TF32 (what one TF32 pass computes at best; a bf16
    feature is exact in TF32)."""
    n1, n2, labels, valid, temp = args
    rest = (labels, valid.double(), temp.double())
    return (infonce_rows_plain(n1.double(), n2.double(), *rest),
            infonce_rows_plain(tf32_round(n1).double(), tf32_round(n2).double(), *rest))


def infonce_check(name: str, label: str, got, ref, one_pass) -> None:
    """Holds one row-13 case to INFONCE_FP64_REL of each fp64 loss; in fp32
    the bar must also be one that one TF32 pass misses."""
    err, err_tf32 = (((v.double() - ref).abs() / ref.abs()).max().item() for v in (got, one_pass))
    print(f"{name} {label}: against fp64, losses {ref.min().item():.4g}..{ref.max().item():.4g}; "
          f"kernel {err:.3e} of the loss, one TF32 pass {err_tf32:.3e}; bar "
          f"{INFONCE_FP64_REL:.0e} of each loss")
    check(err <= INFONCE_FP64_REL, f"{name} {label}: {err:.3e} of a loss from fp64")
    check(name.endswith("_bf16") or err_tf32 > INFONCE_FP64_REL,
          f"{name} {label}: one TF32 pass ({err_tf32:.3e}) would meet the bar")


def infonce_ops_ms(name: str, args) -> float:
    """The least time for a row-13 case's operations: its similarity products
    as three TF32 passes at the TF32 rate (one bf16 pass at the bf16 rate in
    the bf16 form), and ~6 fp32 operations a score (the division, mask, max,
    exp and the two sums) at the fp32 rate."""
    n1 = tensors(args)[0]
    p, b, d = n1.shape
    scores = p * b * b
    dots = (2 * scores * d / PEAK_BF16_FLOPS if name.endswith("_bf16")
            else 3 * 2 * scores * d / PEAK_TF32_FLOPS)
    return (dots + 6 * scores / PEAK_FP32_FLOPS) * 1e3


FLASH_OUTPUTS = {"flash_fwd": ("O", "LSE"), "flash_bwd_dq": ("dQ",),
                 "flash_bwd_dkv": ("dK", "dV")}


def flash_check(name: str, label: str, got, ref, scales=None) -> None:
    """Holds one flash case's outputs to FLASH_FP64_REL (a bf16 form's to
    FLASH_BF16_FP64_REL) of their fp64 scale: the forward's O and LSE of
    their largest entry, the backward's of ``scales``
    (attention.flash_bwd_magnitudes)."""
    bf16 = name.endswith("_bf16")
    for i, (what, g, r) in enumerate(zip(FLASH_OUTPUTS[name.removesuffix("_bf16")], got, ref)):
        largest = r.abs().max().item()
        scale = largest if scales is None else scales[i].item()
        err = (g.double() - r).abs().max().item()
        bar = FLASH_BF16_FP64_REL[what] if bf16 else FLASH_FP64_REL
        print(f"{name} {label}: {what} against fp64, max |ref| {largest:.4g}, scale "
              f"{scale:.4g}; kernel {err:.3e} ({err / scale:.2e} of the scale, "
              f"{err / largest:.2e} of max |ref|); bar {bar:.0e} of the scale")
        check(err <= bar * scale, f"{name} {label}: {what} {err:.3e} from fp64 > {bar * scale:.3e}")


def conv_check(label: str, got, ref) -> None:
    """Holds one conv-stem case to CONV_FP64_REL of its largest fp64
    entry (the plain version in fp64, cuDNN's conv with TF32 off)."""
    largest = ref.abs().max().item()
    err = (got.double() - ref).abs().max().item()
    print(f"conv_stem {label}: against fp64, max |ref| {largest:.4g}; kernel {err:.3e} "
          f"({err / largest:.2e} of it); bar {CONV_FP64_REL:.0e} of max |ref|")
    check(err <= CONV_FP64_REL * largest,
          f"conv_stem {label}: {err:.3e} from fp64 > {CONV_FP64_REL * largest:.3e}")


def conv_ops_ms(args) -> float:
    """The least time for a conv-stem case's operations: its products as
    three TF32 passes on the tensor cores, fp32-accurate as the kernel runs
    them, and the epilogue's 12 operations an output position and channel
    (folded BN, GELU, the pool's compare) at the fp32 rate."""
    x, w = tensors(args)[:2]
    out = x.shape[0] * x.shape[1] * w.shape[0]
    return (3 * 2 * out * w.shape[1] * w.shape[2] / PEAK_TF32_FLOPS
            + 12 * out / PEAK_FP32_FLOPS) * 1e3


def flash_ops_ms(name: str, args) -> float:
    """The least time for a flash case's operations: its products (two in
    the forward, three for dQ, four for dK/dV) as three TF32 passes on the
    tensor cores, fp32-accurate as the kernels run them (one bf16 pass at
    the bf16 rate in the bf16 forms), and the softmax's elementwise work (4
    operations a score) on the fp32 CUDA cores."""
    q, k = tensors(args)[:2]
    scores = q.shape[0] * q.shape[1] * k.shape[1]
    per = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}[name.removesuffix("_bf16")]
    dots = (per * scores * q.shape[2] / PEAK_BF16_FLOPS if name.endswith("_bf16")
            else 3 * per * scores * q.shape[2] / PEAK_TF32_FLOPS)
    return (dots + 4 * scores / PEAK_FP32_FLOPS) * 1e3


def flash_form(m) -> str:
    """A flash kernel's instantiation (head dim D, streamed tile)."""
    tile = "kBq" if "dkv" in m.group(1) else "kBk"
    return f"{m.group(1)}<D={m.group(2)}, {tile}={m.group(3)}>"


FLASH_FORMS = (r"\d(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_bf16)?_kernel)ILi(\d+)ELi(\d+)E", flash_form)
# rows 2 and 3: the stem tail's forward per element type and access
# (16-byte vectors or scalars), and the conv stem's one kernel
STEM_FORMS = (r"(stem_tail_fwd_kernel)I(f|13__nv_bfloat16)Lb([01])E|(conv_stem_kernel)",
              lambda m: m.group(4) or (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}"
                                       f", {'vector' if m.group(3) == '1' else 'scalar'}>"))
# row 12: the stem tail's backward per element type, access and pool (2, 4,
# or 0: any other, one cell at a time)
STEM_BWD_FORMS = (r"(stem_tail_bwd_kernel)I(f|13__nv_bfloat16)Lb([01])ELi(\d)E",
                  lambda m: (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}, "
                             f"{'vector' if m.group(3) == '1' else 'scalar'}, pool "
                             f"{m.group(4) if m.group(4) != '0' else 'any'}>"))
# row 17: the fused head per element type and n8 tiles a warp
HEAD_FORMS = (r"(fusion_head_kernel)I(f|13__nv_bfloat16)Li(\d)E",
              lambda m: f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}, "
                        f"kNt={m.group(3)}>")
# the filter: fp32 and fp64 forms per number of sections (1 to 8)
IIR_FORMS = (r"(sos_filtfilt_kernel)I([fd])Li(\d)E",
             lambda m: f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}, "
                       f"S={m.group(3)}>")


def ptxas_registers(report: str, forms: tuple) -> list[str]:
    """One line per kernel instantiation that ``forms`` (a regex on the
    mangled name, and the instantiation's name from its match) picks from
    ptxas's report: its registers and spills."""
    pattern, form = forms
    lines, kernel = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for \S*?(?:" + pattern + ")", line)
        if m:
            kernel = form(m)
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
    activations (6H of each row's 8H); the stem tail's keep mask (a bool
    tensor) is the plain version's input only: the kernel draws it."""
    ins = [t for t in tensors(args) if t.dtype != torch.bool]
    nbytes = sum(x.numel() * x.element_size() for x in ins + tensors(res))
    if name == "bilstm_cscan":
        nbytes -= ins[0].numel() * ins[0].element_size() // 4
    return nbytes


def peak_rate(name: str, args) -> float:
    """The card's peak rate for the type of one case's operations: the
    recurrence (row 1's piece, and row 4, which is that piece storing c), the
    sweep and the c scan compute in fp32 in both forms; the GEMM's
    bf16 x bf16 products (the bf16 form's proj, gates and gates_xp) at the
    bf16 rate, its products with an fp32 operand at the TF32 rate, counted per pass
    (:func:`operations`); any other bf16 form at the bf16 rate."""
    if name.startswith(("bilstm_rec", "bilstm_sweep", "bilstm_cscan", "bilstm_fwd_xp")):
        return PEAK_FP32_FLOPS
    if name.endswith("_f64"):
        return PEAK_FP64_FLOPS
    if name.startswith("bilstm_gemm"):
        bf16_only = name.endswith("_bf16") and args[0] in ("proj", "gates", "gates_xp")
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
        elif exact and name == "conv_stem":
            conv_check(label, got[0], exact[0]())
        elif exact and name.startswith("infonce"):
            infonce_check(name, label, got[0], *exact[0]())
        elif exact and name.startswith("fusion_head"):
            head_check(name, label, got, *exact[0]())
        elif exact:
            gemm_check(name, label, args[0], got[0], want[0], *exact[0]())
        diffs = [(g.double() - w.double()).abs() for g, w in zip(got, want)]
        e = max(d.max().item() for d in diffs)
        atol = tol * max(w.abs().max().item() for w in want) if name in RELATIVE_TOL else tol
        ok = all(bool((d <= atol + (BF16_RTOL if w.dtype == BF16 else 0.0) * w.float().abs()).all())
                 for d, w in zip(diffs, want))
        limit = (f"{atol:.3e} ({tol} of the max |y|)" if name in RELATIVE_TOL else
                 f"{tol}{' + 1 ulp' if any(w.dtype == BF16 for w in want) else ''}")
        check(ok, f"{name} {label}: max |err| {e:.3e} > {limit}")
        nbytes = moved_bytes(name, args, res)
        ops_ms = (flash_ops_ms(name, args) if name.startswith("flash")
                  else conv_ops_ms(args) if name == "conv_stem"
                  else infonce_ops_ms(name, args) if name.startswith("infonce")
                  else head_ops_ms(name, args) if name.startswith("fusion_head")
                  else operations(name, args, res) / peak_rate(name, args) * 1e3)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        tk, tp = time_ms(kern), time_ms(plain, PLAIN_CALLS.get(name, TIMED_CALLS))
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
    for sfx in ("", "_bf16"):
        for label, (dq_ms, sdpa_dq) in case_ms["flash_bwd_dq" + sfx].items():
            dkv_ms, sdpa_dkv = case_ms["flash_bwd_dkv" + sfx][label]
            print(f"flash backward{sfx.replace('_', ' ')} {label}: dQ {dq_ms:.4f} + dK/dV "
                  f"{dkv_ms:.4f} = {dq_ms + dkv_ms:.4f} ms; SDPA's backward {sdpa_dq:.4f} / "
                  f"{sdpa_dkv:.4f} ms (timed beside dQ / dK/dV); pair over SDPA "
                  f"{(dq_ms + dkv_ms) / sdpa_dq:.3f}")
    unlaunched = [name for name, entry in results.items() if not entry["launches"]]
    check(not unlaunched, f"kernels no path launched: {unlaunched}")
    return list(results.values())


def profile_window(label: str, fn, top: int = 25, show: tuple[str, ...] = (),
                   share: str | None = None) -> None:
    """Device time by kernel over ``fn()`` under torch.profiler, against the
    host clock of the same window: the ``top`` kernels, every kernel whose
    name holds one of ``show``, and the share of the device time of the
    kernels whose name holds ``share``."""
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
    if share:
        part = [e for e in events if share in e.key]
        ms = sum(e.self_device_time_total for e in part) / 1e3
        print(f"profile {label}: {share} {ms:.3f} ms of the device time over "
              f"{sum(e.count for e in part)} launches, {100 * ms / (total / 1e3):.2f}%")


def host_device_split(name: str, items: list, kernel: str, calls: int = 100) -> None:
    """Cases of row 2, 12, 13 or 17, or of rows 14-16 in bf16, split into host
    and device time: per call, the
    CUDA-event time (as the kernel lines time it), the wrapper's host time
    (``perf_counter`` over ``calls`` calls with no sync inside), and under
    torch.profiler the device time of the kernel (device kernels whose name
    holds ``kernel``) and of every other launch the call makes."""
    from torch.profiler import ProfilerActivity, profile

    for label, kern, *_ in items:
        events_ms = time_ms(kern)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            kern()
        host_us = (time.perf_counter() - start) * 1e6 / calls
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                kern()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        kernel_us = sum(e.self_device_time_total for e in device if kernel in e.key)
        other_us = sum(e.self_device_time_total for e in device) - kernel_us
        print(f"{name} split {label}: {events_ms:.4f} ms by CUDA events; host "
              f"{host_us:.1f} us/call; device {kernel_us / calls:.2f} us/call in the kernel, "
              f"{other_us / calls:.2f} us/call in other launches")


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
    with ThreadPoolExecutor(max_workers=7) as pool:  # beside the builds, seven nvcc more
        reports = {name: pool.submit(ptxas_report, name)
                   for name in ("flash_attn", "flash_attn_bf16", "flash_bwd_bf16", "stem_tail",
                                "conv_stem", "fusion_head", "iir")}
        libs = build_all()
        registers = ptxas_registers(reports["flash_attn"].result(), FLASH_FORMS)
        bf16_registers = ptxas_registers(reports["flash_attn_bf16"].result()
                                         + reports["flash_bwd_bf16"].result(), FLASH_FORMS)
        stem_registers = ptxas_registers(reports["stem_tail"].result()
                                         + reports["conv_stem"].result(), STEM_FORMS)
        bwd_registers = ptxas_registers(reports["stem_tail"].result(), STEM_BWD_FORMS)
        head_registers = ptxas_registers(reports["fusion_head"].result(), HEAD_FORMS)
        iir_registers = ptxas_registers(reports["iir"].result(), IIR_FORMS)
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
    # the bf16 forms: each kernel at every head dim (16 to 128) and tile
    bf16_forms = 3 * tiles * len(attention.BF16_HEAD_DIMS)
    check(len(bf16_registers) == bf16_forms,
          f"ptxas reported {len(bf16_registers)} of {bf16_forms} bf16 flash kernels")
    for line in bf16_registers:
        print(f"ptxas {line}")
    # every bf16 form keeps its working set in registers, D = 128 included
    spilling = [line for line in bf16_registers
                if not line.endswith(", 0 bytes spill stores, 0 bytes spill loads")]
    check(not spilling, f"bf16 flash forms spill: {spilling}")
    # rows 2 and 3: four forms of the stem tail's forward, one conv stem
    check(len(stem_registers) == 5, f"ptxas reported {len(stem_registers)} of 5 stem forms")
    # rows 12 and 17: twelve forms of the stem tail's backward, eight of the
    # head (fp32 and bf16, 1, 2, 4 or 8 n8 tiles a warp)
    check(len(bwd_registers) == 12 and len(head_registers) == 8,
          f"ptxas reported {len(bwd_registers)} of 12 stem backward forms and "
          f"{len(head_registers)} of 8 head forms")
    for line in stem_registers + bwd_registers + head_registers:
        print(f"ptxas {line}")
    # the filter: 1 to 8 sections in fp32 and fp64, none spilling
    check(len(iir_registers) == 2 * iir.MAX_SECTIONS,
          f"ptxas reported {len(iir_registers)} of {2 * iir.MAX_SECTIONS} filter forms")
    for line in iir_registers:
        print(f"ptxas {line}")
    spilling = [line for line in iir_registers
                if not line.endswith(", 0 bytes spill stores, 0 bytes spill loads")]
    check(not spilling, f"filter forms spill: {spilling}")

    dsp_counts, raw_eeg = dsp_phase(device, smi)
    model, first, serve_counts, (pool, plan, serve_outs) = serving_phase(device)
    fp32_logits = serve_outs["serving"]
    serve_bf16_counts, bf16_logits = serving_bf16_phase(model, pool, plan, fp32_logits)
    serve_v5_counts, v5_logits = serving_v5_phase(model, pool, plan, fp32_logits)
    serve_bf16_v5_counts, _ = serving_bf16_phase(model, pool, plan, fp32_logits, "v5")
    export_counts = export_phase(model, pool, plan, {
        "fixed64_use_pallas": serve_outs["serving_use_pallas"], "poly_fp32": fp32_logits,
        "poly_bf16": bf16_logits, "fixed64_v5": v5_logits}, smi)
    quantized_counts = quantized_phase(model, pool, plan, fp32_logits, smi)
    full = hci_dataset(device)
    trainer = make_trainer(full)
    train_counts = training_phase(trainer)
    idx, mask = trainer.train_data.epoch_plan(BATCH, np.random.default_rng(SEED + 2))
    batch, mask = trainer.train_data.gather(idx[0]), mask[0]
    gradient_parity(trainer, batch, mask)
    vt = make_loso_trainer(full)
    loso = loso_phase(vt)
    loso_step_parity(full)
    schedule_counts, schedule_losses = loso_schedules_phase(full)
    bf16_schedule_counts = loso_bf16_schedules_phase(full, schedule_losses)
    schedule_gradient_parity(full)
    loso_bf16_counts, vt16 = loso_bf16_phase(full, loso)
    b512_counts = loso_b512_phase(full)
    phased_counts, vp, mt = phased_phase(full, args.profile)
    simclr_counts = simclr_phase(full, args.profile)
    memhacl_counts, (encoder, projector, classifier), (emotion, train, val) = memhacl_phase(
        device)
    memhacl_bf16_counts = memhacl_bf16_phase(encoder, classifier, val)
    attention_counts, mha, x_attn = attention_phase(device)
    attention_bf16_counts, mha16, x_attn16 = attention_bf16_phase(mha, x_attn)
    checkpoint_counts = checkpoints_phase(trainer, vt, vp, mt, full, smi)
    del vp, mt
    cli_counts = cli_phase(device, smi)
    parallel_counts = parallel_phase(full, smi)
    if args.profile:
        profile_window("train epoch", lambda: trainer.train_epoch(EPOCHS + 1), show=("cscan",))
        profile_window("LOSO train epoch", vt.train_epoch, top=30, show=("cscan", "stem_tail"),
                       share="stem_tail")
        profile_window("LOSO bf16 train epoch", vt16.train_epoch, top=30, show=("cscan",))
        for schedule in ("v5", "v6", "v8", "v9.1"):  # the other schedules
            vts = make_loso_trainer(full, lstm_schedule=schedule)
            vts.train_epoch()  # warm-up: first launches, cuBLAS handles
            profile_window(f"LOSO {schedule} train epoch", vts.train_epoch, top=30)
            del vts
        profile_window("ME-MHACL pretrain epoch", lambda: memhacl_pretrain(
            encoder, projector, emotion, num_epochs=1, batch_size=MEMHACL_BATCH, verbose=False))
        profile_window("ME-MHACL finetune epoch", lambda: memhacl_finetune(
            encoder, None, classifier, train, val, num_epochs=1, batch_size=MEMHACL_BATCH,
            verbose=False), show=("fusion_head",))

    phases = (serve_counts, serve_bf16_counts, serve_v5_counts, serve_bf16_v5_counts,
              export_counts, quantized_counts, train_counts, loso["counts"],
              schedule_counts, bf16_schedule_counts, loso_bf16_counts, b512_counts, phased_counts, simclr_counts,
              memhacl_counts, memhacl_bf16_counts, attention_counts, attention_bf16_counts,
              checkpoint_counts,
              cli_counts, dsp_counts, parallel_counts)
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
    attention_kernel_cases(mha16, x_attn16, gen, cases)
    flash_bf16_bit_equal(cases)
    dsp_kernel_cases(raw_eeg, cases)
    dropout_check(trainer.model, batch, gen)
    mask_check(vt, gen)
    # the bf16 forms: the eval model forward cast to bf16, the bf16 LOSO step
    serving_kernel_cases(copy.deepcopy(model).to(BF16), first["eeg"].to(BF16), cases)
    loso_cases.update(loso_kernel_cases(vt16, gen, one_model=cases))
    schedule_kernel_cases(vt16, gen, cases, loso_cases)
    for name in ("stem_tail", "stem_tail_bf16"):
        host_device_split(name, cases[name], "stem_tail_fwd")
    # row 13: the tile kernel against the rest of a call (the mean kernel)
    for name in ("infonce", "infonce_bf16"):
        host_device_split(name, cases[name] + loso_cases.get(name, []), "infonce_tile")
    # rows 12 and 17: the kernel against the rest of a call (the stem's
    # partial sums, none in the head)
    for name in ("stem_tail_bwd", "stem_tail_bwd_bf16"):
        host_device_split(name, cases[name] + loso_cases.get(name, []), "stem_tail_bwd")
    for name in ("fusion_head", "fusion_head_bf16"):
        host_device_split(name, cases[name], "fusion_head_kernel")
    # rows 14-16 in bf16: the host's share, three or four tensor maps a
    # call (encoded once, then taken from the maps' cache)
    for name in ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"):
        host_device_split(name, cases[name], name + "_kernel")
    print(json.dumps({"kernels": kernel_results(cases, loso_cases, counts)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

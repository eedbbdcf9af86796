#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card, and check it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs a CUDA card and exits non-zero without one. In order, it

1. turns TF32 off for matmuls and cuDNN convs (the plain versions are the
   fp32 reference) and builds every kernel in
   ``multimodal_sentiment_aanalysis_tpu_torch/csrc`` with nvcc;
2. builds the full-width flagship model (feat_dim=256) from a seeded
   ``torch.Generator`` with perturbed BatchNorm running stats, and a pool of
   480 synthetic samples at MAHNOB-HCI shapes resident on the card;
3. serves 100 requests of 64 samples from the pool through the eval model
   forward, ``build_serving_forward`` and ``build_serving_forward(use_pallas=True)``,
   with every launch counter reset just before; checks that each kernel of
   the path launched as often as the path calls it, that the logits are
   finite, that the three entry points agree within 1e-3, and that the
   plain path on the CPU agrees on the first rows within 1e-3;
4. holds each kernel against its plain PyTorch version at the shapes the
   path gives it (real activations of the first request) and times both
   with CUDA events;
5. prints the card's name and power limit, one JSON line of per-kernel
   results, and as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

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
from multimodal_sentiment_aanalysis_tpu_torch.data import DeviceDataset, epoch_batch_indices
from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem, conv_stem_train, lstm

SEED = 0
POOL, REQUESTS, BATCH = 480, 100, 64
PATH_ATOL = 1e-3   # entry points against each other, and against the CPU plain path
TIMED_CALLS = 20

# kernel -> (source, TPU kernel it replaces, tolerance against its plain version)
KERNELS = {
    "bilstm_fwd": ("multimodal_sentiment_aanalysis_tpu_torch/csrc/lstm_fwd.cu",
                   "multimodal_sentiment_aanalysis_tpu/kernels/lstm.py:527", 1e-4),
    "stem_tail": ("multimodal_sentiment_aanalysis_tpu_torch/csrc/stem_tail.cu",
                  "multimodal_sentiment_aanalysis_tpu/kernels/conv_stem_train.py:265", 1e-5),
    "conv_stem": ("multimodal_sentiment_aanalysis_tpu_torch/csrc/conv_stem.cu",
                  "multimodal_sentiment_aanalysis_tpu/kernels/conv_stem.py:64", 1e-4),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = []
        for idx in plan:
            b = pool.gather(idx)
            res.append(fwd(b["eeg"], b["eye"], b["pps"]))
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / len(plan)
        outs[name] = res
    return outs, ms


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


def kernel_cases(model, eeg: torch.Tensor) -> dict:
    """(kernel call, plain call) pairs at the serving path's shapes, on the
    activations the path computes from ``eeg``. Call under ``no_grad``."""
    tc = model.eeg_net.temp_conv
    cases: dict = {name: [] for name in KERNELS}
    # eval model forward: conv (cuDNN), then the stem tail per stage
    h = eeg
    for conv, bn, pool in ((tc[0], tc[1], 4), (tc[5], tc[6], 2)):
        y = F.conv1d(h, conv.weight, conv.bias, padding=conv.padding)
        args = (y.transpose(1, 2).contiguous(), bn.weight, bn.bias,
                bn.running_mean, bn.running_var)
        cases["stem_tail"].append((
            f"pool {pool} {tuple(args[0].shape)}",
            lambda a=args, p=pool: conv_stem_train.fused_stage_train(*a, 0.0, p),
            lambda a=args, p=pool: conv_stem_train.fused_stage_train_plain(*a, p)))
        h = conv_stem_train.fused_stage_train_plain(*args, pool).transpose(1, 2)
    # both BiLSTM layers, on the stem's output
    x = h.transpose(1, 2).contiguous()
    bilstm = model.eeg_net.bilstm
    for k in range(bilstm.num_layers):
        fwd, bwd = bilstm.layer_params(k)
        cases["bilstm_fwd"].append((
            f"layer {k} {tuple(x.shape)}",
            lambda x=x, f=fwd, b=bwd: lstm.fused_bilstm_layer(x, f, b),
            lambda x=x, f=fwd, b=bwd: lstm.fused_bilstm_layer_plain(x, f, b)))
        x = lstm.fused_bilstm_layer_plain(x, fwd, bwd)
    # serving forward with use_pallas=True: the fused conv stem per stage
    h = eeg.transpose(1, 2).contiguous()
    for conv, bn, pad, pool in ((tc[0], tc[1], 7, 4), (tc[5], tc[6], 2, 2)):
        scale, shift = conv_stem.fold_bn(bn.weight, bn.bias, bn.running_mean,
                                         bn.running_var, conv.bias)
        args = (h, conv.weight, scale, shift, pad, pool)
        cases["conv_stem"].append((
            f"k {conv.weight.shape[2]} pool {pool} {tuple(h.shape)}",
            lambda a=args: conv_stem.fused_conv_bn_gelu_pool(*a),
            lambda a=args: conv_stem.fused_conv_bn_gelu_pool_plain(*a)))
        h = conv_stem.fused_conv_bn_gelu_pool_plain(*args)
    return cases


def main() -> int:
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
    libs = build_all()
    print(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in libs))

    model = make_model(device)
    pool = make_pool(device)
    plan = request_plan(device)
    paths = {
        "model_forward": model,
        "serving": build_serving_forward(model),
        "serving_use_pallas": build_serving_forward(model, use_pallas=True),
    }
    first = pool.gather(plan[0])
    for fwd in paths.values():  # warm-up: first launches, cuBLAS/cuDNN handles
        fwd(first["eeg"], first["eye"], first["pps"])
    torch.cuda.synchronize()

    reset_launch_counts()
    outs, ms = serve(paths, pool, plan)
    counts = launch_counts()
    expected = {"bilstm_fwd": 2 * REQUESTS * len(paths), "stem_tail": 2 * REQUESTS,
                "conv_stem": 2 * REQUESTS}
    print(f"launches over {REQUESTS} requests x {len(paths)} entry points: {counts}")
    check(counts == expected, f"launch counts {counts} != {expected}")
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
    ca, cv = cpu_model(rows["eeg"], rows["eye"], rows["pps"])
    cpu_err = max(max((a[:4].cpu() - ca).abs().max().item(), (v[:4].cpu() - cv).abs().max().item())
                  for a, v in (res[0] for res in outs.values()))
    print(f"card vs CPU plain path on 4 rows: max |diff| {cpu_err:.3e} (limit {PATH_ATOL})")
    check(cpu_err <= PATH_ATOL, "card disagrees with the CPU plain path")

    results = []
    torch.set_grad_enabled(False)  # plain versions must not record autograd graphs
    for name, cases in kernel_cases(model, first["eeg"]).items():
        source, replaces, tol = KERNELS[name]
        err = ms_k = ms_p = 0.0
        for label, kern, plain in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            check(got.shape == want.shape and e <= tol,
                  f"{name} {label}: max |err| {e:.3e} > {tol}")
            tk, tp = time_ms(kern), time_ms(plain)
            print(f"kernel {name} {label}: max |err| {e:.3e} (limit {tol}), "
                  f"{tk:.4f} ms, plain {tp:.4f} ms")
            err, ms_k, ms_p = max(err, e), ms_k + tk, ms_p + tp
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p})
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

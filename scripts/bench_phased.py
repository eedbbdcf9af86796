"""Time the phased curriculum's ``fusion_arousal`` step of the port's
``VectorizedPhasedTrainer`` on one CUDA card, as ``chip_smoke.py`` times it:
24 subjects, B=64, feat_dim 256, the synthetic MAHNOB-HCI set (seed 0), TF32
off; the curriculum ``run(1, 1, 1, 1, 1)`` as warm-up, then ``--windows``
windows of ``run_phase_on_device("fusion_arousal", 2)`` (the per-epoch
evaluation included, no host sync inside), each on the host clock around a
synchronised run and by CUDA events over the same window, in ms/step.

    python3 scripts/bench_phased.py [--root DIR] [--label NAME] [--windows N]

``--root`` is the checkout whose port is imported (default: this one), so
that two trees can be compared in one run on the card (a ``git archive`` of
the other under ``build/``); the last line is the result as one JSON object.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPOCHS, BATCH, SEED = 2, 64, 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--windows", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    from multimodal_sentiment_aanalysis_tpu_torch import MultimodalTransformerModel, build_all
    from multimodal_sentiment_aanalysis_tpu_torch.data import (
        DeviceDataset,
        assemble_features,
        make_synthetic_hci_data,
    )
    from multimodal_sentiment_aanalysis_tpu_torch.train import VectorizedPhasedTrainer

    if not torch.cuda.is_available():
        print("bench_phased: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build_all()
    data = make_synthetic_hci_data(seed=SEED)
    feats, _ = assemble_features(data, ["eeg", "eye", "pps"])
    full = DeviceDataset({
        "eeg": feats["eeg"].astype(np.float32), "eye": feats["eye"].astype(np.float32),
        "pps": feats["pps"].astype(np.float32),
        "arousal": np.asarray(data["arousal_label"]).astype(np.int64),
        "valence": np.asarray(data["valence_label"]).astype(np.int64)}, device)
    vt = VectorizedPhasedTrainer(MultimodalTransformerModel(feat_dim=256, device=device), full,
                                 24, 20, batch_size=BATCH, seed=SEED, verbose=False)
    vt.run(1, 1, 1, 1, 1)
    steps = -(-vt.train_idx.shape[1] // BATCH)
    host_ms, event_ms = [], []
    for _ in range(args.windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        vt.run_phase_on_device("fusion_arousal", EPOCHS)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3 / (EPOCHS * steps))
        event_ms.append(start.elapsed_time(end) / (EPOCHS * steps))
    result = {"label": args.label, "card": smi, "steps_per_window": EPOCHS * steps,
              "host_ms_per_step": host_ms, "event_ms_per_step": event_ms,
              "median_host_ms": float(np.median(host_ms)),
              "median_event_ms": float(np.median(event_ms))}
    print(f"{args.label}: fusion_arousal ms/step by window (host clock) "
          f"{[round(x, 3) for x in host_ms]}, CUDA events {[round(x, 3) for x in event_ms]} "
          f"({smi})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

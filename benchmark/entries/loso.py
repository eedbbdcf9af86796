"""The vectorized LOSO trainer: every held-out subject's flagship model
trained at once (``train/vloso.py::VectorizedLOSOTrainer``).

The window repeats ``fused_epochs_on_device(1)``: one epoch of every model,
plans drawn on the device, nothing read back. An example is one real
training row of one model (wrap-padding rows do not count).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, training
from benchmark.reference import flagship, rules
from benchmark.reference.flagship import TRAINER_CW


class Entry(training.TrainerEntry):
    def __init__(self, cfg: dict, wl: dict, seed: int, device, fault: str | None = None):
        from multimodal_sentiment_aanalysis_tpu_torch.data.pipeline import DeviceDataset
        from multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model import (
            MultimodalTransformerModel)
        from multimodal_sentiment_aanalysis_tpu_torch.train.vloso import VectorizedLOSOTrainer

        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        d, opt = cfg["dataset"], cfg["optimizer"]
        self.n_models, self.batch = wl["models"], wl["batch"]
        self.n_train = (d["subjects"] - 1) * d["trials"]
        self.data = harness.dataset(cfg, seed, device)
        self.spec, self.stats_spec = flagship.spec(cfg), flagship.stats_spec(cfg)
        self.params0, self.stats0 = training.draw_weights(
            self.spec, self.stats_spec, self.n_models, harness.sub_seed(seed, 3), device)
        model = MultimodalTransformerModel(
            num_classes=cfg["classes"], temperature=cfg["temperature"],
            eeg_channels=cfg["eeg"]["channels"], eeg_time=cfg["eeg"]["time"],
            eye_dim=cfg["eye_dim"], pps_dim=cfg["pps_dim"], feat_dim=cfg["feat_dim"],
            device=device, lstm_schedule=cfg["lstm_schedule"])
        host = {k: v.cpu().numpy() for k, v in self.data.items()}
        self.trainer = VectorizedLOSOTrainer(
            model, DeviceDataset(host, device), n_subjects=self.n_models,
            ex_nums=d["trials"], lr=opt["lr"], weight_decay=opt["weight_decay"],
            batch_size=self.batch, clip_norm=opt["clip_norm"], seed=seed,
            compute_dtype=wl["compute_dtype"], moment_dtype=wl["moment_dtype"])
        state = {**{k: v for k, v in self.params0.items() if k != TRAINER_CW}, **self.stats0}
        self.trainer.load_stacked_state(state, contrastive_weight=self.params0[TRAINER_CW])
        # the reference's copy waits on the host, out of the program's peak
        self.params0 = {k: v.cpu() for k, v in self.params0.items()}
        self.stats0 = {k: v.cpu() for k, v in self.stats0.items()}
        self.opt, self.step_attr = self.trainer.opt, "_train_step"
        if fault is not None:
            self.plant(fault)
        self.steps_per_call = training.ceil_div(self.n_train, self.batch)
        self.examples_per_call = self.n_models * self.n_train
        self.encoder_rows_per_step = self.n_models * self.batch
        self.outputs: list[torch.Tensor] = []

    @staticmethod
    def half_batch(step):
        def half(idx, mask, active):
            mask = mask.clone()
            mask[:, mask.shape[1] // 2:] = 0.0
            return step(idx, mask, active)

        return half

    def call(self) -> None:
        self.outputs.append(self.trainer.fused_epochs_on_device(1))

    @staticmethod
    def loss_of(sums: torch.Tensor) -> torch.Tensor:
        return sums[:, 0] / sums[:, 3]

    def failed_examples(self) -> int:
        """Examples of the window's model-epochs whose loss was not finite."""
        bad = 0
        for out in self.outputs:
            bad += int((~torch.isfinite(out[..., 0])).sum()) * self.n_train
        return bad

    def batches(self) -> list[dict]:
        """The first steps' batches, by the device plan rule: the plan
        generator seeded ``seed + 2``, one permutation per model and epoch."""
        d = self.cfg["dataset"]
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        rows = torch.as_tensor(
            np.stack([rules.loso_train_rows(d["subjects"], d["trials"], s)
                      for s in range(self.n_models)]), device=self.device)
        out: list[dict] = []
        while len(out) < training.CAPTURED_STEPS:
            plans = [rules.device_epoch_plan(gen, self.n_train, self.batch)
                     for _ in range(self.n_models)]
            order = torch.stack([o for o, _ in plans])
            mask = torch.stack([m for _, m in plans])
            epoch = torch.gather(rows, 1, order.reshape(self.n_models, -1)).reshape(order.shape)
            for j in range(order.shape[1]):
                if len(out) < training.CAPTURED_STEPS:
                    batch = training.gather(self.data, epoch[:, j])
                    batch["mask"] = mask[:, j]
                    out.append(batch)
        return out

    def reference_readings(self, precision: str = "float32") -> dict:
        opt = self.cfg["optimizer"]
        return training.reference_readings(
            flagship, self.cfg, self.wl, self.params0, self.stats0, self.batches(),
            self.seed + 1, self.device, precision, opt["lr"], opt["weight_decay"],
            opt["clip_norm"])

    def flops_per_example(self) -> float:
        b, e = self.batch, self.cfg["eeg"]
        meta = torch.device("meta")
        batch = {"eeg": torch.empty((b, e["channels"], e["time"]), device=meta),
                 "eye": torch.empty((b, self.cfg["eye_dim"]), device=meta),
                 "pps": torch.empty((b, self.cfg["pps_dim"]), device=meta),
                 "arousal": torch.empty((b,), dtype=torch.long, device=meta),
                 "valence": torch.empty((b,), dtype=torch.long, device=meta),
                 "mask": torch.empty((b,), device=meta)}
        return training.flops_per_example(flagship, self.cfg, self.spec, self.stats_spec,
                                          batch, b)

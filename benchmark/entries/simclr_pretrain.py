"""The vectorized SimCLR pretrain: every held-out subject's encoder and
projection head pretrained at once on its balanced pairs
(``train/vsimclr.py::VectorizedSimCLRTrainer.pretrain_epoch_on_device``).

The window repeats one pretrain epoch (its plans drawn on the host, nothing
read back). An example is one pair of one model (the pairs that wrap a
model's table to whole batches do not count).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, training
from benchmark.reference import rules, simclr


class Entry(training.TrainerEntry):
    def __init__(self, cfg: dict, wl: dict, seed: int, device, fault: str | None = None):
        from multimodal_sentiment_aanalysis_tpu_torch.data.pipeline import DeviceDataset
        from multimodal_sentiment_aanalysis_tpu_torch.models.simclr import (
            Classifier, MultiModalEncoder, ProjectionHead)
        from multimodal_sentiment_aanalysis_tpu_torch.train.vsimclr import (
            VectorizedSimCLRTrainer)

        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        d, e, opt = cfg["dataset"], cfg["eeg"], cfg["optimizer"]
        self.n_models, self.batch = wl["models"], wl["batch"]
        self.data = harness.dataset(cfg, seed, device)
        self.spec, self.stats_spec = simclr.spec(cfg), simclr.stats_spec(cfg)
        self.params0, self.stats0 = training.draw_weights(
            self.spec, self.stats_spec, self.n_models, harness.sub_seed(seed, 3), device)
        clf, _ = training.draw_weights(simclr.classifier_spec(cfg), [], self.n_models,
                                       harness.sub_seed(seed, 4), device)
        f = cfg["feat_dim"]
        encoder = MultiModalEncoder(f, cfg["encoder_heads"], e["channels"], e["time"],
                                    e["stem_dropout"], cfg["eye_dim"], cfg["pps_dim"],
                                    device=device)
        projector = ProjectionHead(f, cfg["proj_hidden"], cfg["proj_out"], cfg["dropout"],
                                   device=device)
        classifier = Classifier(f, cfg["clf_hidden"], cfg["classes"], cfg["dropout"],
                                device=device)
        host = {k: v.cpu().numpy() for k, v in self.data.items()}
        self.trainer = VectorizedSimCLRTrainer(
            encoder, projector, classifier, DeviceDataset(host, device),
            n_subjects=self.n_models, ex_nums=d["trials"], pretrain_lr=opt["lr"],
            batch_size=self.batch, temperature=cfg["temperature"], seed=seed, verbose=False)
        state = {**self.params0, **self.stats0}
        parts = [{k.removeprefix(f"{part}."): v for k, v in state.items()
                  if k.startswith(f"{part}.")} for part in ("encoder", "projector")]
        self.trainer.load_stacked_state(*parts, clf)
        # the reference's copy waits on the host, out of the program's peak
        self.params0 = {k: v.cpu() for k, v in self.params0.items()}
        self.stats0 = {k: v.cpu() for k, v in self.stats0.items()}
        self.opt, self.step_attr = self.trainer.pre_opt, "pretrain_step"
        if fault is not None:
            self.plant(fault)
        self.pairs, self.labels, self.n_pairs = self._pair_tables()
        width = self.pairs.shape[1]
        self.steps_per_call = training.ceil_div(width, self.batch)
        self.examples_per_call = int(self.n_pairs.sum())
        self.encoder_rows_per_step = 2 * self.n_models * self.batch
        self.outputs: list[torch.Tensor] = []

    @staticmethod
    def half_batch(step):
        def half(rows, labels):
            b = rows.shape[1] // 2
            return step(rows[:, :b].contiguous(), labels[:, :b].contiguous())

        return half

    def _pair_tables(self):
        """Each model's pairs (global rows) and labels, by the pair rule at
        seed ``seed + s``, wrapped to the largest count."""
        d = self.cfg["dataset"]
        a = self.data["arousal"].cpu().numpy()
        v = self.data["valence"].cpu().numpy()
        sid = np.repeat(np.arange(d["subjects"]), d["trials"])
        rows, labs = [], []
        for s in range(self.n_models):
            tr = rules.loso_train_rows(d["subjects"], d["trials"], s)
            pidx, plab = rules.contrastive_pairs(a[tr], v[tr], sid[tr], self.seed + s)
            rows.append(tr[pidx])
            labs.append(plab)
        n = np.asarray([len(x) for x in labs])
        wrap = np.arange(int(n.max()))
        return (np.stack([r[wrap % len(r)] for r in rows]),
                np.stack([x[wrap % len(x)] for x in labs]), n)

    def call(self) -> None:
        self.outputs.append(self.trainer.pretrain_epoch_on_device())

    @staticmethod
    def loss_of(loss: torch.Tensor) -> torch.Tensor:
        return loss

    def failed_examples(self) -> int:
        bad = 0
        for out in self.outputs:
            bad += int(self.n_pairs[(~torch.isfinite(out)).cpu().numpy()].sum())
        return bad

    def batches(self) -> list[dict]:
        """The first steps' pair batches, by the pretrain plan rule: one
        host generator seeded ``seed``, a permutation per model and epoch."""
        rng = np.random.default_rng(self.seed)
        out: list[dict] = []
        while len(out) < training.CAPTURED_STEPS:
            pos = rules.pretrain_plan(rng, self.n_pairs, self.pairs.shape[1], self.batch)
            for j in range(pos.shape[1]):
                if len(out) < training.CAPTURED_STEPS:
                    take = pos[:, j]
                    rows = np.take_along_axis(self.pairs, take[..., None], 1)
                    labs = np.take_along_axis(self.labels, take, 1)
                    rows = torch.as_tensor(rows, device=self.device)
                    out.append({"view1": training.gather(self.data, rows[..., 0]),
                                "view2": training.gather(self.data, rows[..., 1]),
                                "labels": torch.as_tensor(labs, device=self.device)})
        for b in out:
            for view in ("view1", "view2"):
                b[view] = {k: b[view][k] for k in ("eeg", "eye", "pps")}
        return out

    def reference_readings(self, precision: str = "float32") -> dict:
        opt = self.cfg["optimizer"]
        return training.reference_readings(
            simclr, self.cfg, self.wl, self.params0, self.stats0, self.batches(),
            self.seed + 1, self.device, precision, opt["lr"], opt["weight_decay"], None)

    def flops_per_example(self) -> float:
        b, e = self.batch, self.cfg["eeg"]
        meta = torch.device("meta")

        def view():
            return {"eeg": torch.empty((b, e["channels"], e["time"]), device=meta),
                    "eye": torch.empty((b, self.cfg["eye_dim"]), device=meta),
                    "pps": torch.empty((b, self.cfg["pps_dim"]), device=meta)}

        batch = {"view1": view(), "view2": view(), "labels": torch.empty((b,), device=meta)}
        return training.flops_per_example(simclr, self.cfg, self.spec, self.stats_spec,
                                          batch, b)

"""Phased multi-task trainer: the reference's 5-phase curriculum, one subject.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/multitask.py``
(reference ``dataLoader/MultiTaskTrainer.py:10-673``), the flagship
experiment's engine: ``run(eEEG, eEYE, ePPS, e2, e3)`` trains

- phases ``eeg``, ``eye``, ``pps``: one encoder alone on its own
  contrastive (InfoNCE) term;
- ``fusion_arousal``: the encoders, the fusion modules and the arousal head
  on CE-arousal;
- ``valence``: CE-valence, where the fusion modules get gradients and enter
  the clip norm but the optimizer covers the valence head only (the grad
  set and the update set of :data:`PHASES` differ);

each with AdamW(1e-4, weight decay 1e-4) re-created every epoch in parity
mode (``reset_optimizer_each_epoch=True``, the reference's quirk: moments
reset and the plateau scheduler never fires) and a global-norm clip 1.0 over
the grad set; a test evaluation after every epoch (both CE losses, the three
contrastive terms and both accuracies).

On the module: a phase sets ``requires_grad`` on its grad set
(:func:`.state.apply_grad_mask`), so the parameters outside it take no
gradient, and autograd never runs the backward of an encoder whose loss
does not reach it (JAX zeroes those gradients and XLA drops their
backward); the optimizer is :func:`.state.make_masked_adamw` over the update
set. There is no NaN skip, as in JAX's phased trainer. Dropout draws from a
device ``torch.Generator`` seeded with ``seed``, and the model is
re-initialised from ``torch.Generator().manual_seed(seed)`` (JAX inits its
own parameters from ``seed``), so a subject's init is
:class:`.vphased.VectorizedPhasedTrainer`'s for the same seed.

:func:`make_phase_loss` is the one model's loss both trainers use.
:meth:`MultiTaskTrainer.save_state` / :meth:`~MultiTaskTrainer.restore_state`
checkpoint the curriculum between epochs (JAX ``multitask.py:585-625``).

Batch data parallelism, ``mesh=`` (a :func:`..parallel.make_mesh` mesh of
W ranks, one process each; JAX's GSPMD form, ``multitask.py:199-214``):
every rank draws the same plans and runs the forward on its contiguous
block of each planned batch (``batch_size`` must divide by W) inside
:func:`..parallel.collectives.global_batch`, so the BatchNorm statistics,
the stem tail's backward, the InfoNCE terms and the CE means and
accuracies cover the global batch, the wrap-padded tail rows in the
statistics and out of the losses as in one process. After the backward
each rank sums the gradients over the ranks (one all-reduce); the clip and
the AdamW step then run identically on every rank, so the parameters stay
replicated. The evaluation shards the test rows likewise and sums the
metric sums. Each rank draws its dropout masks from its own generator,
seeded from ``(seed, rank)`` (rank 0's is the one-process stream), so W > 1
ranks equal the one-process run at dropout 0 (to float noise: the sums
run in another order); one rank equals it exactly. Only rank 0 writes
files (:meth:`run`'s checkpoint and figure, :meth:`save_state`, which
stores every rank's dropout generator).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from ..data.pipeline import DeviceDataset, epoch_batch_indices
from ..ops.losses import masked_accuracy, masked_cross_entropy
from ..parallel.collectives import global_batch, global_count, reduce_sum_, sum_grads_
from ..parallel.mesh import rank_seed, restore_rank_generator, save_on_rank0
from ..utils.checkpoint import (
    generator_state,
    load_checkpoint,
    metrics_checkpoint_name,
)
from ..utils.schedule import ReduceLROnPlateau
from .state import (
    apply_grad_mask,
    as_dtype,
    cast_floating,
    clip_by_global_norm,
    make_masked_adamw,
    module_mask,
    set_learning_rate,
)

ENCODER_MODULES = {"eeg_net", "eye_net", "pps_net"}
FUSION_MODULES = {
    "cross_attn_e2p",
    "cross_attn_p2e",
    "attn_w1",
    "attn_w2",
    "fusion_stack",
}


@dataclass(frozen=True)
class PhaseSpec:
    loss: str  # 'c_eeg' | 'c_eye' | 'c_pps' | 'ce_arousal' | 'ce_valence'
    grad_modules: frozenset[str]  # requires-grad set (enters clip norm)
    update_modules: frozenset[str]  # optimizer coverage set
    sched_patience: int
    sched_factor: float


PHASES: dict[str, PhaseSpec] = {
    "eeg": PhaseSpec("c_eeg", frozenset({"eeg_net"}), frozenset({"eeg_net"}), 3, 0.5),
    "eye": PhaseSpec("c_eye", frozenset({"eye_net"}), frozenset({"eye_net"}), 3, 0.5),
    "pps": PhaseSpec("c_pps", frozenset({"pps_net"}), frozenset({"pps_net"}), 3, 0.5),
    "fusion_arousal": PhaseSpec(
        "ce_arousal",
        frozenset(ENCODER_MODULES | FUSION_MODULES | {"arousal_head"}),
        frozenset(ENCODER_MODULES | FUSION_MODULES | {"arousal_head"}),
        2,
        0.2,
    ),
    "valence": PhaseSpec(
        "ce_valence",
        frozenset(FUSION_MODULES | {"valence_head"}),
        frozenset({"valence_head"}),  # optimizer covers valence head only
        2,
        0.1,
    ),
}

METRIC_KEYS = ("loss", "a_loss", "v_loss", "c_loss", "a_acc", "v_acc")
PHASE_ORDER = ("eeg", "eye", "pps", "fusion_arousal", "valence")


def make_phase_loss(model: nn.Module, phase_loss: str,
                    compute_dtype: str | torch.dtype | None = None) -> Callable:
    """Loss and metric sums of one curriculum phase (JAX ``make_phase_loss``).

    ``loss_fn(params, stats, batch, generator)`` runs ``model`` in its
    current mode through ``functional_call`` with the tensors of ``params``
    and ``stats`` in place of its own (empty dicts: its own); ``batch`` holds
    ``eeg``, ``eye``, ``pps``, ``arousal``, ``valence`` and ``mask``. It
    returns ``(loss, sums)``: ``loss`` is the phase's term (one of c_eeg,
    c_eye, c_pps, CE-arousal, CE-valence), ``sums`` the ``(7,)`` masked sums
    of :data:`METRIC_KEYS` and the row count ``n`` (``a_loss``/``v_loss``
    only in their own phase, ``c_loss`` only in a contrastive one). In train
    mode the forward moves the running stats of every BatchNorm layer in
    place, frozen or not, as JAX's mutable ``batch_stats`` do. With
    ``compute_dtype`` the parameters and inputs are cast for the forward and
    backward, and the losses, metrics and running stats stay fp32.

    Inside :func:`..parallel.collectives.global_batch` the batch is one
    rank's block of a global batch: ``loss`` is this rank's share of the
    global loss (the ranks' shares add up to it), the sums are scaled by
    the global row count so that their sum over ranks is the global batch's,
    and ``n`` stays this rank's count.
    """
    dt = as_dtype(compute_dtype)

    def loss_fn(params: dict, stats: dict, batch: dict,
                generator: torch.Generator | None = None):
        inputs = tuple(cast_floating(batch[k], dt) for k in ("eeg", "eye", "pps"))
        params = {n: cast_floating(p, dt) for n, p in params.items()}
        a, v, mask = batch["arousal"], batch["valence"], batch["mask"]
        outs = functional_call(model, {**params, **stats}, inputs,
                               {"labels": (a, v, mask), "generator": generator})
        arousal, valence, c1, c2, c3 = (t.to(torch.float32) for t in outs)
        a_loss = masked_cross_entropy(arousal, a, mask)
        v_loss = masked_cross_entropy(valence, v, mask)
        losses = {"c_eeg": c1, "c_eye": c2, "c_pps": c3, "ce_arousal": a_loss,
                  "ce_valence": v_loss}
        loss = losses[phase_loss]
        zero = torch.zeros_like(loss)
        sums = torch.stack([
            loss,
            a_loss if phase_loss == "ce_arousal" else zero,
            v_loss if phase_loss == "ce_valence" else zero,
            loss if phase_loss.startswith("c_") else zero,
            masked_accuracy(arousal, a, mask),
            masked_accuracy(valence, v, mask),
        ]) * global_count(mask)
        return loss, torch.cat([sums, mask.sum()[None]])

    return loss_fn


def eval_sums(outs: tuple, batch: dict, mask: torch.Tensor) -> torch.Tensor:
    """The ``(7,)`` masked sums of an evaluation batch from the eval-mode
    forward's ``(arousal, valence, c1, c2, c3)``: ``loss`` is CE-arousal +
    CE-valence, ``c_loss`` c1 + c2 + c3 (JAX ``_build_eval``)."""
    arousal, valence, c1, c2, c3 = (t.to(torch.float32) for t in outs)
    a, v = batch["arousal"], batch["valence"]
    a_loss = masked_cross_entropy(arousal, a, mask)
    v_loss = masked_cross_entropy(valence, v, mask)
    sums = torch.stack([a_loss + v_loss, a_loss, v_loss, c1 + c2 + c3,
                        masked_accuracy(arousal, a, mask),
                        masked_accuracy(valence, v, mask)]) * global_count(mask)
    return torch.cat([sums, mask.sum()[None]])


def _means(sums: np.ndarray) -> dict[str, float]:
    """Masked sums ``(7,)`` -> per-sample means of :data:`METRIC_KEYS`."""
    return {k: float(sums[j]) / float(sums[6]) for j, k in enumerate(METRIC_KEYS)}


class MultiTaskTrainer:
    """Phased curriculum trainer of one model on ``train_data``'s device."""

    def __init__(
        self,
        model: nn.Module,
        train_data: DeviceDataset,
        test_data: DeviceDataset,
        test_person: int = -1,
        lr: float = 1e-4,
        weight_decay: float = 1e-4,
        batch_size: int = 64,
        clip_norm: float = 1.0,
        reset_optimizer_each_epoch: bool = True,
        fused_phases: bool = False,
        seed: int = 42,
        checkpoint_dir: str = ".",
        verbose: bool = True,
        mesh=None,
    ):
        self.device = train_data.device
        self.mesh = mesh
        self._group = None if mesh is None else mesh.get_group()
        self._world = 1 if mesh is None else mesh.size()
        self._rank = 0 if mesh is None else mesh.get_local_rank()
        if batch_size % self._world:
            raise ValueError(f"batch_size {batch_size} does not split over {self._world} ranks")
        if any(p.device != self.device for p in model.parameters()):
            raise ValueError(f"the model's parameters must be on the data's device {self.device}")
        self.model = model
        self.lr = lr
        self.weight_decay = weight_decay
        self.batch_size = batch_size
        self.clip_norm = clip_norm
        self.reset_optimizer_each_epoch = reset_optimizer_each_epoch
        # whole phases without a host sync (parity mode only; see run_phase_fused)
        self.fused_phases = fused_phases and reset_optimizer_each_epoch
        self.checkpoint_dir = checkpoint_dir
        self.verbose = verbose
        self._loss_fns: dict[str, Callable] = {}
        self.reset(train_data, test_data, test_person, seed)

    def reset(self, train_data: DeviceDataset, test_data: DeviceDataset,
              test_person: int = -1, seed: int = 42) -> None:
        """Re-initialise the model, optimizers, schedulers, generators and
        metrics for a new LOSO subject (JAX ``reset``)."""
        self.train_data = train_data
        self.test_data = test_data
        self.test_person = test_person
        self.host_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, self._rank))
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self._opt: dict[str, torch.optim.AdamW] = {}
        self.schedulers: dict[str, ReduceLROnPlateau] = {}
        self.metrics = {split: {k: [] for k in METRIC_KEYS} for split in ("train", "test", "val")}

    # ------------------------------------------------------------------
    def _masks(self, phase: str) -> tuple[dict[str, bool], dict[str, bool]]:
        spec = PHASES[phase]
        names = [n for n, _ in self.model.named_parameters()]
        return module_mask(names, spec.grad_modules), module_mask(names, spec.update_modules)

    def _optimizer(self, phase: str, lr: float) -> torch.optim.AdamW:
        return make_masked_adamw(self.model, self._masks(phase)[1], lr, self.weight_decay)

    def _block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of a planned batch's rows."""
        if self._group is None:
            return t
        b = t.shape[-1] // self._world
        return t[..., self._rank * b:(self._rank + 1) * b]

    def _sum_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        return t if self._group is None else reduce_sum_(t, self._group)

    def _train_step(self, phase: str, batch: dict, optimizer: torch.optim.AdamW,
                    n_valid: torch.Tensor | None = None) -> torch.Tensor:
        """One step of ``phase`` on ``batch`` (with its ``mask``; under a
        mesh this rank's block of a planned batch of ``n_valid`` valid rows);
        returns the ``(7,)`` metric sums (this rank's share). The clipped
        gradients stay in ``.grad``."""
        if phase not in self._loss_fns:
            self._loss_fns[phase] = make_phase_loss(self.model, PHASES[phase].loss)
        self.model.zero_grad(set_to_none=True)
        grad_params = [p for p in self.model.parameters() if p.requires_grad]
        with global_batch(self._group, n_valid):
            loss, sums = self._loss_fns[phase]({}, {}, batch, self.generator)
            loss.backward()
        if self._group is not None:  # the global loss's gradient: the ranks' shares summed
            sum_grads_(grad_params, self._group)
        # clip over the requires-grad set (torch clip_grad_norm_ parity)
        clip_by_global_norm(grad_params, self.clip_norm)
        optimizer.step()
        return sums.detach()

    def _epoch(self, phase: str, plan_idx: torch.Tensor, plan_mask: torch.Tensor,
               optimizer: torch.optim.AdamW) -> torch.Tensor:
        """Every step of one epoch's plan in train mode, the grad set alone
        requiring gradients; the ``(7,)`` metric sums, on the device."""
        self.model.train()
        apply_grad_mask(self.model, self._masks(phase)[0])
        try:
            sums = torch.zeros(7, device=self.device)
            for idx, mask in zip(plan_idx, plan_mask):
                batch = self.train_data.gather(self._block(idx))
                batch["mask"] = self._block(mask)
                sums += self._train_step(phase, batch, optimizer, mask.sum())
        finally:
            for p in self.model.parameters():
                p.requires_grad_(True)
        return self._sum_over_ranks(sums)

    @torch.no_grad()
    def _eval_sums(self, plan_idx: torch.Tensor, plan_mask: torch.Tensor) -> torch.Tensor:
        """The test set's ``(7,)`` metric sums in eval mode, on the device
        (each rank its block of every batch, summed over the ranks)."""
        self.model.eval()
        sums = torch.zeros(7, device=self.device)
        for idx, mask in zip(plan_idx, plan_mask):
            with global_batch(self._group, mask.sum()):
                batch, mask = self.test_data.gather(self._block(idx)), self._block(mask)
                outs = self.model(batch["eeg"], batch["eye"], batch["pps"],
                                  labels=(batch["arousal"], batch["valence"], mask))
                sums += eval_sums(outs, batch, mask)
        return self._sum_over_ranks(sums)

    def _phase_lr(self, phase: str) -> float:
        return self.schedulers[phase].lr if phase in self.schedulers else self.lr

    def train_epoch_phase(self, phase: str) -> dict[str, float]:
        """One training epoch of ``phase``; records and returns the train
        metrics."""
        if self.reset_optimizer_each_epoch or phase not in self._opt:
            self._opt[phase] = self._optimizer(phase, self._phase_lr(phase))
        plan_idx, plan_mask = self.train_data.epoch_plan(self.batch_size, self.host_rng,
                                                         shuffle=True)
        out = _means(self._epoch(phase, plan_idx, plan_mask, self._opt[phase]).cpu().numpy())
        for k in METRIC_KEYS:
            self.metrics["train"][k].append(out[k])
        return out

    def evaluate(self, mode: str = "test") -> dict[str, float]:
        plan_idx, plan_mask = self.test_data.epoch_plan(self.batch_size, shuffle=False)
        out = _means(self._eval_sums(plan_idx, plan_mask).cpu().numpy())
        for k in METRIC_KEYS:
            self.metrics[mode][k].append(out[k])
        return out

    def _print_epoch(self, epoch: int, train_m: dict, test_m: dict) -> None:
        if self.verbose:
            print(f"Epoch {epoch} | train loss {train_m['loss']:.4f} "
                  f"a_acc {train_m['a_acc']:.2%} v_acc {train_m['v_acc']:.2%} "
                  f"c_loss {train_m['c_loss']:.4f} || test loss "
                  f"{test_m['loss']:.4f} a_acc {test_m['a_acc']:.2%} "
                  f"v_acc {test_m['v_acc']:.2%}")

    def run_phase_fused(self, phase: str, epochs: int) -> dict[str, float]:
        """``epochs`` epochs of ``phase`` with their test evaluations and no
        host sync: the E plans are drawn from the host generator first and
        sent to the device in one copy, the optimizer is re-created every
        epoch, and the metrics are read back once at the end; appends the
        same per-epoch metrics the host loop would. Requires parity mode: with
        ``reset_optimizer_each_epoch=False`` the plateau scheduler feeds each
        epoch's test loss back into the next epoch's LR, a host decision."""
        if not self.reset_optimizer_each_epoch:
            raise ValueError(
                "run_phase_fused requires reset_optimizer_each_epoch=True; "
                "the --no-reset-optimizer improvement path needs the "
                "per-epoch host loop for scheduler feedback"
            )
        if epochs <= 0:
            return {}
        spec = PHASES[phase]
        lr = self._phase_lr(phase)
        plans = [epoch_batch_indices(len(self.train_data), self.batch_size, self.host_rng,
                                     shuffle=True) for _ in range(epochs)]
        plan_idx = torch.as_tensor(np.stack([p[0] for p in plans]), device=self.device)
        plan_mask = torch.as_tensor(np.stack([p[1] for p in plans]), device=self.device)
        test_idx, test_mask = self.test_data.epoch_plan(self.batch_size, shuffle=False)
        tr, te = [], []
        for e in range(epochs):
            # reference parity: fresh optimizer moments every epoch
            tr.append(self._epoch(phase, plan_idx[e], plan_mask[e], self._optimizer(phase, lr)))
            te.append(self._eval_sums(test_idx, test_mask))
        tr, te = torch.stack(tr).cpu().numpy(), torch.stack(te).cpu().numpy()
        last_test: dict[str, float] = {}
        for e in range(epochs):
            train_m, last_test = _means(tr[e]), _means(te[e])
            for k in METRIC_KEYS:
                self.metrics["train"][k].append(train_m[k])
                self.metrics["test"][k].append(last_test[k])
            self._print_epoch(e + 1, train_m, last_test)
        # host-loop scheduler parity: recreated at the last epoch's start,
        # then stepped once on that epoch's test loss
        self.schedulers[phase] = ReduceLROnPlateau(lr=lr, patience=spec.sched_patience,
                                                   factor=spec.sched_factor)
        self.schedulers[phase].step(last_test["loss"])
        return last_test

    def _run_phase(self, phase: str, epochs: int, title: str) -> dict[str, float]:
        spec = PHASES[phase]
        last_test: dict[str, float] = {}
        if self.verbose:
            print(title)
        if self.fused_phases:
            return self.run_phase_fused(phase, epochs)
        for epoch in range(1, epochs + 1):
            if self.reset_optimizer_each_epoch or phase not in self.schedulers:
                # reference parity: scheduler recreated every epoch too
                self.schedulers[phase] = ReduceLROnPlateau(
                    lr=self._phase_lr(phase), patience=spec.sched_patience,
                    factor=spec.sched_factor)
            train_m = self.train_epoch_phase(phase)
            test_m = self.evaluate()
            new_lr = self.schedulers[phase].step(test_m["loss"])
            if not self.reset_optimizer_each_epoch:
                set_learning_rate(self._opt[phase], new_lr)
            self._print_epoch(epoch, train_m, test_m)
            last_test = test_m
        return last_test

    def run(self, epochs_phase_eeg: int, epochs_phase_eye: int, epochs_phase_pps: int,
            epochs_phase2: int, epochs_phase3: int, save: bool = True,
            plot: bool = True) -> dict[str, float]:
        """Full curriculum (reference ``MultiTaskTrainer.run``, ``:556-673``);
        ``save`` writes the model's ``state_dict`` under the metrics-encoded
        name in ``checkpoint_dir``, ``plot`` the loss and accuracy curves
        (``TestPerson{test_person}_progress.png``, needs matplotlib)."""
        test_m: dict[str, float] = {}
        for phase, epochs, title in (
            ("eeg", epochs_phase_eeg, "Phase EEGnet: contrastive training of the EEG encoder"),
            ("eye", epochs_phase_eye, "Phase EYEnet: contrastive training of the eye encoder"),
            ("pps", epochs_phase_pps, "Phase PPSnet: contrastive training of the PPS encoder"),
            ("fusion_arousal", epochs_phase2,
             "Phase 2: fusion modules + arousal head (CE-arousal)"),
            ("valence", epochs_phase3, "Phase 3: valence head (CE-valence)"),
        ):
            # a 0-epoch phase is a no-op; keep the last phase that ran
            test_m = self._run_phase(phase, epochs, title) or test_m
        if save and self._rank == 0:
            name = metrics_checkpoint_name(
                f"TestPerson{self.test_person}",
                {"ArousalAcc": test_m.get("a_acc", 0.0), "ValenceAcc": test_m.get("v_acc", 0.0)})
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            torch.save(self.model.state_dict(), os.path.join(self.checkpoint_dir, name))
        if plot and self._rank == 0:
            from ..eval.reporting import plot_progress

            os.makedirs(self.checkpoint_dir, exist_ok=True)
            plot_progress(self.metrics, os.path.join(
                self.checkpoint_dir, f"TestPerson{self.test_person}_progress.png"))
        return test_m

    # ------------------------------------------------------------------
    # checkpoint and resume between epochs: the optimizer is rebuilt every
    # epoch in parity mode (the reference's per-epoch reset), so the model,
    # the generators, the per-phase schedulers and the metrics are the state
    def save_state(self, path: str) -> str:
        """Write the model's ``state_dict``, the dropout and host generators'
        states, the per-phase schedulers, the metrics and ``test_person``.
        Under a mesh rank 0 writes, with every rank's dropout generator
        (every rank must call it; the file exists on return)."""
        state = {
            "model": self.model.state_dict(),
            "generator": generator_state(self.generator),
            "host_rng": self.host_rng.bit_generator.state,
            "schedulers": {k: dataclasses.asdict(v) for k, v in self.schedulers.items()},
            "metrics": self.metrics,
            "test_person": self.test_person,
        }
        return save_on_rank0(path, state, self.generator, self._group)

    def restore_state(self, path: str) -> None:
        """Restore :meth:`save_state`'s file in place; the next phase's
        optimizer starts fresh (JAX: ``_opt_state = {}``). Rank r's dropout
        generator takes rank r's state where the file has one."""
        state = load_checkpoint(path, "cpu")
        restore_rank_generator(self.generator, state, self._rank)
        self.model.load_state_dict(state["model"], strict=True)
        self.host_rng.bit_generator.state = state["host_rng"]
        self.schedulers = {k: ReduceLROnPlateau(**v) for k, v in state["schedulers"].items()}
        self.metrics = {split: {k: list(v) for k, v in d.items()}
                        for split, d in state["metrics"].items()}
        self.test_person = state["test_person"]
        self._opt = {}

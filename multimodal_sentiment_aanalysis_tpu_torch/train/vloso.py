"""Vectorized leave-one-subject-out training: all LOSO models in one step.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/vloso.py``. The
reference trains one model per held-out subject in a Python loop; every
LOSO split has the same shapes, so the S models train together:
``torch.func.vmap`` of ``grad_and_value`` of one model's loss, through
``functional_call`` of the flagship model on stacked state, with
``randomness="different"`` so each model draws its own dropout masks from
the trainer's one device generator. Every hand-written kernel on the path
(BiLSTM forward, c checkpoints and reverse sweep, stem tail forward and
backward, InfoNCE) makes one launch for all S models through its
Function's ``vmap`` rule.

Per model the semantics are :class:`.engine.Trainer`'s objective (CE on
both heads + the trainer-level contrastive weight times the three InfoNCE
terms, AdamW, global-norm clip, NaN skip-batch), each model with its own
parameters, optimizer state, BatchNorm running stats and per-subject
shuffled plan over its own LOSO train rows, so BatchNorm batch statistics
see only that model's rows.

State layout: the S models' parameters (the model's, then the
trainer-level contrastive weight) are the rows of one ``(S, N)`` tensor,
and their BatchNorm running stats the rows of one ``(S, M)`` tensor; the
model's tensors are views of a row. A step's gradient is therefore one
``(S, N)`` tensor, and clipping, AdamW and the NaN skip are a few
elementwise passes over it on the device (:mod:`.state`).

- :meth:`train_epoch`: plans drawn on the host from ``numpy``'s generator
  exactly as the JAX trainer draws them (:meth:`_epoch_plans`), so both
  packages see the same batches;
- :meth:`train_epochs_fused`: E epochs with the plans drawn on the device
  (:func:`..data.pipeline.epoch_plan_on_device`) and, with ``early_stop``,
  the per-subject early-stop and plateau-LR lanes
  (:func:`..utils.schedule.vector_schedule_step`), held-out losses and
  best-checkpoint snapshots advanced on the device: nothing is read back
  to the host until the E epochs are done;
- :meth:`evaluate`, :meth:`stop_report`, :meth:`subject_variables`,
  :meth:`run` as in JAX;
- :meth:`save_state` / :meth:`restore_state`: the whole vectorized state
  (JAX ``vloso.py:630-690``), restored in place, from which training
  resumes as if it had not stopped.

Mixed precision, as in JAX: ``compute_dtype="bfloat16"`` keeps the fp32
``(S, N)`` master row and casts it to bf16 for each step's loss
(:func:`.state.cast_floating`), all but the trainer-level contrastive
weight, which stays fp32; ``eeg``/``eye``/``pps`` are cast too. The forward then
takes the dtypes the JAX model takes: the EEG encoder runs in bf16 through
the bf16 forms of the stem-tail and BiLSTM kernels, while the eye/PPS
subnetworks turn fp32 at their fp32 positional encoding, so the rest of the
model, the InfoNCE features among them, computes in fp32 with bf16-rounded
weights (flax's promotion, kept by :class:`..models.layers.Linear` and
:class:`..models.layers.LayerNorm`). Logits and InfoNCE terms are taken in
fp32 before the loss, the BatchNorm running stats stay fp32, and the
gradient reaches the master row rounded to bf16 through the cast.
``moment_dtype="bfloat16"`` carries the AdamW moments in bf16
(:class:`.state.StackedAdamW`). Evaluation and the early-stop held-out loss
run in fp32 on the master parameters, as JAX's ``_build_eval`` and
``_one_model_te_loss`` do.

Subject sharding, ``mesh=`` (a :func:`..parallel.make_mesh` mesh of W
ranks, one process each; JAX ``vloso.py:122-145``): the subject axis is
padded to ``n_total``, a multiple of W (padding model ``s`` trains on
subject ``s % n_subjects``), and each rank holds a contiguous block of
``n_total / W`` models (:class:`..parallel.mesh.SubjectBlocks`). Every rank
draws all ``n_total`` initialisations, host plans and device plans from
the same generators and keeps its block, so a sharded run trains on the
unsharded run's batches (with padding the host and device streams draw
``n_total`` plans an epoch, so they follow a padded unsharded run's). A
step has no collective: every kernel launches once a step for the rank's
models. The results are global: :meth:`train_epoch`,
:meth:`train_epochs_fused`, :meth:`evaluate`, :meth:`stop_report` and
:meth:`run` gather every rank's block (the real ``n_subjects`` subjects);
:meth:`subject_variables` is broadcast from the rank that holds the
subject; :meth:`load_stacked_state` takes the global stack. Each rank
draws its dropout masks from its own generator (rank 0's is the unsharded
one), so a run on W > 1 ranks equals the unsharded run at dropout 0: the
losses to float noise (the models of a launch differ in number), exactly
on one rank. :meth:`save_state` writes one file from rank 0 in the
unsharded format and :meth:`restore_state` keeps the rank's block, so a
file restores into a trainer of any mesh with the same ``n_total``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call, grad_and_value, vmap

from ..data.pipeline import DeviceDataset, epoch_plan_on_device
from ..data.splits import loso_split
from ..ops.losses import masked_accuracy, masked_cross_entropy
from ..parallel.mesh import SubjectBlocks, rank_seed, restore_rank_generator, save_on_rank0
from ..utils.checkpoint import (
    copy_state_,
    generator_state,
    load_checkpoint,
    set_generator_state,
)
from ..utils.schedule import vector_schedule_init, vector_schedule_step
from .state import (
    RowLayout,
    StackedAdamW,
    as_dtype,
    cast_floating,
    clip_rows_by_global_norm,
)

TRAINER_CW = "trainer.contrastive_weight"  # the last entry of a parameter row
_TE_KEYS = ("te_loss", "te_a_acc", "te_v_acc")


def _objective(outs, batch: dict, mask: torch.Tensor, cw: torch.Tensor):
    """One model's ``(loss, arousal accuracy, valence accuracy)``: CE on
    both heads over ``nan_to_num``-ed logits plus ``cw`` times the three
    InfoNCE terms, all taken in fp32 (JAX ``_loss_fn``)."""
    arousal, valence = (torch.nan_to_num(t).to(torch.float32) for t in outs[:2])
    c1, c2, c3 = (t.to(torch.float32) for t in outs[2:])
    ce = (masked_cross_entropy(arousal, batch["arousal"], mask)
          + masked_cross_entropy(valence, batch["valence"], mask))
    return (ce + cw[0] * (c1 + c2 + c3), masked_accuracy(arousal, batch["arousal"], mask),
            masked_accuracy(valence, batch["valence"], mask))


def _per_sample(totals: np.ndarray) -> dict[str, np.ndarray]:
    """Masked sums ``(..., 4)`` (loss, a_acc, v_acc, rows) -> per-sample means."""
    n = np.maximum(totals[..., 3], 1.0)
    return {k: totals[..., j] / n for j, k in enumerate(("loss", "a_acc", "v_acc"))}


class VectorizedLOSOTrainer:
    """Trains one model per held-out subject, all at once, on ``data``'s
    device."""

    def __init__(
        self,
        model: nn.Module,
        data: DeviceDataset,
        n_subjects: int,
        ex_nums: int = 20,
        lr: float = 1e-4,
        weight_decay: float = 0.01,
        batch_size: int = 64,
        clip_norm: float = 1.0,
        seed: int = 42,
        compute_dtype: str | torch.dtype | None = None,
        moment_dtype: str | torch.dtype | None = None,
        mesh=None,
        early_stop: bool = False,
        es_patience: int = 5,
        plateau_patience: int = 3,
        plateau_factor: float = 0.5,
    ):
        self.device = data.device
        if any(p.device != self.device for p in model.parameters()):
            raise ValueError(f"the model's parameters must be on the data's device {self.device}")
        self.model = copy.deepcopy(model)  # the template functional_call runs
        self.data = data
        self.mesh = mesh
        self.blocks = blocks = SubjectBlocks(n_subjects, mesh)
        self.n_subjects, self.n_total, self.n_local = n_subjects, blocks.n_total, blocks.n_local
        self.ex_nums = ex_nums
        self.batch_size = batch_size
        self.clip_norm = clip_norm
        self.compute_dtype = as_dtype(compute_dtype)
        self.host_rng = np.random.default_rng(seed)

        # padding models (s >= n_subjects) reuse subject s % n_subjects
        splits = [loso_split(n_subjects, ex_nums, blocks.subject(s)) for s in range(self.n_total)]
        self.train_idx = np.stack([tr for tr, _ in splits])  # (n_total, n_train)
        self.test_idx = np.stack([te for _, te in splits])   # (n_total, ex_nums)
        # every model's train rows (the device plans are drawn in full); this
        # rank's test rows
        self._train_rows = torch.as_tensor(self.train_idx, dtype=torch.long, device=self.device)
        self._test_rows = torch.as_tensor(blocks.local(self.test_idx), dtype=torch.long,
                                          device=self.device)

        # one row per model: every parameter flattened, then the trainer's
        # contrastive weight; the BN running stats likewise
        self.layout = RowLayout(self.model, extra=[(TRAINER_CW, (1,))])
        named = list(self.model.named_parameters())
        buffers = dict(self.model.named_buffers())

        # stacked init: each model its own draw of the model's init rule, all
        # n_total drawn in turn on every rank, this rank's block kept
        gen = torch.Generator().manual_seed(seed)
        rows = []
        with torch.no_grad():
            for s in range(self.n_total):
                self.model.reset_parameters(gen)
                if blocks.lo <= s < blocks.hi:
                    rows.append(torch.cat([p.reshape(-1) for _, p in named]
                                          + [torch.ones(1, device=self.device)]))
        self.params = torch.stack(rows)  # (S, N), S = n_local
        self.stats = torch.cat([buffers[n].reshape(-1) for n in self.layout.stat_names]
                               ).repeat(self.n_local, 1)  # (S, M)
        self._stat_views = self._stat_dict(self.stats)  # written in place by the forward

        self.opt = StackedAdamW(self.params, lr, weight_decay, moment_dtype=as_dtype(moment_dtype))
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed + 1, blocks.rank))
        self.plan_generator = torch.Generator(device=self.device).manual_seed(seed + 2)
        self._all_active = torch.ones(self.n_local, dtype=torch.bool, device=self.device)
        self.early_stop = early_stop
        self._es_cfg = dict(es_patience=es_patience, plateau_patience=plateau_patience,
                            plateau_factor=plateau_factor)
        if early_stop:
            self.sched = vector_schedule_init(self.n_local, lr, self.device)
            self._epochs_run = 0
        self._reset_best()
        self._grad_step = vmap(grad_and_value(self._loss_one, has_aux=True),
                               randomness="different")

    # ------------------------------------------------------------------
    # state
    def _param_dict(self, row: torch.Tensor) -> dict[str, torch.Tensor]:
        """Named views of parameter row(s) ``(..., N)``."""
        return self.layout.params(row)

    def _stat_dict(self, row: torch.Tensor) -> dict[str, torch.Tensor]:
        """Named views of BN-stat row(s) ``(..., M)``."""
        return self.layout.stats(row)

    def _reset_best(self) -> None:
        if self.early_stop:
            self.best_params = self.params.clone()
            self.best_stats = self.stats.clone()

    @torch.no_grad()
    def load_stacked_state(self, state_dict: dict[str, torch.Tensor],
                           contrastive_weight: torch.Tensor | None = None) -> None:
        """Set every model's parameters and BN running stats from a
        reference-named ``state_dict`` whose tensors carry a leading model
        axis of all ``n_total`` models (e.g.
        :func:`..models.jax_import.trainer_state_from_jax` of the JAX
        trainer's stacked init), and the ``(n_total, 1)`` trainer-level
        contrastive weights when given; a sharded trainer keeps its block."""
        local = self.blocks.local
        for name, view in self._param_dict(self.params).items():
            if name != TRAINER_CW:
                view.copy_(local(state_dict[name]))
        if contrastive_weight is not None:
            self._param_dict(self.params)[TRAINER_CW].copy_(local(contrastive_weight))
        for name, view in self._stat_views.items():
            view.copy_(local(state_dict[name]))
        self._reset_best()

    def subject_variables(self, sid: int) -> dict[str, torch.Tensor]:
        """Subject ``sid``'s model as a reference-named ``state_dict`` that
        :class:`..models.MultimodalTransformerModel` loads strictly (the JAX
        method returns the same model's flax variables); sharded, broadcast
        from the rank that holds it (every rank must call it)."""
        def one(i: int) -> dict[str, torch.Tensor]:
            sd = {n: v[i].clone() for n, v in self._param_dict(self.params).items()
                  if n != TRAINER_CW}
            sd.update({n: v[i].clone() for n, v in self._stat_views.items()})
            return sd

        sd = self.blocks.from_owner(sid, one)
        sd.update({n: b.clone() for n, b in self.model.named_buffers()
                   if n.endswith("num_batches_tracked")})
        return sd

    def _state_tensors(self) -> dict[str, torch.Tensor]:
        """Every tensor of the state, by name: the rows, the optimizer's
        moments, step counts and lr lane, and with ``early_stop`` the
        schedule lanes and the best snapshots."""
        out = {"params": self.params, "stats": self.stats, "opt.mu": self.opt.mu,
               "opt.nu": self.opt.nu, "opt.count": self.opt.count, "opt.lr": self.opt.lr}
        if self.early_stop:
            out.update({f"sched.{k}": v for k, v in self.sched.items()})
            out.update(best_params=self.best_params, best_stats=self.best_stats)
        return out

    def save_state(self, path: str) -> str:
        """Write all ``n_total`` models' parameters and BN stats, the
        optimizer state, the dropout and plan generators, the host
        generator, and with ``early_stop`` the schedule lanes, best
        snapshots and epoch count. Sharded, every rank's block is gathered
        and rank 0 writes the one file, in the unsharded format (every rank
        must call it; the file exists on return)."""
        gather = self.blocks.gather
        state = {
            "tensors": {k: gather(t) for k, t in self._state_tensors().items()},
            "generator": generator_state(self.generator),
            "plan_generator": generator_state(self.plan_generator),
            "host_rng": self.host_rng.bit_generator.state,
            "early_stop": self.early_stop,
            "epochs_run": getattr(self, "_epochs_run", 0),
        }
        return save_on_rank0(path, state, self.generator, self.blocks.group)

    def restore_state(self, path: str) -> None:
        """Restore :meth:`save_state`'s file into this trainer's tensors in
        place (the forward's BN-stat views and the optimizer's column views
        stay bound to them); a sharded trainer keeps its block. The file
        must come from a trainer of the same ``n_total``, shapes, dtypes and
        ``early_stop``, on the same device type. Rank r's dropout generator
        takes rank r's state where the file has one (a file of fewer ranks
        leaves the others' streams as they are)."""
        state = load_checkpoint(path, "cpu")
        if state["early_stop"] != self.early_stop:
            raise ValueError(f"the file was saved with early_stop={state['early_stop']}, the "
                             f"trainer has early_stop={self.early_stop}")
        saved = state["tensors"]
        if saved["params"].shape[0] != self.n_total:
            raise ValueError(f"the file holds {saved['params'].shape[0]} models, the trainer "
                             f"{self.n_total}")
        restore_rank_generator(self.generator, state, self.blocks.rank)
        set_generator_state(self.plan_generator, state["plan_generator"], "plan_generator")
        for name, t in self._state_tensors().items():
            copy_state_(t, self.blocks.local(saved[name]), name)
        self.host_rng.bit_generator.state = state["host_rng"]
        if self.early_stop:
            self._epochs_run = state["epochs_run"]

    # ------------------------------------------------------------------
    # one model's functions, vmapped over the model axis
    def _loss_one(self, row, stats, batch):
        """One model's train-mode loss in the compute dtype; the
        trainer-level contrastive weight stays fp32."""
        cw = self._param_dict(row)[TRAINER_CW]
        params = self._param_dict(cast_floating(row, self.compute_dtype))
        params.pop(TRAINER_CW)
        mask = batch["mask"]
        outs = functional_call(self.model, {**params, **stats},
                               tuple(cast_floating(batch[k], self.compute_dtype)
                                     for k in ("eeg", "eye", "pps")),
                               {"labels": (batch["arousal"], batch["valence"], mask),
                                "generator": self.generator})
        loss, a_acc, v_acc = _objective(outs, batch, mask, cw)
        n = mask.sum()
        return loss, torch.stack([loss * n, a_acc * n, v_acc * n, n])

    def _te_one(self, row, stats, batch):
        """Held-out loss and accuracies in eval mode (the LOSO test rows fit
        one batch), the sequential trainer's test objective."""
        params = self._param_dict(row)
        cw = params.pop(TRAINER_CW)
        mask = torch.ones(batch["arousal"].shape[0], device=row.device)
        outs = functional_call(self.model, {**params, **stats},
                               (batch["eeg"], batch["eye"], batch["pps"]),
                               {"labels": (batch["arousal"], batch["valence"], mask)})
        return torch.stack(_objective(outs, batch, mask, cw))

    def _accuracy_one(self, row, stats, batch):
        params = self._param_dict(row)
        params.pop(TRAINER_CW)
        a, v = functional_call(self.model, {**params, **stats},
                               (batch["eeg"], batch["eye"], batch["pps"]))
        ones = torch.ones(a.shape[0], device=row.device)
        return torch.stack([masked_accuracy(a, batch["arousal"], ones),
                            masked_accuracy(v, batch["valence"], ones)])

    # ------------------------------------------------------------------
    # training
    def _gather(self, idx: torch.Tensor) -> dict[str, torch.Tensor]:
        """Rows ``idx (S, B)`` of every array: ``(S, B, ...)``."""
        return self.data.gather(idx)

    def _train_step(self, idx: torch.Tensor, mask: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
        """One step of every model on its batch ``idx (S, B)``; returns the
        masked metric sums ``(S, 4)``, zero for skipped models."""
        batch = self._gather(idx)
        batch["mask"] = mask
        old_stats = self.stats.clone()
        grads, (loss, sums) = self._grad_step(self.params, self._stat_views, batch)
        ok = torch.isfinite(loss) & active
        self.opt.step(self.params, clip_rows_by_global_norm(grads, self.clip_norm), ok)
        self.stats.copy_(torch.where(ok[:, None], self.stats, old_stats))
        return torch.where(ok[:, None], sums, 0.0)

    def _run_epoch(self, plans: torch.Tensor, masks: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
        """Every step of one epoch's plans ``(S, nb, B)`` of this rank's
        models; masked sums ``(S, 4)``."""
        self.model.train()
        totals = torch.zeros(self.n_local, 4, device=self.device)
        for j in range(plans.shape[1]):
            totals += self._train_step(plans[:, j], masks[:, j], active)
        return totals

    def _active(self) -> torch.Tensor:
        return ~self.sched["stopped"] if self.early_stop else self._all_active

    def _epoch_plans(self) -> tuple[np.ndarray, np.ndarray]:
        """Every model's shuffled batch plans ``(n_total, nb, B)`` and
        validity masks, drawn from ``host_rng`` exactly as the JAX trainer
        draws them: one permutation per model, tiled to whole batches, the
        padding masked."""
        n_train = self.train_idx.shape[1]
        bsz = self.batch_size
        nb = -(-n_train // bsz)
        padded = nb * bsz
        reps = -(-padded // n_train)
        plans = np.empty((self.n_total, nb, bsz), np.int32)
        for s in range(self.n_total):
            order = np.tile(self.host_rng.permutation(n_train), reps)[:padded]
            plans[s] = self.train_idx[s][order].reshape(nb, bsz)
        masks = np.broadcast_to(
            (np.arange(padded) < n_train).astype(np.float32).reshape(nb, bsz),
            plans.shape,
        ).copy()
        return plans, masks

    def _global(self, local: torch.Tensor, dim: int = 0) -> np.ndarray:
        """Every rank's block of ``local`` along ``dim``, the real subjects'
        rows, on the host."""
        out = self.blocks.gather(local, dim).cpu().numpy()
        return out[(slice(None),) * dim + (slice(0, self.n_subjects),)]

    def train_epoch(self) -> dict[str, np.ndarray]:
        """One epoch of every model on host-drawn plans; per-subject
        per-sample ``loss``, ``a_acc``, ``v_acc`` ``(n_subjects,)``."""
        plans, masks = (self.blocks.local(a) for a in self._epoch_plans())
        totals = self._run_epoch(torch.as_tensor(plans, device=self.device),
                                 torch.as_tensor(masks, device=self.device), self._active())
        return _per_sample(self._global(totals))

    def _device_plans(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One epoch's plans drawn on the device for all ``n_total`` models,
        this rank's block ``(S, nb, B)`` kept."""
        plans, masks = [], []
        for rows in self._train_rows:
            idx, mask = epoch_plan_on_device(self.plan_generator, rows.shape[0],
                                             self.batch_size)
            plans.append(rows[idx.long()])
            masks.append(mask)
        return self.blocks.local(torch.stack(plans)), self.blocks.local(torch.stack(masks))

    # ------------------------------------------------------------------
    # evaluation and the early-stop lanes
    @torch.no_grad()
    def _te_metrics(self) -> torch.Tensor:
        """``(S, 3)`` held-out loss and accuracies, on the device."""
        self.model.eval()
        return vmap(self._te_one)(self.params, self._stat_views, self._gather(self._test_rows))

    @torch.no_grad()
    def evaluate(self, best: bool = False) -> dict[str, np.ndarray]:
        """Per-subject held-out accuracies ``(n_subjects,)``; ``best=True``
        evaluates each subject's best-checkpoint snapshot instead of the
        final state."""
        if best and not self.early_stop:
            raise ValueError("best=True requires early_stop=True")
        params, stats = (self.best_params, self.best_stats) if best else (self.params, self.stats)
        self.model.eval()
        out = self._global(vmap(self._accuracy_one)(params, self._stat_dict(stats),
                                                    self._gather(self._test_rows)))
        return {"a_acc": out[:, 0], "v_acc": out[:, 1]}

    def _es_step(self, epoch: int) -> torch.Tensor:
        """After a training epoch: held-out losses, the schedule transition,
        the next epoch's LR lanes and the best snapshots, all on the device.
        Returns the ``(S, 3)`` held-out metrics."""
        te = self._te_metrics()
        self.sched, improved = vector_schedule_step(self.sched, te[:, 0], epoch, **self._es_cfg)
        self.opt.lr = self.sched["lr"]
        keep = improved[:, None]
        self.best_params = torch.where(keep, self.params, self.best_params)
        self.best_stats = torch.where(keep, self.stats, self.best_stats)
        return te

    def _host_es_epoch(self, epoch_num: int) -> dict[str, np.ndarray]:
        """One early-stop epoch on host-drawn plans: train (stopped subjects
        frozen), then the same transition :meth:`train_epochs_fused` runs."""
        tm = self.train_epoch()
        te = self._global(self._es_step(epoch_num))
        self._epochs_run = epoch_num
        return {**tm, **{k: te[:, j] for j, k in enumerate(_TE_KEYS)}}

    def fused_epochs_on_device(self, n_epochs: int) -> torch.Tensor:
        """The epochs of :meth:`train_epochs_fused` with nothing read back to
        the host: per epoch and model of this rank the masked sums ``(E, S,
        4)``, and with ``early_stop`` also the held-out metrics, ``lr`` and
        ``stopped`` (``(E, S, 9)``), on the device."""
        rows = []
        for e in range(n_epochs):
            plans, masks = self._device_plans()
            row = [self._run_epoch(plans, masks, self._active())]
            if self.early_stop:
                row += [self._es_step(self._epochs_run + e + 1), self.sched["lr"][:, None],
                        self.sched["stopped"][:, None].to(torch.float32)]
            rows.append(torch.cat(row, 1))
        if self.early_stop:
            self._epochs_run += n_epochs
        return torch.stack(rows)

    def train_epochs_fused(self, n_epochs: int) -> dict[str, np.ndarray]:
        """``n_epochs`` epochs with plans drawn on the device from
        ``plan_generator`` (deterministic in ``seed``, independent of the
        host stream :meth:`train_epoch` consumes) and nothing read back to
        the host until the end; returns per-epoch per-subject metrics
        ``(E, S)``. With ``early_stop`` the schedule lanes advance after
        every epoch and the result gains ``te_loss``/``te_a_acc``/
        ``te_v_acc``/``lr``/``stopped``."""
        out = self._global(self.fused_epochs_on_device(n_epochs), dim=1)
        result = _per_sample(out[..., :4])
        if self.early_stop:
            result.update({k: out[..., 4 + j] for j, k in enumerate(_TE_KEYS)})
            result["lr"] = out[..., 7]
            result["stopped"] = out[..., 8] > 0
        return result

    def stop_report(self) -> str:
        """Per-subject stop epochs, the vectorized analog of the reference
        run log's 'Early stopping triggered at epoch N' lines."""
        stop = self._global(self.sched["stop_epoch"])
        lines = [f"  subject {s}: " + (f"early-stopped at epoch {int(e)}" if e > 0
                                       else f"ran all {self._epochs_run} epochs")
                 for s, e in enumerate(stop)]
        stopped = stop[stop > 0]
        head = (f"Early stopping: {stopped.size}/{stop.size} subjects stopped"
                + (f" (epochs {int(stopped.min())}-{int(stopped.max())}, "
                   f"median {float(np.median(stopped)):.1f})" if stopped.size else ""))
        return "\n".join([head] + lines)

    def run(self, epochs: int, verbose: bool = True, fused: bool = False,
            chunk: int | None = None) -> dict:
        """Train all LOSO models; returns mean held-out accuracies. With
        ``early_stop``, ``epochs`` is an upper bound: training ends once
        every subject has stopped (checked between fused chunks of
        ``chunk`` epochs, default 8), and the result carries the stop epochs
        and the best-checkpoint accuracies."""
        if self.early_stop:
            if fused:
                chunk = min(chunk or 8, epochs)
                done = 0
                while done < epochs:
                    n = min(chunk, epochs - done)
                    tm = self.train_epochs_fused(n)
                    for e in range(n):
                        done += 1
                        if verbose:
                            print(f"Epoch {done}: mean train loss {tm['loss'][e].mean():.4f} "
                                  f"te_loss {tm['te_loss'][e].mean():.4f} "
                                  f"stopped {int(tm['stopped'][e].sum())}/{self.n_subjects}")
                    if tm["stopped"][-1].all():
                        break
            else:
                for epoch in range(1, epochs + 1):
                    tm = self._host_es_epoch(epoch)
                    stopped = self._global(self.sched["stopped"])
                    if verbose:
                        print(f"Epoch {epoch}: mean train loss {tm['loss'].mean():.4f} "
                              f"te_loss {tm['te_loss'].mean():.4f} "
                              f"stopped {int(stopped.sum())}/{self.n_subjects}")
                    if stopped.all():
                        break
            if verbose:
                print(self.stop_report())
            ev, final = self.evaluate(best=True), self.evaluate()
            result = {
                "mean_arousal_acc": float(ev["a_acc"].mean()),
                "mean_valence_acc": float(ev["v_acc"].mean()),
                "per_subject_arousal": ev["a_acc"],
                "per_subject_valence": ev["v_acc"],
                "final_arousal_acc": float(final["a_acc"].mean()),
                "final_valence_acc": float(final["v_acc"].mean()),
                "stop_epochs": self._global(self.sched["stop_epoch"]),
            }
            if verbose:
                print(f"LOSO mean (best checkpoints): arousal {result['mean_arousal_acc']:.2%} "
                      f"valence {result['mean_valence_acc']:.2%}")
            return result
        if fused:
            tm = self.train_epochs_fused(epochs)
            if verbose:
                for e in range(epochs):
                    print(f"Epoch {e + 1}: mean train loss {tm['loss'][e].mean():.4f} "
                          f"a_acc {tm['a_acc'][e].mean():.2%}")
        else:
            for epoch in range(1, epochs + 1):
                tm = self.train_epoch()
                if verbose:
                    print(f"Epoch {epoch}: mean train loss {tm['loss'].mean():.4f} "
                          f"a_acc {tm['a_acc'].mean():.2%}")
        ev = self.evaluate()
        result = {
            "mean_arousal_acc": float(ev["a_acc"].mean()),
            "mean_valence_acc": float(ev["v_acc"].mean()),
            "per_subject_arousal": ev["a_acc"],
            "per_subject_valence": ev["v_acc"],
        }
        if verbose:
            print(f"LOSO mean: arousal {result['mean_arousal_acc']:.2%} "
                  f"valence {result['mean_valence_acc']:.2%}")
        return result

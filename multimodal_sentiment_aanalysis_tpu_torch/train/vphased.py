"""Vectorized phased-curriculum LOSO: every subject's curriculum at once.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/vphased.py``. The
reference's flagship experiment trains the 5-phase curriculum once per
held-out subject, 24 sequential ``MultiTaskTrainer.run`` calls
(``main.py:62-68``). Every LOSO split has the same shapes and each
subject's curriculum is independent, so the S models train together, as in
:class:`.vloso.VectorizedLOSOTrainer`: ``torch.func.vmap`` of
``grad_and_value`` of one model's phase loss (:func:`.multitask.make_phase_loss`)
through ``functional_call``, with ``randomness="different"`` so each model
draws its own dropout masks from the trainer's device generator. Every
hand-written kernel on the path makes one launch for all S models.

Per subject the semantics are :class:`.multitask.MultiTaskTrainer`'s in
parity mode: the phase-3 asymmetry, the per-epoch optimizer reset, the
constant per-phase LR, a test evaluation after every epoch, no NaN skip.
Subject ``s`` is initialised from ``torch.Generator().manual_seed(
subject_seeds[s])`` (default ``seed + s``) and shuffles its plans with its
own numpy generator, exactly as ``MultiTaskTrainer(seed=subject_seeds[s])``
does; :meth:`_phase_plans` draws them in JAX's order, so the plans are
bit-equal to the JAX trainer's.

State: the S models' parameters are the rows of one ``(S, N)`` tensor and
their BatchNorm running stats the rows of one ``(S, M)`` tensor
(:class:`.state.RowLayout`). In a step the parameters outside the phase's
grad set enter the loss detached, so their gradient columns are zero and
autograd never runs the backward of an encoder the phase's loss does not
need (an ``eye`` step launches none of the EEG encoder's backward kernels);
the clip is per row over the grad set, and :class:`.state.StackedAdamW`
updates the update set's columns only (``columns``), so every other column
stays bit for bit as it was.

:meth:`run_phase_on_device` runs E epochs of a phase with nothing read back
to the host: per epoch the optimizer reset (parity mode), the LR set from the
``(S,)`` schedule lane, the steps, the freeze of early-stopped subjects, the
test evaluation and :func:`..utils.schedule.vector_schedule_step`;
:meth:`run_phase` is it plus the one read-back. The lanes and epoch offsets of
each phase persist across calls. The improvement switches:
``reset_optimizer_each_epoch=False`` (moments kept through a phase, plateau
LR per subject at the phase's patience and factor) and ``early_stop`` with
``es_patience``; their defaults keep parity (both patiences at 10**9).

``compute_dtype="bfloat16"`` keeps the fp32 master row and casts it to bf16
for each step's loss, inputs too; losses, metrics and BatchNorm stats stay
fp32, and the evaluation runs in fp32 on the master row, as in JAX.
``rng_impl`` is accepted and recorded only: the dropout stream is the device
generator whatever it says. :meth:`save_state` / :meth:`restore_state`
checkpoint the curriculum at any phase boundary or between a phase's calls
(JAX ``vphased.py:466-540``): the optimizer is built anew at each
:meth:`run_phase_on_device`, so it is no part of the state.
:meth:`save_checkpoints` writes each subject's model under the name the
sequential CLI run gives it.

Subject sharding, ``mesh=`` (JAX ``vphased.py:126-216``), as
:class:`.vloso.VectorizedLOSOTrainer`'s: the subject axis padded to
``n_total``, a multiple of the mesh's W ranks (padding model ``s`` is
subject ``s % n_subjects``: its seed, split and host generator), one
contiguous block of models per rank, every rank drawing all ``n_total``
initialisations and plans and keeping its block. Each subject shuffles
with its own generator, so the real subjects' plans are the unsharded
run's whatever the padding. A step has no collective; the metrics,
:meth:`run`'s results, :meth:`stop_report`, :meth:`subject_variables`,
:meth:`save_state` (one file, rank 0 writes) and :meth:`save_checkpoints`
(rank 0 writes) are global, and every rank must call them. Each rank's
dropout generator is its own (rank 0's is the unsharded one): W > 1 ranks
equal the unsharded run at dropout 0.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call, grad_and_value, vmap

from ..data.pipeline import DeviceDataset, epoch_batch_indices, host_to_device
from ..data.splits import loso_split
from ..parallel.mesh import SubjectBlocks, rank_seed, restore_rank_generator, save_on_rank0
from ..utils.checkpoint import (
    copy_state_,
    generator_state,
    load_checkpoint,
    metrics_checkpoint_name,
    save_checkpoint,
)
from ..utils.schedule import vector_schedule_init, vector_schedule_step
from .multitask import METRIC_KEYS, PHASE_ORDER, PHASES, eval_sums, make_phase_loss
from .state import (
    RowLayout,
    StackedAdamW,
    as_dtype,
    cast_floating,
    clip_rows_by_global_norm,
    module_mask,
)


class VectorizedPhasedTrainer:
    """Trains the 5-phase curriculum for every held-out subject at once, on
    ``data``'s device."""

    def __init__(
        self,
        model: nn.Module,
        data: DeviceDataset,
        n_subjects: int,
        ex_nums: int = 20,
        lr: float = 1e-4,
        weight_decay: float = 1e-4,
        batch_size: int = 64,
        clip_norm: float = 1.0,
        seed: int = 42,
        subject_seeds: list[int] | None = None,
        rng_impl: str | None = None,
        compute_dtype: str | torch.dtype | None = None,
        mesh=None,
        verbose: bool = True,
        reset_optimizer_each_epoch: bool = True,
        early_stop: bool = False,
        es_patience: int = 5,
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
        self.lr = lr
        self.weight_decay = weight_decay
        self.batch_size = batch_size
        self.clip_norm = clip_norm
        self.compute_dtype = as_dtype(compute_dtype)
        self.verbose = verbose
        self.rng_impl = rng_impl  # recorded only: dropout draws from self.generator
        self.reset_optimizer_each_epoch = reset_optimizer_each_epoch
        self.early_stop = early_stop
        self.es_patience = es_patience
        if subject_seeds is None:
            # fresh init per subject (reference main.py:66)
            subject_seeds = [seed + s for s in range(n_subjects)]
        if len(subject_seeds) != n_subjects:
            raise ValueError(f"{len(subject_seeds)} subject seeds for {n_subjects} subjects")
        # padding models (mesh rounding) duplicate subject s % n_subjects
        self.subject_seeds = [subject_seeds[blocks.subject(s)] for s in range(self.n_total)]

        splits = [loso_split(n_subjects, ex_nums, blocks.subject(s)) for s in range(self.n_total)]
        self.train_idx = np.stack([tr for tr, _ in splits])  # (n_total, n_train)
        self.test_idx = np.stack([te for _, te in splits])   # (n_total, ex_nums)
        # the stream MultiTaskTrainer(seed=subject_seeds[s]) shuffles with
        self.host_rngs = [np.random.default_rng(s) for s in self.subject_seeds]

        self.layout = RowLayout(self.model)
        rows = []
        with torch.no_grad():
            for s in blocks.local(self.subject_seeds):
                self.model.reset_parameters(torch.Generator().manual_seed(s))
                rows.append(torch.cat([p.reshape(-1) for p in self.model.parameters()]))
        self.params = torch.stack(rows)  # (S, N), S = n_local
        buffers = dict(self.model.named_buffers())
        self.stats = torch.cat([buffers[n].reshape(-1) for n in self.layout.stat_names]
                               ).repeat(self.n_local, 1)  # (S, M)
        self._stat_views = self.layout.stats(self.stats)  # written in place by the forward
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, blocks.rank))

        # static per-subject test plan (shuffle=False), global rows
        t_local, t_mask = epoch_batch_indices(ex_nums, batch_size, shuffle=False)
        self._test_rows = torch.as_tensor(blocks.local(self.test_idx)[:, t_local],
                                          device=self.device)
        self._test_mask = torch.as_tensor(
            np.broadcast_to(t_mask, (self.n_local, *t_mask.shape)).copy(), device=self.device)

        self.opt: StackedAdamW | None = None
        self._grad_fns: dict[str, Any] = {}
        self._phase_sched: dict[str, dict[str, torch.Tensor]] = {}
        self._phase_epochs: dict[str, int] = {}
        self._last_hist: dict[str, np.ndarray] = {}
        self._last_test: dict[str, np.ndarray] = {}
        self.metrics: dict[str, dict[str, list]] = {
            split: {k: [] for k in METRIC_KEYS} for split in ("train", "test")}

    # ------------------------------------------------------------------
    # state
    @torch.no_grad()
    def load_stacked_state(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Every model's parameters and BatchNorm running stats from a
        reference-named ``state_dict`` whose tensors carry a leading axis of
        all ``n_total`` models (e.g.
        :func:`..models.jax_import.phased_state_from_jax` of the JAX
        trainer's stacked init); a sharded trainer keeps its block."""
        for name, view in self.layout.params(self.params).items():
            view.copy_(self.blocks.local(state_dict[name]))
        for name, view in self._stat_views.items():
            view.copy_(self.blocks.local(state_dict[name]))

    def subject_variables(self, sid: int) -> dict[str, torch.Tensor]:
        """Subject ``sid``'s model as a reference-named ``state_dict`` that
        :class:`..models.MultimodalTransformerModel` loads strictly (the JAX
        method returns the same model's flax variables); sharded, broadcast
        from the rank that holds it (every rank must call it)."""
        def one(i: int) -> dict[str, torch.Tensor]:
            sd = {n: v[i].clone() for n, v in self.layout.params(self.params).items()}
            sd.update({n: v[i].clone() for n, v in self._stat_views.items()})
            return sd

        sd = self.blocks.from_owner(sid, one)
        sd.update({n: b.clone() for n, b in self.model.named_buffers()
                   if n.endswith("num_batches_tracked")})
        return sd

    # ------------------------------------------------------------------
    # one model's functions, vmapped over the model axis
    def _grad_fn(self, phase: str):
        """``vmap(grad_and_value)`` of one model's loss of ``phase``: the
        parameters outside the grad set enter detached."""
        if phase not in self._grad_fns:
            spec = PHASES[phase]
            grad_mask = module_mask(self.layout.names, spec.grad_modules)
            loss_fn = make_phase_loss(self.model, spec.loss, self.compute_dtype)

            def loss_one(row, stats, batch):
                views = self.layout.params(cast_floating(row, self.compute_dtype))
                params = {n: v if grad_mask[n] else v.detach() for n, v in views.items()}
                return loss_fn(params, stats, batch, self.generator)

            self._grad_fns[phase] = vmap(grad_and_value(loss_one, has_aux=True),
                                         randomness="different")
        return self._grad_fns[phase]

    def _eval_one(self, row, stats, batch, mask):
        outs = functional_call(self.model, {**self.layout.params(row), **stats},
                               (batch["eeg"], batch["eye"], batch["pps"]),
                               {"labels": (batch["arousal"], batch["valence"], mask)})
        return eval_sums(outs, batch, mask)

    # ------------------------------------------------------------------
    # training
    def _gather(self, idx: torch.Tensor) -> dict[str, torch.Tensor]:
        """Rows ``idx (S, B)`` of every array: ``(S, B, ...)``."""
        return self.data.gather(idx)

    def _clipped_grads(self, phase: str, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Every model's gradient of ``phase`` on ``batch`` (with its
        ``mask``), zero outside the grad set and clipped per row over it,
        and the ``(S, 7)`` metric sums; moves the BatchNorm running stats."""
        grads, (_, sums) = self._grad_fn(phase)(self.params, self._stat_views, batch)
        return clip_rows_by_global_norm(grads, self.clip_norm), sums

    def _phase_optimizer(self, phase: str) -> StackedAdamW:
        """A fresh masked AdamW over ``phase``'s update set (JAX ``tx.init``)."""
        return StackedAdamW(self.params, self.lr, self.weight_decay,
                            columns=self.layout.columns(PHASES[phase].update_modules))

    def _train_step(self, phase: str, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One step of every model on its batch ``idx (S, B)``; returns the
        ``(S, 7)`` metric sums."""
        batch = self._gather(idx)
        batch["mask"] = mask
        grads, sums = self._clipped_grads(phase, batch)
        self.opt.step(self.params, grads)
        return sums

    @torch.no_grad()
    def _eval_sums(self) -> torch.Tensor:
        """``(S, 7)`` test metric sums of this rank's models in eval mode on
        the fp32 master row."""
        self.model.eval()
        sums = torch.zeros(self.n_local, 7, device=self.device)
        for j in range(self._test_rows.shape[1]):
            sums += vmap(self._eval_one)(self.params, self._stat_views,
                                         self._gather(self._test_rows[:, j]),
                                         self._test_mask[:, j])
        return sums

    def _phase_plans(self, epochs: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-model, per-epoch shuffled batch plans in global row ids,
        ``(n_total, E, nb, B)``, and their masks, drawn from each model's own
        host generator in the order the sequential trainer draws them."""
        n_train = self.train_idx.shape[1]
        nb = -(-n_train // self.batch_size)
        idx = np.empty((self.n_total, epochs, nb, self.batch_size), np.int32)
        msk = np.empty_like(idx, np.float32)
        for s in range(self.n_total):
            for e in range(epochs):
                local, m = epoch_batch_indices(n_train, self.batch_size, self.host_rngs[s],
                                               shuffle=True)
                idx[s, e] = self.train_idx[s][local]
                msk[s, e] = m
        return idx, msk

    def run_phase_on_device(self, phase: str, epochs: int) -> dict[str, torch.Tensor]:
        """``epochs`` epochs of ``phase`` for every subject with nothing read
        back to the host (the plans are drawn on the host first). Returns, on
        the device, the train and test metric sums ``(S, E, 7)`` and the
        ``lr`` and ``stopped`` lanes after each epoch ``(S, E)`` of this
        rank's models."""
        spec = PHASES[phase]
        plans, masks = (host_to_device(np.ascontiguousarray(self.blocks.local(a)), self.device)
                        for a in self._phase_plans(epochs))
        if phase not in self._phase_sched:
            self._phase_sched[phase] = vector_schedule_init(self.n_local, self.lr, self.device)
            self._phase_epochs[phase] = 0
        sched, epoch0 = self._phase_sched[phase], self._phase_epochs[phase]
        # the schedule lanes: parity mode (the defaults) keeps both patiences
        # out of reach, so the lr stays constant and no subject stops
        reset_opt = self.reset_optimizer_each_epoch
        cfg = dict(es_patience=self.es_patience if self.early_stop else 10 ** 9,
                   plateau_patience=10 ** 9 if reset_opt else spec.sched_patience,
                   plateau_factor=spec.sched_factor)
        self.opt = self._phase_optimizer(phase)
        out = {"train": [], "test": [], "lr": [], "stopped": []}
        for e in range(epochs):
            if reset_opt:
                self.opt.reset()  # reference parity: fresh moments every epoch
            self.opt.lr = sched["lr"]
            if self.early_stop:
                active = ~sched["stopped"]
                before = [t.clone() for t in (self.params, self.stats, self.opt.mu, self.opt.nu,
                                              self.opt.count)]
            self.model.train()
            sums = torch.zeros(self.n_local, 7, device=self.device)
            for j in range(plans.shape[2]):
                sums += self._train_step(phase, plans[:, e, j], masks[:, e, j])
            if self.early_stop:
                # early-stopped subjects freeze (their sequential loop would
                # have left this phase)
                with torch.no_grad():
                    for t, old in zip((self.params, self.stats, self.opt.mu, self.opt.nu), before):
                        t.copy_(torch.where(active[:, None], t, old))
                self.opt.count = torch.where(active, self.opt.count, before[4])
            te = self._eval_sums()
            sched, _ = vector_schedule_step(sched, te[:, 0] / te[:, 6].clamp_min(1.0),
                                            epoch0 + e + 1, **cfg)
            for key, value in (("train", sums), ("test", te), ("lr", sched["lr"]),
                               ("stopped", sched["stopped"])):
                out[key].append(value)
        self._phase_sched[phase] = sched
        self._phase_epochs[phase] = epoch0 + epochs
        return {k: torch.stack(v, 1) for k, v in out.items()}

    def record_phase(self, phase: str, out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """Reads :meth:`run_phase_on_device`'s result back (every rank's
        block): appends the per-epoch, per-subject metrics to :attr:`metrics`
        and returns the last epoch's per-subject test metrics."""
        real = lambda t: self.blocks.gather(t).cpu().numpy()[: self.n_subjects]
        tr, te = real(out["train"]), real(out["test"])
        self._last_hist = {k: real(out[k]) for k in ("lr", "stopped")}  # (n_subjects, E)
        tn, en = np.maximum(tr[..., 6], 1.0), np.maximum(te[..., 6], 1.0)
        for e in range(tr.shape[1]):
            for j, k in enumerate(METRIC_KEYS):
                self.metrics["train"][k].append(tr[:, e, j] / tn[:, e])
                self.metrics["test"][k].append(te[:, e, j] / en[:, e])
        if self.verbose:
            mt = {k: float(np.mean(self.metrics["train"][k][-1])) for k in METRIC_KEYS}
            me = {k: float(np.mean(self.metrics["test"][k][-1])) for k in METRIC_KEYS}
            print(f"[{phase}] {tr.shape[1]} epochs x {self.n_subjects} subjects | "
                  f"final mean train loss {mt['loss']:.4f} || test loss "
                  f"{me['loss']:.4f} a_acc {me['a_acc']:.2%} v_acc {me['v_acc']:.2%}")
        self._last_test = {k: te[:, -1, j] / en[:, -1] for j, k in enumerate(METRIC_KEYS)}
        return self._last_test

    def run_phase(self, phase: str, epochs: int) -> dict[str, np.ndarray]:
        """All subjects through ``epochs`` epochs of one curriculum phase;
        returns the final epoch's per-subject test metrics."""
        if epochs <= 0:
            return {}
        return self.record_phase(phase, self.run_phase_on_device(phase, epochs))

    def run(self, epochs_phase_eeg: int, epochs_phase_eye: int, epochs_phase_pps: int,
            epochs_phase2: int, epochs_phase3: int) -> dict[str, Any]:
        """Full curriculum for every subject (reference
        ``MultiTaskTrainer.run`` x 24, ``main.py:62-68``). Returns the
        per-subject and mean final test accuracies."""
        for phase, epochs in zip(PHASE_ORDER, (epochs_phase_eeg, epochs_phase_eye,
                                               epochs_phase_pps, epochs_phase2, epochs_phase3)):
            self.run_phase(phase, epochs)
        last = self._last_test
        if not last:  # all-zero-epoch curriculum
            nan = np.full((self.n_subjects,), np.nan)
            last = {k: nan for k in METRIC_KEYS}
        return {
            "mean_arousal_acc": float(np.mean(last["a_acc"])),
            "mean_valence_acc": float(np.mean(last["v_acc"])),
            "per_subject_arousal": last["a_acc"],
            "per_subject_valence": last["v_acc"],
        }

    def stop_report(self, phase: str) -> str:
        """Per-subject stop-epoch lines for one phase (the vectorized analog
        of the reference's 'Early stopping triggered!' prints)."""
        stop = self.blocks.gather(self._phase_sched[phase]["stop_epoch"]).cpu().numpy()
        stop = stop[: self.n_subjects]
        ran = self._phase_epochs.get(phase, 0)
        lines = [f"  subject {s}: " + (f"early-stopped at phase epoch {int(e)}" if e > 0
                                       else f"ran all {ran} phase epochs")
                 for s, e in enumerate(stop)]
        stopped = stop[stop > 0]
        return "\n".join([f"[{phase}] early stopping: {stopped.size}/{stop.size} "
                          f"subjects stopped"] + lines)

    # ------------------------------------------------------------------
    # checkpoints
    def save_state(self, path: str) -> str:
        """Write every model's parameters and BN stats, the dropout
        generator, the per-model host generators, each phase's epoch count
        and schedule lanes, the metrics and the last phase's results.
        Sharded, rank 0 writes the one file, in the unsharded format, with
        every rank's block and dropout generator (every rank must call it;
        the file exists on return)."""
        tensors = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
        gather = self.blocks.gather
        state = {
            "params": gather(self.params),
            "stats": gather(self.stats),
            "generator": generator_state(self.generator),
            "host_rngs": [r.bit_generator.state for r in self.host_rngs],
            "phase_epochs": dict(self._phase_epochs),
            "phase_sched": {ph: {k: gather(v) for k, v in sd.items()}
                            for ph, sd in self._phase_sched.items()},
            "metrics": {split: {k: [torch.from_numpy(np.asarray(a)) for a in v]
                                for k, v in d.items()} for split, d in self.metrics.items()},
            "last_test": tensors(self._last_test),
            "last_hist": tensors(self._last_hist),
        }
        return save_on_rank0(path, state, self.generator, self.blocks.group)

    def restore_state(self, path: str) -> None:
        """Restore :meth:`save_state`'s file: the rows in place (the
        forward's BN-stat views stay bound to them; a sharded trainer keeps
        its block of a file with its ``n_total`` models), the rest as saved,
        the lanes on this trainer's device. Rank r's dropout generator takes
        rank r's state where the file has one."""
        state = load_checkpoint(path, "cpu")
        if state["params"].shape[0] != self.n_total:
            raise ValueError(f"the file holds {state['params'].shape[0]} models, the trainer "
                             f"{self.n_total}")
        restore_rank_generator(self.generator, state, self.blocks.rank)
        copy_state_(self.params, self.blocks.local(state["params"]), "params")
        copy_state_(self.stats, self.blocks.local(state["stats"]), "stats")
        for rng, st in zip(self.host_rngs, state["host_rngs"]):
            rng.bit_generator.state = st
        self._phase_epochs = dict(state["phase_epochs"])
        self._phase_sched = {ph: {k: self.blocks.local(v).to(self.device) for k, v in sd.items()}
                             for ph, sd in state["phase_sched"].items()}
        self.metrics = {split: {k: [t.numpy() for t in v] for k, v in d.items()}
                        for split, d in state["metrics"].items()}
        self._last_test = {k: v.numpy() for k, v in state["last_test"].items()}
        self._last_hist = {k: v.numpy() for k, v in state["last_hist"].items()}

    def save_checkpoints(self, checkpoint_dir: str) -> list[str]:
        """One ``state_dict`` file per subject (:meth:`subject_variables`),
        named as the sequential CLI run names it: ``TestPerson{sid}`` and the
        last phase's test accuracies (the JAX names, ``.pt`` for
        ``.msgpack``). Sharded, rank 0 writes them (every rank must call
        it)."""
        if not self._last_test:
            raise ValueError("no phase has run: there are no test accuracies to name the "
                             "checkpoints by")
        paths = []
        for sid in range(self.n_subjects):
            name = metrics_checkpoint_name(
                f"TestPerson{sid}", {"ArousalAcc": float(self._last_test["a_acc"][sid]),
                                     "ValenceAcc": float(self._last_test["v_acc"][sid])})
            sd = self.subject_variables(sid)
            paths.append(f"{checkpoint_dir}/{name}")
            if self.blocks.rank == 0:
                save_checkpoint(paths[-1], sd)
        return paths

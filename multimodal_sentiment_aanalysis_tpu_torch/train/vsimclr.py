"""Vectorized SimCLR LOSO: every subject's pretrain and finetune at once.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/vsimclr.py``. The
reference's second experiment stack (``train.py:141-205``) runs, for each of
the 24 held-out subjects in turn, a contrastive pretrain of encoder and
projector on that subject's balanced pairs, then a finetune of a classifier
on the frozen encoder's features (:mod:`.simclr`). Every LOSO split has the
same shapes and the runs are independent, so the S runs train together, as
in :class:`.vloso.VectorizedLOSOTrainer`: ``torch.func.vmap`` of
``grad_and_value`` of one model's loss through ``functional_call``, with
``randomness="different"`` so each model draws its own dropout masks from
the trainer's device generator. Every hand-written kernel on the path (the
stem tail and the BiLSTM, forward and backward) makes one launch for all S
models.

State: the S encoder-and-projector pairs are the rows of one ``(S, N)``
tensor (the encoder's parameters first, so the first ``n_encoder`` columns
are the encoder) and their BatchNorm running stats the rows of one ``(S,
M)`` tensor (the encoder's first); the S classifiers are the rows of one
``(S, Nc)`` tensor. Two :class:`.state.StackedAdamW` with no weight decay
(optax ``adam``): 1e-3 over the pair row, 1e-4 over the classifier row. No
clip, no NaN skip, no early stop, as in JAX.

Per subject the semantics are the sequential engines':

- tables: the LOSO split, the subject's pairs from
  :func:`..data.pairs.build_contrastive_pairs` at seed ``seed + s`` (local
  rows mapped to global), wrapped to the largest pair count: bit-equal to
  JAX's;
- :meth:`pretrain`: ``nb = ceil(max_pairs / B)`` steps an epoch, each
  subject's batch drawn from a fresh permutation of its own pairs wrapped
  modulo its count (:meth:`_pretrain_plans`); two train-mode views, the
  second's BatchNorm update from the first's stats, independent dropout
  masks per view;
- :meth:`finetune`: the encoder row frozen in eval mode, its features
  computed without a graph at every step; ``vmap(grad_and_value)`` of the
  classifier's loss alone; after each epoch the held-out rows (one batch)
  evaluated.

The plans of both stages are drawn on the host from one ``numpy`` generator
seeded with ``seed`` in JAX's order (all pretrain epochs first, then the
finetune epochs), so they are bit-equal to JAX's. :meth:`pretrain_epoch_on_device`
and :meth:`finetune_epoch_on_device` run an epoch with nothing read back to the
host. Subject ``s``'s weights are drawn from ``torch.Generator().manual_seed(
seed + s)`` (encoder and projector, then classifier). ``rng_impl`` is
accepted and recorded only: the dropout stream is the device generator
whatever it says.

Subject sharding, ``mesh=`` (JAX ``vsimclr.py:91-190``), as
:class:`.vloso.VectorizedLOSOTrainer`'s: the subject axis padded to
``n_total``, a multiple of the mesh's W ranks (padding model ``s`` is
subject ``s % n_subjects``: its split, pair table and init seed), one
contiguous block of models per rank. Every rank builds all ``n_total``
pair tables and draws every model's plans from the shared host generator,
keeping its block, so a sharded run trains on the unsharded run's batches
(with padding the generator draws ``n_total`` plans an epoch). A step has
no collective; :meth:`pretrain`, :meth:`finetune`, :meth:`run` and
:meth:`subject_variables` are global (every rank must call them). Each
rank's dropout generator is its own (rank 0's is the unsharded one), so W
> 1 ranks equal the unsharded run at dropout 0.
"""

from __future__ import annotations

import copy
import math
from typing import Any

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call, grad_and_value, vmap

from ..data.pairs import build_contrastive_pairs
from ..data.pipeline import DeviceDataset, host_to_device
from ..data.splits import loso_split, subject_ids_array
from ..models.fusion_model import init_parameters
from ..ops.losses import masked_accuracy, masked_cross_entropy, ntxent_supervised_two_view
from ..parallel.mesh import SubjectBlocks, rank_seed
from .memhacl import _check_device
from .state import RowLayout, StackedAdamW


class _EncoderProjector(nn.Module):
    """The pretrain model: ``projector(encoder(eeg, eye, pps))``."""

    def __init__(self, encoder: nn.Module, projector: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.projector = projector

    def forward(self, eeg, eye, pps, generator=None):
        return self.projector(self.encoder(eeg, eye, pps, generator), generator)


class VectorizedSimCLRTrainer:
    """Every held-out subject's contrastive pretrain and frozen finetune at
    once, on ``data``'s device. ``pretrain(epochs)`` then
    ``finetune(epochs)`` mirror the reference's per-subject pretrain and
    finetune; ``run(...)`` does both and returns the per-subject final
    accuracies."""

    def __init__(
        self,
        encoder: nn.Module,
        projector: nn.Module,
        classifier: nn.Module,
        data: DeviceDataset,
        n_subjects: int,
        ex_nums: int = 20,
        pretrain_lr: float = 1e-3,
        finetune_lr: float = 1e-4,
        batch_size: int = 64,
        temperature: float = 0.1,
        seed: int = 42,
        mesh=None,
        rng_impl: str | None = None,
        verbose: bool = True,
    ):
        self.device = data.device
        _check_device(self.device, encoder, projector, classifier)
        # the templates functional_call runs
        self.model = _EncoderProjector(copy.deepcopy(encoder), copy.deepcopy(projector))
        self.classifier = copy.deepcopy(classifier)
        self.data = data
        self.mesh = mesh
        self.blocks = blocks = SubjectBlocks(n_subjects, mesh)
        self.n_subjects, self.n_total, self.n_local = n_subjects, blocks.n_total, blocks.n_local
        self.batch_size = batch_size
        self.temperature = temperature
        self.verbose = verbose
        self.rng_impl = rng_impl  # recorded only: dropout draws from self.generator
        self.host_rng = np.random.default_rng(seed)

        # padding models (s >= n_subjects) reuse subject s % n_subjects
        splits = [loso_split(n_subjects, ex_nums, blocks.subject(s)) for s in range(self.n_total)]
        self.train_idx = np.stack([tr for tr, _ in splits])  # (n_total, n_train)
        self.test_idx = np.stack([te for _, te in splits])   # (n_total, ex_nums)
        self._test_rows = torch.as_tensor(blocks.local(self.test_idx), dtype=torch.long,
                                          device=self.device)

        # per-subject balanced pair sets in global rows, wrapped to the
        # largest pair count (every row is a real pair)
        arousal = data.arrays["arousal"].cpu().numpy()
        valence = data.arrays["valence"].cpu().numpy()
        sids = subject_ids_array(n_subjects, ex_nums)
        pair_rows, pair_labs = [], []
        for s, tr in enumerate(self.train_idx):
            pidx, plab = build_contrastive_pairs(arousal[tr], valence[tr], sids[tr],
                                                 seed=seed + blocks.subject(s))
            pair_rows.append(tr[pidx])
            pair_labs.append(plab)
        self.n_pairs = np.asarray([len(lab) for lab in pair_labs])  # (n_total,)
        wrap = np.arange(int(self.n_pairs.max()))
        self.pair_idx = np.stack([r[wrap % len(r)] for r in pair_rows]).astype(np.int32)
        self.pair_lab = np.stack([lab[wrap % len(lab)] for lab in pair_labs]).astype(np.float32)

        self.layout = RowLayout(self.model)
        self.clf_layout = RowLayout(self.classifier)
        self.enc_layout = RowLayout(self.model.encoder)
        self.n_encoder = sum(self.enc_layout.sizes)
        n_encoder_stats = sum(math.prod(shape) for shape in self.enc_layout.stat_shapes)
        rows, clf_rows = [], []
        with torch.no_grad():
            for s in range(blocks.lo, blocks.hi):
                gen = torch.Generator().manual_seed(seed + blocks.subject(s))
                init_parameters(self.model, gen)
                init_parameters(self.classifier, gen)
                rows.append(torch.cat([p.reshape(-1) for p in self.model.parameters()]))
                clf_rows.append(torch.cat([p.reshape(-1) for p in self.classifier.parameters()]))
        self.params = torch.stack(rows)          # (S, N), S = n_local
        self.clf_params = torch.stack(clf_rows)  # (S, Nc)
        buffers = dict(self.model.named_buffers())
        self.stats = torch.cat([buffers[n].reshape(-1) for n in self.layout.stat_names]
                               ).repeat(self.n_local, 1)  # (S, M)
        self._stat_views = self.layout.stats(self.stats)  # written in place by the forward
        # the frozen encoder's views: prefixes of the pair's rows
        self._enc_params = self.enc_layout.params(self.params[:, :self.n_encoder])
        self._enc_stats = self.enc_layout.stats(self.stats[:, :n_encoder_stats])

        self.pre_opt = StackedAdamW(self.params, pretrain_lr, 0.0)
        self.ft_opt = StackedAdamW(self.clf_params, finetune_lr, 0.0)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed + 1, blocks.rank))
        self._pretrain_grad = vmap(grad_and_value(self._pretrain_loss_one),
                                   randomness="different")
        self._finetune_grad = vmap(grad_and_value(self._finetune_loss_one),
                                   randomness="different")

    # ------------------------------------------------------------------
    # state
    @torch.no_grad()
    def load_stacked_state(self, encoder: dict[str, torch.Tensor], projector: dict[str, torch.Tensor],
                           classifier: dict[str, torch.Tensor]) -> None:
        """Every subject's parameters and BatchNorm running stats from the
        three modules' reference-named ``state_dict`` s whose tensors carry a
        leading axis of all ``n_total`` models (e.g.
        :func:`..models.jax_import.simclr_state_from_jax` of the JAX
        trainer's stacked init); a sharded trainer keeps its block."""
        local = self.blocks.local
        state = {**{f"encoder.{k}": v for k, v in encoder.items()},
                 **{f"projector.{k}": v for k, v in projector.items()}}
        for name, view in self.layout.params(self.params).items():
            view.copy_(local(state[name]))
        for name, view in self._stat_views.items():
            view.copy_(local(state[name]))
        for name, view in self.clf_layout.params(self.clf_params).items():
            view.copy_(local(classifier[name]))

    def subject_variables(self, sid: int) -> tuple[dict, dict, dict]:
        """Subject ``sid``'s encoder, projection head and classifier as
        reference-named ``state_dict`` s that the three modules load
        strictly; sharded, broadcast from the rank that holds it (every rank
        must call it)."""
        def one(i: int) -> dict[str, torch.Tensor]:
            state = {n: v[i].clone() for n, v in self.layout.params(self.params).items()}
            state.update({n: v[i].clone() for n, v in self._stat_views.items()})
            state.update({f"classifier.{n}": v[i].clone()
                          for n, v in self.clf_layout.params(self.clf_params).items()})
            return state

        state = self.blocks.from_owner(sid, one)
        state.update({n: b.clone() for n, b in self.model.named_buffers()
                      if n.endswith("num_batches_tracked")})
        return tuple({n.removeprefix(f"{part}."): v for n, v in state.items()
                      if n.startswith(f"{part}.")}
                     for part in ("encoder", "projector", "classifier"))

    # ------------------------------------------------------------------
    # one model's functions, vmapped over the model axis
    def _view_one(self, row, stats, view):
        """One model's projection of one view (train mode: moves the
        BatchNorm running stats)."""
        return functional_call(self.model, {**self.layout.params(row), **stats},
                               (view["eeg"], view["eye"], view["pps"]),
                               {"generator": self.generator})

    def _pretrain_loss_one(self, row, stats, view1, view2, labels):
        """One model's two-view loss in train mode; the second view's
        BatchNorm update starts from the first's."""
        z1 = self._view_one(row, stats, view1)
        z2 = self._view_one(row, stats, view2)
        return ntxent_supervised_two_view(z1, z2, labels, self.temperature)

    def _features_one(self, enc_params, enc_stats, batch):
        """One model's frozen features (eval mode, call without a graph)."""
        return functional_call(self.model.encoder, {**enc_params, **enc_stats},
                               (batch["eeg"], batch["eye"], batch["pps"]))

    def _finetune_loss_one(self, clf_row, feat, batch, mask):
        out_a, out_v = functional_call(self.classifier, self.clf_layout.params(clf_row), (feat,),
                                       {"generator": self.generator})
        return (masked_cross_entropy(out_a, batch["arousal"], mask)
                + masked_cross_entropy(out_v, batch["valence"], mask))

    def _accuracy_one(self, clf_row, feat, batch):
        out_a, out_v = functional_call(self.classifier, self.clf_layout.params(clf_row), (feat,))
        ones = torch.ones(out_a.shape[0], device=out_a.device)
        return torch.stack([masked_accuracy(out_a, batch["arousal"], ones),
                            masked_accuracy(out_v, batch["valence"], ones)])

    @torch.no_grad()
    def _features(self, batch: dict) -> torch.Tensor:
        """Every model's frozen features of its rows of ``batch``: ``(S, B, F)``."""
        self.model.eval()
        return vmap(self._features_one)(self._enc_params, self._enc_stats, batch)

    # ------------------------------------------------------------------
    # pretrain
    def _pretrain_plans(self) -> tuple[np.ndarray, np.ndarray]:
        """One epoch's pair plans of all ``n_total`` models, drawn from
        ``host_rng`` in JAX's order: global rows ``(n_total, nb, B, 2)``
        int32 and pair labels ``(n_total, nb, B)`` float32."""
        b = self.batch_size
        nb = -(-self.pair_idx.shape[1] // b)
        rows_all = np.empty((self.n_total, nb * b, 2), np.int32)
        labs_all = np.empty((self.n_total, nb * b), np.float32)
        for s in range(self.n_total):
            n = int(self.n_pairs[s])
            rows = self.host_rng.permutation(n)[np.arange(nb * b) % n]
            rows_all[s] = self.pair_idx[s, rows]
            labs_all[s] = self.pair_lab[s, rows]
        return rows_all.reshape(self.n_total, nb, b, 2), labs_all.reshape(self.n_total, nb, b)

    def pretrain_step(self, rows: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One step of every model on its pairs ``rows (S, B, 2)`` with pair
        labels ``(S, B)``; returns the ``(S,)`` losses."""
        self.model.train()
        grads, loss = self._pretrain_grad(self.params, self._stat_views,
                                          self.data.gather(rows[..., 0]),
                                          self.data.gather(rows[..., 1]), labels)
        self.pre_opt.step(self.params, grads)
        return loss

    def pretrain_epoch_on_device(self) -> torch.Tensor:
        """One pretrain epoch of this rank's models with nothing read back to
        the host (the plans are drawn on the host first); returns the
        ``(S,)`` mean losses, on the device."""
        rows, labels = (host_to_device(np.ascontiguousarray(self.blocks.local(a)), self.device)
                        for a in self._pretrain_plans())
        total = torch.zeros(self.n_local, device=self.device)
        for j in range(rows.shape[1]):
            total += self.pretrain_step(rows[:, j], labels[:, j])
        return total / rows.shape[1]

    def pretrain(self, num_epochs: int) -> list[np.ndarray]:
        """All subjects' contrastive pretraining; returns per-epoch
        ``(n_subjects,)`` mean losses."""
        history = []
        for epoch in range(num_epochs):
            loss = self.blocks.gather(self.pretrain_epoch_on_device())
            history.append(loss.cpu().numpy()[: self.n_subjects])
            if self.verbose:
                print(f"[vSimCLR pretrain {epoch + 1}/{num_epochs}] "
                      f"mean loss {history[-1].mean():.4f}")
        return history

    # ------------------------------------------------------------------
    # finetune
    def _finetune_plans(self) -> tuple[np.ndarray, np.ndarray]:
        """One epoch's batch plans of all ``n_total`` models over their train
        rows, drawn from ``host_rng`` in JAX's order: global rows
        ``(n_total, nb, B)`` int32 and the validity masks float32."""
        b = self.batch_size
        n_train = self.train_idx.shape[1]
        nb = -(-n_train // b)
        idx = np.empty((self.n_total, nb * b), np.int32)
        mask = np.zeros((self.n_total, nb * b), np.float32)
        for s in range(self.n_total):
            rows = self.host_rng.permutation(n_train)[np.arange(nb * b) % n_train]
            idx[s] = self.train_idx[s][rows]
            mask[s, :n_train] = 1.0
        return idx.reshape(self.n_total, nb, b), mask.reshape(self.n_total, nb, b)

    def finetune_step(self, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One classifier step of every model on its rows ``idx (S, B)``
        (validity ``mask``) over the frozen encoder row; returns the ``(S,)``
        losses."""
        batch = self.data.gather(idx)
        feat = self._features(batch)
        self.classifier.train()
        grads, loss = self._finetune_grad(self.clf_params, feat, batch, mask)
        self.ft_opt.step(self.clf_params, grads)
        return loss

    @torch.no_grad()
    def evaluate(self) -> torch.Tensor:
        """The held-out arousal and valence accuracy ``(S, 2)`` of this
        rank's models, on the device (the held-out rows are one batch)."""
        batch = self.data.gather(self._test_rows)
        feat = self._features(batch)
        self.classifier.eval()
        return vmap(self._accuracy_one)(self.clf_params, feat, batch)

    def finetune_epoch_on_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One finetune epoch of this rank's models and the evaluation after
        it, with nothing read back to the host; returns the ``(S,)`` mean
        train losses and the ``(S, 2)`` held-out accuracies, on the device."""
        idx, mask = (host_to_device(np.ascontiguousarray(self.blocks.local(a)), self.device)
                     for a in self._finetune_plans())
        total = torch.zeros(self.n_local, device=self.device)
        for j in range(idx.shape[1]):
            total += self.finetune_step(idx[:, j], mask[:, j])
        return total / idx.shape[1], self.evaluate()

    def finetune(self, num_epochs: int) -> dict[str, np.ndarray]:
        """All subjects' frozen-encoder finetune; returns the last epoch's
        per-subject held-out accuracies ``a_acc`` and ``v_acc`` ``(S,)``
        (empty after 0 epochs)."""
        acc = None
        for epoch in range(num_epochs):
            loss, acc = map(self.blocks.gather, self.finetune_epoch_on_device())
            if self.verbose:
                a, v = acc.mean(0).tolist()
                print(f"[vSimCLR finetune {epoch + 1}/{num_epochs}] "
                      f"mean loss {loss.mean().item():.4f} arousal {a:.2%} valence {v:.2%}")
        if acc is None:
            return {}
        acc = acc.cpu().numpy()[: self.n_subjects]
        return {"a_acc": acc[:, 0], "v_acc": acc[:, 1]}

    def run(self, pretrain_epochs: int = 50, finetune_epochs: int = 30) -> dict[str, Any]:
        self.pretrain(pretrain_epochs)
        metrics = self.finetune(finetune_epochs)
        return {
            "per_subject": metrics,
            "mean_arousal_acc": float(np.mean(metrics["a_acc"])),
            "mean_valence_acc": float(np.mean(metrics["v_acc"])),
        }

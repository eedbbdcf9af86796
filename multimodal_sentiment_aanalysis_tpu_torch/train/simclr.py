"""SimCLR-style contrastive pretraining and frozen-encoder finetuning.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/simclr.py``
(reference ``train.py:45-138``), with its signatures and these semantics,
each a place where the two packages could drift:

- :func:`contrastive_pretrain`: Adam (optax ``adam``'s b1 0.9, b2 0.999,
  eps 1e-8, no clip, no NaN skip) over encoder and projector; each step
  gathers the two views of a batch of balanced pairs
  (:func:`..data.pairs.build_contrastive_pairs`), encodes and projects view
  1 and then view 2 in train mode, and takes the two-view supervised NT-Xent
  (:func:`..ops.losses.ntxent_supervised_two_view`) against the pair labels.
  The two views draw **independent** dropout masks, in the EEG stem and the
  projector alike (JAX splits a key per view), and view 2's BatchNorm
  update starts from view 1's stats. The epoch plan is
  ``epoch_batch_indices`` over the pairs; its wrapped tail pairs enter the
  loss, its mask is unused, as in JAX;
- :func:`finetune`: the encoder frozen in **eval** mode (running BN stats,
  no dropout), its features computed at every step without a graph (JAX
  ``stop_gradient``); Adam over the classifier alone; the masked CE of both
  heads; after each epoch the masked accuracies over the unshuffled test
  plan.

Epoch plans come from ``numpy.random.default_rng(seed)`` exactly as the JAX
engines draw them; dropout draws from a generator on the data's device,
seeded from ``seed``. Modules are trained in place and copies of their state
dicts returned. On a CUDA device the encoder runs the stem-tail and BiLSTM
kernels (the pretrain also their backward); the finetune runs their
forward only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..data.pipeline import DeviceDataset, epoch_batch_indices
from ..ops.losses import masked_accuracy, masked_cross_entropy, ntxent_supervised_two_view
from .memhacl import _adam, _check_device, _copy


def encode_pair_view(encoder: nn.Module, projector: nn.Module, batch: dict[str, torch.Tensor],
                     generator: torch.Generator | None) -> torch.Tensor:
    """One view's projection: encoder then projector, each drawing its own
    dropout masks from ``generator``."""
    return projector(encoder(batch["eeg"], batch["eye"], batch["pps"], generator), generator)


def pretrain_step(encoder: nn.Module, projector: nn.Module, optimizer: torch.optim.Optimizer,
                  view1: dict[str, torch.Tensor], view2: dict[str, torch.Tensor],
                  pair_labels: torch.Tensor, temperature: float,
                  generator: torch.Generator | None) -> torch.Tensor:
    """One contrastive step on the pairs' two views (call in train mode):
    view 1, then view 2, the loss, the backward and the update. Returns the
    loss, detached; the gradients stay on the parameters."""
    z1 = encode_pair_view(encoder, projector, view1, generator)
    z2 = encode_pair_view(encoder, projector, view2, generator)
    loss = ntxent_supervised_two_view(z1, z2, pair_labels, temperature)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def contrastive_pretrain(
    encoder: nn.Module,
    projector: nn.Module,
    data: DeviceDataset,
    pair_indices: np.ndarray,
    pair_labels: np.ndarray,
    num_epochs: int = 50,
    lr: float = 1e-3,
    batch_size: int = 64,
    temperature: float = 0.1,
    seed: int = 42,
    verbose: bool = True,
    init_variables: tuple[dict, dict] | None = None,
) -> tuple[dict, dict, list[float]]:
    """Pretrain ``encoder`` and ``projector`` in place on the pairs
    (``pair_indices (P, 2)`` rows of ``data``, ``pair_labels (P,)``);
    returns copies of their state dicts and the per-epoch mean losses.

    ``init_variables``: optional ``(encoder state_dict, projector
    state_dict)`` to start from (for example from
    :func:`..models.jax_import.simclr_encoder_state_dict_from_jax`)."""
    device = data.device
    _check_device(device, encoder, projector)
    if init_variables is not None:
        encoder.load_state_dict(init_variables[0])
        projector.load_state_dict(init_variables[1])
    host_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    opt = _adam([*encoder.parameters(), *projector.parameters()], lr)
    pair_idx = torch.as_tensor(np.asarray(pair_indices), dtype=torch.long, device=device)
    pair_lab = torch.as_tensor(np.asarray(pair_labels), dtype=torch.float32, device=device)
    encoder.train()
    projector.train()
    losses: list[float] = []
    for epoch in range(num_epochs):
        plan_idx, _ = epoch_batch_indices(len(pair_idx), batch_size, host_rng)
        plan = torch.as_tensor(plan_idx, dtype=torch.long, device=device)
        total = torch.zeros((), device=device)
        for rows in plan:
            pidx = pair_idx[rows]
            total += pretrain_step(encoder, projector, opt, data.gather(pidx[:, 0]),
                                   data.gather(pidx[:, 1]), pair_lab[rows], temperature,
                                   generator)
        losses.append(total.item() / len(plan))
        if verbose:
            print(f"[Contrastive Epoch {epoch + 1}] loss {losses[-1]:.4f}")
    return _copy(encoder), _copy(projector), losses


@torch.no_grad()
def frozen_features(encoder: nn.Module, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """The eval-mode encoder's features of ``batch``, without a graph."""
    encoder.eval()
    return encoder(batch["eeg"], batch["eye"], batch["pps"])


def finetune_loss(classifier: nn.Module, feat: torch.Tensor, batch: dict[str, torch.Tensor],
                  mask: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """Both heads' masked cross-entropy on the frozen features."""
    out_a, out_v = classifier(feat, generator)
    return (masked_cross_entropy(out_a, batch["arousal"], mask)
            + masked_cross_entropy(out_v, batch["valence"], mask))


def finetune_step(encoder: nn.Module, classifier: nn.Module, optimizer: torch.optim.Optimizer,
                  batch: dict[str, torch.Tensor], mask: torch.Tensor,
                  generator: torch.Generator | None) -> torch.Tensor:
    """One classifier step on the frozen encoder's features (classifier in
    train mode). Returns the loss, detached; the gradients stay on the
    classifier's parameters."""
    loss = finetune_loss(classifier, frozen_features(encoder, batch), batch, mask, generator)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def finetune(
    encoder: nn.Module,
    encoder_vars: dict | None,
    classifier: nn.Module,
    train_data: DeviceDataset,
    test_data: DeviceDataset,
    num_epochs: int = 30,
    lr: float = 1e-4,
    batch_size: int = 64,
    seed: int = 42,
    verbose: bool = True,
    init_classifier_vars: dict | None = None,
) -> tuple[dict, dict]:
    """Train ``classifier`` in place on the frozen features of ``encoder``
    loaded with ``encoder_vars`` (a ``state_dict``; None keeps its weights).
    Returns a copy of the classifier's state dict and the last epoch's test
    metrics (``a_acc``, ``v_acc``) with ``loss_history``, the per-epoch
    train losses."""
    device = train_data.device
    _check_device(device, encoder, classifier)
    if encoder_vars is not None:
        encoder.load_state_dict(encoder_vars)
    if init_classifier_vars is not None:
        classifier.load_state_dict(init_classifier_vars)
    host_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed + 2)
    opt = _adam(classifier.parameters(), lr)
    metrics: dict = {}
    loss_history: list[float] = []
    for epoch in range(num_epochs):
        plan_idx, plan_mask = train_data.epoch_plan(batch_size, host_rng)
        classifier.train()
        total = torch.zeros((), device=device)
        for idx, mask in zip(plan_idx, plan_mask):
            total += finetune_step(encoder, classifier, opt, train_data.gather(idx), mask,
                                   generator)
        loss_history.append(total.item() / len(plan_idx))

        classifier.eval()
        tp_idx, tp_mask = test_data.epoch_plan(batch_size, shuffle=False)
        sums = torch.zeros(3, device=device)  # a_acc * n, v_acc * n, n
        with torch.no_grad():
            for idx, mask in zip(tp_idx, tp_mask):
                batch = test_data.gather(idx)
                out_a, out_v = classifier(frozen_features(encoder, batch))
                n = mask.sum()
                sums += torch.stack([masked_accuracy(out_a, batch["arousal"], mask) * n,
                                     masked_accuracy(out_v, batch["valence"], mask) * n, n])
        a_sum, v_sum, n = sums.tolist()
        n = max(n, 1.0)
        metrics = {"a_acc": a_sum / n, "v_acc": v_sum / n}
        if verbose:
            print(f"[Finetune Epoch {epoch + 1}] loss {loss_history[-1]:.4f} "
                  f"test arousal {metrics['a_acc']:.4f} valence {metrics['v_acc']:.4f}")
    metrics["loss_history"] = loss_history
    return _copy(classifier), metrics

"""ME-MHACL training engines: NT-Xent pretrain, then the joint finetune.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/train/memhacl.py``
(reference ``ME-MHACL/train.py:69-134``), with its signatures and these
semantics, each a place where the two packages could drift:

- pretrain: Adam (optax ``adam``'s b1 0.9, b2 0.999, eps 1e-8) over encoder
  and projector; per batch two Gaussian-noise views, encoder, projector and
  the index-matched NT-Xent (:func:`..ops.losses.ntxent_indexed`); both
  views' projector passes draw the **same** dropout masks (the JAX step
  passes one key to both), and view 2's BatchNorm update starts from view
  1's stats (:func:`pretrain_views`);
- finetune: Adam over encoder and classifier **jointly**, both in train
  mode; masked CE of the two binary heads; after each epoch the validation
  accuracies as masked sums over the unshuffled plan;
- epoch plans drawn from ``numpy.random.default_rng(seed)`` exactly as the
  JAX engines draw them.

Modules and data share one device; noise and dropout draw from
generators on it, seeded from ``seed``. The validation forward
(:func:`memhacl_logits`) runs the fused head kernel on a CUDA device and the
module path on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..data.augment import gaussian_views
from ..data.pipeline import DeviceDataset
from ..kernels.fusion_head import fused_mha_fusion_head
from ..ops.losses import masked_accuracy, masked_cross_entropy, ntxent_indexed


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _check_device(device: torch.device, *modules: nn.Module) -> None:
    if any(p.device != device for m in modules for p in m.parameters()):
        raise ValueError(f"the modules' parameters must be on the data's device {device}")


def _copy(module: nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def pretrain_views(encoder: nn.Module, projector: nn.Module, batch: dict[str, torch.Tensor],
                   noise: tuple[float, float, float],
                   generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """``(z1, z2)`` of two noise views of ``batch`` through the encoder and
    projector (call in train mode). The projector's dropout replays one
    stream for both views; the second forward's BatchNorm update starts
    from the first's."""
    x = (batch["eeg"], batch["eye"], batch["pps"])
    v1 = gaussian_views(generator, *x, *noise)
    v2 = gaussian_views(generator, *x, *noise)
    state = generator.get_state()
    z1 = projector(encoder(*v1), generator)
    generator.set_state(state)
    z2 = projector(encoder(*v2), generator)
    return z1, z2


def memhacl_pretrain(
    encoder: nn.Module,
    projector: nn.Module,
    data: DeviceDataset,
    num_epochs: int = 50,
    lr: float = 1e-3,
    batch_size: int = 32,
    temperature: float = 0.5,
    noise: tuple[float, float, float] = (0.01, 0.05, 0.05),
    seed: int = 0,
    verbose: bool = True,
    init_variables: tuple[dict, dict] | None = None,
) -> tuple[dict, dict, list[float]]:
    """Contrastive pretrain of ``encoder`` and ``projector`` in place;
    returns copies of their state dicts and the per-epoch mean losses.

    ``init_variables``: optional ``(encoder state_dict, projector
    state_dict)`` to start from (for example from
    :func:`..models.jax_import.memhacl_encoder_state_dict_from_jax`)."""
    device = data.device
    _check_device(device, encoder, projector)
    if init_variables is not None:
        encoder.load_state_dict(init_variables[0])
        projector.load_state_dict(init_variables[1])
    host_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed + 2)
    opt = _adam([*encoder.parameters(), *projector.parameters()], lr)
    encoder.train()
    projector.train()
    losses: list[float] = []
    for epoch in range(num_epochs):
        plan_idx, _ = data.epoch_plan(batch_size, host_rng)
        total = torch.zeros((), device=device)
        for idx in plan_idx:
            z1, z2 = pretrain_views(encoder, projector, data.gather(idx), noise, generator)
            loss = ntxent_indexed(z1, z2, temperature)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            total += loss.detach()
        losses.append(total.item() / len(plan_idx))
        if verbose:
            print(f"Epoch [{epoch + 1}/{num_epochs}], Contrastive Loss: {losses[-1]:.4f}")
    return _copy(encoder), _copy(projector), losses


@torch.no_grad()
def memhacl_logits(encoder: nn.Module, classifier: nn.Module, eeg: torch.Tensor,
                   eye: torch.Tensor, pps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode ``(arousal, valence)`` logits. On a CUDA device the three
    embeddings go through the fused head kernel; on the CPU through the
    encoder's attention fusion and the classifier."""
    encoder.eval()
    classifier.eval()
    x = encoder.embed(eeg, eye, pps)
    if eeg.device.type == "cuda":
        return fused_mha_fusion_head(*x, encoder.multihead_attn, classifier, encoder.num_heads)
    return classifier(encoder.fuse(*x))


def memhacl_finetune(
    encoder: nn.Module,
    encoder_vars: dict | None,
    classifier: nn.Module,
    train_data: DeviceDataset,
    val_data: DeviceDataset,
    num_epochs: int = 30,
    lr: float = 1e-4,
    batch_size: int = 32,
    seed: int = 0,
    verbose: bool = True,
    init_classifier_vars: dict | None = None,
) -> tuple[dict, dict, dict]:
    """Joint encoder + classifier finetune in place, from ``encoder_vars``
    (a ``state_dict``; None keeps the encoder's weights). Returns copies of
    both state dicts and the last epoch's validation metrics
    (``a_acc``, ``v_acc``) with ``loss_history``, the per-epoch train
    losses."""
    device = train_data.device
    _check_device(device, encoder, classifier)
    if encoder_vars is not None:
        encoder.load_state_dict(encoder_vars)
    if init_classifier_vars is not None:
        classifier.load_state_dict(init_classifier_vars)
    host_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed + 4)
    opt = _adam([*encoder.parameters(), *classifier.parameters()], lr)
    metrics: dict = {}
    loss_history: list[float] = []
    for epoch in range(num_epochs):
        plan_idx, plan_mask = train_data.epoch_plan(batch_size, host_rng)
        encoder.train()
        classifier.train()
        total = torch.zeros((), device=device)
        for idx, mask in zip(plan_idx, plan_mask):
            batch = train_data.gather(idx)
            out_a, out_v = classifier(encoder(batch["eeg"], batch["eye"], batch["pps"]),
                                      generator)
            loss = (masked_cross_entropy(out_a, batch["arousal"], mask)
                    + masked_cross_entropy(out_v, batch["valence"], mask))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            total += loss.detach()
        loss_history.append(total.item() / len(plan_idx))

        vp_idx, vp_mask = val_data.epoch_plan(batch_size, shuffle=False)
        sums = torch.zeros(3, device=device)  # a_acc * n, v_acc * n, n
        for idx, mask in zip(vp_idx, vp_mask):
            batch = val_data.gather(idx)
            out_a, out_v = memhacl_logits(encoder, classifier, batch["eeg"], batch["eye"],
                                          batch["pps"])
            n = mask.sum()
            sums += torch.stack([masked_accuracy(out_a, batch["arousal"], mask) * n,
                                 masked_accuracy(out_v, batch["valence"], mask) * n, n])
        a_sum, v_sum, n = sums.tolist()
        n = max(n, 1.0)
        metrics = {"a_acc": a_sum / n, "v_acc": v_sum / n}
        if verbose:
            print(f"Epoch [{epoch + 1}/{num_epochs}], Train Loss: {loss_history[-1]:.4f}, "
                  f"Val Acc Arousal: {metrics['a_acc']:.1%}, "
                  f"Val Acc Valence: {metrics['v_acc']:.1%}")
    metrics["loss_history"] = loss_history
    return _copy(encoder), _copy(classifier), metrics

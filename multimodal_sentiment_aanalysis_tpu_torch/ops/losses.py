"""Loss functions of the single-subject trainer.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/ops/losses.py``:

- :func:`supervised_infonce`: the in-model supervised InfoNCE (reference
  ``MultimodalModel.py:232-260``) with an optional validity mask. A CPU
  tensor runs the plain body below; a CUDA tensor goes to the kernel
  (:func:`..kernels.contrastive.fused_supervised_infonce`).
- :func:`supervised_infonce_multi`: G losses sharing labels, mask and
  temperature; on the card one launch for all G.
- :func:`masked_cross_entropy`, :func:`masked_accuracy`: means over the
  valid rows of a wrap-padded batch (of the global batch, under batch
  data parallelism);
- :func:`ntxent_indexed`: ME-MHACL's index-matched NT-Xent;
- :func:`ntxent_supervised_two_view`: the SimCLR stack's two-view
  supervised NT-Xent, plain tensor math on either device (the JAX package
  computes it outside any Pallas kernel); and :func:`cross_entropy`, the
  batch mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.contrastive import fused_supervised_infonce, fused_supervised_infonce_multi
from ..parallel.collectives import global_count


def supervised_infonce(feat1: torch.Tensor, feat2: torch.Tensor, labels: torch.Tensor,
                       temperature: torch.Tensor | float,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """L2-normalise both feature sets, similarity over ``temperature``,
    positives by label equality with the diagonal zeroed, row-max
    subtraction, ``-log((pos + 1e-12) / (all + 1e-12))`` averaged (over the
    ``mask == 1`` rows, whose columns alone enter the denominators)."""
    if feat1.device.type == "cuda":
        return fused_supervised_infonce(feat1, feat2, labels, temperature, mask)
    f1 = F.normalize(feat1, dim=1, eps=1e-12)
    f2 = F.normalize(feat2, dim=1, eps=1e-12)
    sim = (f1 @ f2.T) / temperature
    n = sim.shape[0]
    pos = (labels[:, None] == labels[None, :]).to(sim.dtype)
    pos = pos * (1.0 - torch.eye(n, dtype=sim.dtype, device=sim.device))
    if mask is not None:
        valid = mask.to(sim.dtype)
        pos = pos * valid[:, None] * valid[None, :]
        # padded columns leave the denominator: -1e30 keeps the row max
        # finite and their exp underflows to exactly 0
        sim = torch.where(valid[None, :] > 0, sim, -1e30)
    sim = sim - sim.amax(dim=1, keepdim=True)
    e = torch.exp(sim)
    loss = -torch.log(((e * pos).sum(1) + 1e-12) / (e.sum(1) + 1e-12))
    if mask is not None:
        valid = mask.to(loss.dtype)
        return (loss * valid).sum() / valid.sum().clamp_min(1.0)
    return loss.mean()


def supervised_infonce_multi(feats1: torch.Tensor, feats2: torch.Tensor,
                             labels: torch.Tensor, temperature: torch.Tensor | float,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """``(G,)`` losses of :func:`supervised_infonce` on ``feats1[g],
    feats2[g]``; on a CUDA tensor all G in one kernel launch."""
    if feats1.device.type == "cuda":
        return fused_supervised_infonce_multi(feats1, feats2, labels, temperature, mask)
    return torch.stack([supervised_infonce(feats1[g], feats2[g], labels, temperature, mask)
                        for g in range(feats1.shape[0])])


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy averaged over the ``mask == 1`` rows; inside
    :func:`..parallel.collectives.global_batch` this rank's rows summed over
    the global batch's count, so the ranks' terms add up to the mean."""
    per = F.cross_entropy(logits, labels, reduction="none")
    m = mask.to(per.dtype)
    return (per * m).sum() / global_count(m).clamp_min(1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """The hit rate over the ``mask == 1`` rows (over the global batch's
    count inside :func:`..parallel.collectives.global_batch`)."""
    hit = (logits.argmax(dim=-1) == labels).to(torch.float32) * mask.to(torch.float32)
    return hit.sum() / global_count(mask).clamp_min(1.0)


def ntxent_indexed(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.5) -> torch.Tensor:
    """SimCLR NT-Xent with index-matched positives (reference
    ``ME-MHACL/train.py:47-66``): L2-normalise the ``2B`` stack, mask the
    self-similarity to -9e15 before the division by ``temperature``, and
    take the cross-entropy of each row against its pair."""
    b = z1.shape[0]
    z = F.normalize(torch.cat([z1, z2]), dim=1, eps=1e-12)
    sim = z @ z.T
    eye = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    sim = torch.where(eye, -9e15, sim) / temperature
    targets = torch.cat([torch.arange(b, 2 * b), torch.arange(0, b)]).to(z.device)
    return F.cross_entropy(sim, targets)


def ntxent_supervised_two_view(z1: torch.Tensor, z2: torch.Tensor, labels: torch.Tensor,
                               temperature: float = 0.1) -> torch.Tensor:
    """Two-view supervised NT-Xent (reference ``train.py:16-40``): the two
    L2-normalised views stacked as ``2B`` rows, their ``2B x 2B`` similarity
    over ``temperature``, positives by label equality less the diagonal, a
    denominator of each row's exp-sum without its diagonal, and each row's
    summed log-probability over its positives divided by their count. The
    SimCLR engines pass the *pair* labels (1.0 positive, 0.0 negative) as
    ``labels``, as the JAX engines do."""
    z = torch.cat([F.normalize(z1, dim=1, eps=1e-12), F.normalize(z2, dim=1, eps=1e-12)])
    sim = (z @ z.T) / temperature
    lab = torch.cat([labels.reshape(-1), labels.reshape(-1)])
    self_mask = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    mask = torch.where(self_mask, 0.0, (lab[:, None] == lab[None, :]).to(sim.dtype))
    sim_sum = torch.where(self_mask, 0.0, torch.exp(sim)).sum(1, keepdim=True)
    log_prob = sim - torch.log(sim_sum + 1e-8)
    loss = -(mask * log_prob).sum(1) / (mask.sum(1) + 1e-8)
    return loss.mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy averaged over the batch (``nn.CrossEntropyLoss``)."""
    return F.cross_entropy(logits, labels)

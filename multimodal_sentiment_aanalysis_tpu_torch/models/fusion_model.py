"""Flagship fusion model: MultimodalTransformerModel, train and eval forward.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/models/fusion_model.py``,
with the reference's module names, so
``torch_import.variables_from_torch_state_dict(model.state_dict())`` gives
the JAX package's variables and :func:`.jax_import.state_dict_from_jax_variables`
gives this model's ``state_dict``:

- per-modality encoders ``eeg_net``, ``eye_net``, ``pps_net``
- two EEG-queried gated cross-modal blocks ``cross_attn_e2p``/``cross_attn_p2e``
- softmax modality weights ``attention_weights`` (3F -> 64 -> 3)
- ``fusion`` trunk 3F -> F -> 128 of Linear/BN/GELU/Dropout blocks
- ``arousal_head`` 128 -> 128 -> classes; ``valence_head``
  128 -> 256 -> 256 -> 128 -> 64 -> classes
- learnable ``contrastive_weight`` and ``temperature`` (used by the
  in-model InfoNCE losses)

``forward(eeg, eye, pps)`` returns ``(arousal, valence)``; with
``labels=(arousal_labels, valence_labels[, mask])`` it also returns the
three supervised-InfoNCE losses of the EEG, eye and PPS embeddings on the
arousal labels, each scaled by ``contrastive_weight`` (one G=3 launch of the
InfoNCE kernel on the card). Both work in either mode. Inside
:func:`..parallel.collectives.global_batch` (batch data parallelism) the
three InfoNCE problems run over the gathered global batch on every rank,
each rank's term weighted by 1/W, and the BatchNorm statistics are the
global batch's.

Train mode (``model.train()``): batch-statistic BatchNorm, with the running
stats updated by the JAX rule (momentum 0.1, biased batch variance, see
:func:`.eeg.update_running_stats`), and dropout (EEG stem 0.4, everything
else 0.3, or ``dropout`` at every site) drawn from the ``generator`` passed
to :meth:`forward`.

Tensor parallelism (:mod:`..parallel.tp`) swaps in
:class:`ShardedMultimodalTransformerModel`, whose trunk and heads run each
column-parallel Linear's BatchNorm, GELU and dropout on this rank's
features (:func:`run_sharded_trunk`) and gather them before the next
Linear; its encoders, cross-modal blocks and modality weighting compute
through their children's sharded forms, the InfoNCE on the whole
features.

``lstm_schedule`` picks the EEG BiLSTM's kernels on the card
(:data:`..kernels.lstm.SCHEDULES`, default ``"v9"``); it is neither a
parameter nor a buffer, so the ``state_dict`` does not carry it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn as nn

from ..ops.losses import supervised_infonce_multi
from ..parallel.collectives import all_reduce_sum, batch_group, gather_blocks
from .cross_modal import CrossModalTransformer
from .eeg import BiLSTM, EEGMultiScaleNet, update_running_stats
from .layers import Linear, MultiheadAttention, ShardedLinear, dropout
from .subnetwork import Subnetwork


def _bn_blocks(widths, in_dim: int, dropout: float, device) -> list[nn.Module]:
    """[Linear, BatchNorm1d, GELU, Dropout] per width (reference trunks)."""
    mods: list[nn.Module] = []
    for w in widths:
        mods += [Linear(in_dim, w, device=device), nn.BatchNorm1d(w, device=device),
                 nn.GELU(), nn.Dropout(dropout)]
        in_dim = w
    return mods


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over every axis of ``(B, F)`` or ``(B, C, T)``
    but the feature axis 1: batch stats ``max(E[x^2] - E[x]^2, 0)`` (with
    gradient) in train mode, updating the running stats; the running stats
    in eval mode. Inside :func:`..parallel.collectives.global_batch` the
    train-mode statistics are the global batch's, from all-reduced sums that
    carry the gradient. As flax does, the statistics and the normalisation run in
    at least fp32, and the result takes the promoted dtype of ``x`` and the
    affine parameters."""
    dims = [0, *range(2, x.dim())]
    out_dtype = torch.promote_types(torch.promote_types(x.dtype, bn.weight.dtype), bn.bias.dtype)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    group = batch_group()
    if bn.training and group is not None:
        # one differentiable all-reduce of [sum, sum of squares, row count]
        f = x.shape[1]
        tot = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims),
                                        x.new_full((1,), x.numel() / f)]), group)
        mean = tot[:f] / tot[2 * f]
        var = (tot[f:2 * f] / tot[2 * f] - mean * mean).clamp_min(0.0)
        update_running_stats(bn, mean.detach(), var.detach())
    elif bn.training:
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        update_running_stats(bn, mean.detach(), var.detach())
    else:
        mean, var = bn.running_mean, bn.running_var
    per_feature = (-1,) + (1,) * (x.dim() - 2)
    return ((x - mean.reshape(per_feature)) * torch.rsqrt(var + bn.eps).reshape(per_feature)
            * bn.weight.reshape(per_feature) + bn.bias.reshape(per_feature)).to(out_dtype)


def run_trunk(trunk: nn.Sequential, x: torch.Tensor,
              generator: torch.Generator | None) -> torch.Tensor:
    """A Sequential run module by module, with each BatchNorm1d by the JAX
    rule (:func:`batch_norm`) and each Dropout drawn from ``generator``: the
    [Linear, BatchNorm1d, GELU, Dropout]* (+ Linear) trunks here, and the
    ME-MHACL conv stacks and heads."""
    for m in trunk:
        if isinstance(m, nn.BatchNorm1d):
            x = batch_norm(m, x)
        elif isinstance(m, nn.Dropout):
            x = dropout(x, m.p, m.training, generator)
        else:
            x = m(x)
    return x


def run_sharded_trunk(trunk: nn.Sequential, x: torch.Tensor,
                      generator: torch.Generator | None) -> torch.Tensor:
    """:func:`run_trunk` of a tensor-parallel trunk: a column-parallel
    Linear (:class:`.layers.ShardedLinear`) leaves its output as this rank's
    block of features, which its BatchNorm (split with it), GELU and
    dropout (the whole mask's columns) take as they are; the block is
    gathered before the next Linear and at the end."""
    local = False
    for m in trunk:
        if isinstance(m, ShardedLinear):
            if local:
                x = m.tp.gather(x, -1)
            x = m(x, local_out=True)
            local, tp = m.column, m.tp
        elif isinstance(m, nn.BatchNorm1d):
            x = batch_norm(m, x)
        elif isinstance(m, nn.Dropout):
            x = dropout(x, m.p, m.training, generator,
                        shard=(tp.index, tp.size) if local else None)
        else:
            x = m(x)
    return tp.gather(x, -1) if local else x


@torch.no_grad()
def init_parameters(root: nn.Module, generator: torch.Generator | None = None) -> None:
    """Draw every weight of ``root`` from ``generator`` (a CPU generator;
    seed 0 when None), with torch's default init rules: Linear and Conv1d
    U(+-1/sqrt(fan_in)), attention ``in_proj`` Xavier-uniform with zero
    biases, LSTM U(+-1/sqrt(H)), norms ones and zeros. The same seed gives
    the same weights on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def uniform_(p: torch.Tensor, bound: float) -> None:
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    # children before parents, so the attention branch below zeroes the
    # bias of its out_proj Linear after the Linear branch drew it
    for module in reversed(list(root.modules())):
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            bound = 1.0 / math.sqrt(module.weight[0].numel())
            uniform_(module.weight, bound)
            uniform_(module.bias, bound)
        elif isinstance(module, MultiheadAttention):
            e = module.embed_dim
            uniform_(module.in_proj_weight, math.sqrt(6.0 / (4 * e)))
            module.in_proj_bias.zero_()
            module.out_proj.bias.zero_()
        elif isinstance(module, BiLSTM):
            hidden = module.weight_hh_l0.shape[1]
            for p in module.parameters():
                uniform_(p, 1.0 / math.sqrt(hidden))
        elif isinstance(module, (nn.LayerNorm, nn.BatchNorm1d)):
            module.reset_parameters()


class MultimodalTransformerModel(nn.Module):
    def __init__(self, num_classes: int = 3, temperature: float = 0.01,
                 eeg_channels: int = 32, eeg_time: int = 585, eye_dim: int = 38,
                 pps_dim: int = 230, feat_dim: int = 256, dropout: float | None = None,
                 *, device=None, generator: torch.Generator | None = None,
                 lstm_schedule: str = "v9"):
        super().__init__()
        d_eeg = 0.4 if dropout is None else dropout
        d = 0.3 if dropout is None else dropout
        f = feat_dim
        self.eeg_net = EEGMultiScaleNet(eeg_channels, eeg_time, f, d_eeg, device=device,
                                        lstm_schedule=lstm_schedule)
        self.eye_net = Subnetwork(eye_dim, f, dropout=d, device=device)
        self.pps_net = Subnetwork(pps_dim, f, dropout=d, device=device)
        self.cross_attn_e2p = CrossModalTransformer(f, device=device)
        self.cross_attn_p2e = CrossModalTransformer(f, device=device)
        self.attention_weights = nn.Sequential(
            Linear(3 * f, 64, device=device), nn.GELU(),
            Linear(64, 3, device=device), nn.Softmax(dim=1),
        )
        self.fusion = nn.Sequential(*_bn_blocks((f, 128), 3 * f, d, device))
        self.arousal_head = nn.Sequential(*_bn_blocks((128,), 128, d, device),
                                          Linear(128, num_classes, device=device))
        self.valence_head = nn.Sequential(*_bn_blocks((256, 256, 128, 64), 128, d, device),
                                          Linear(64, num_classes, device=device))
        self.contrastive_weight = nn.Parameter(torch.ones(1, device=device))
        self.temperature = nn.Parameter(torch.full((), temperature, device=device))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """:func:`init_parameters` of the whole model."""
        init_parameters(self, generator)

    def forward(self, eeg: torch.Tensor, eye: torch.Tensor, pps: torch.Tensor,
                labels: tuple | None = None, *,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, ...]:
        """``eeg (B, C, T)``, ``eye (B, eye_dim)``, ``pps (B, pps_dim)`` ->
        ``(arousal, valence)`` logits, each ``(B, num_classes)``; with
        ``labels`` also ``(c_eeg, c_eye, c_pps)``."""
        eeg_feat = self.eeg_net(eeg, generator)
        eye_feat = self.eye_net(eye, generator)
        pps_feat = self.pps_net(pps, generator)
        contrastive = ()
        if labels is not None:
            mask = labels[2] if len(labels) > 2 else None
            if labels[0].shape[0] != eeg.shape[0]:
                raise ValueError(f"{labels[0].shape[0]} labels for a batch of {eeg.shape[0]}")
            feats = torch.stack([eeg_feat, eye_feat, pps_feat])
            lab, group = labels[0], batch_group()
            if group is not None:
                # the InfoNCE problems over the global batch, on every rank;
                # each rank's share is 1/W of it, so the ranks' gradients
                # summed count it once
                feats = gather_blocks(feats, group, dim=1)
                lab = gather_blocks(lab, group)
                mask = None if mask is None else gather_blocks(mask, group)
            c = supervised_infonce_multi(feats, feats, lab, self.temperature, mask)
            if group is not None:
                c = c / dist.get_world_size(group)
            contrastive = tuple(self.contrastive_weight[0] * c)
        eye_enhanced = self.cross_attn_e2p(eeg_feat, eye_feat, eye_feat)
        pps_enhanced = self.cross_attn_p2e(eeg_feat, pps_feat, pps_feat)
        w = self.attention_weights(torch.cat([eeg_feat, eye_feat, pps_feat], dim=1))
        fused = self._trunk(self.fusion, torch.cat(
            [eeg_feat * w[:, 0:1], eye_enhanced * w[:, 1:2], pps_enhanced * w[:, 2:3]],
            dim=1,
        ), generator)
        return (self._trunk(self.arousal_head, fused, generator),
                self._trunk(self.valence_head, fused, generator)) + contrastive

    _trunk = staticmethod(run_trunk)


class ShardedMultimodalTransformerModel(MultimodalTransformerModel):
    """The flagship's tensor-parallel form (:mod:`..parallel.tp`): its
    trunk and heads run through :func:`run_sharded_trunk`."""

    _trunk = staticmethod(run_sharded_trunk)

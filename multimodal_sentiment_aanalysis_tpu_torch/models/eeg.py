"""EEG multi-scale encoder.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/models/eeg.py``:

- temporal branch: Conv1d(C->64, k15, pad 7) -> BN -> GELU -> Dropout(0.4)
  -> MaxPool(4) -> Conv1d(64->feat_dim, k5, pad 2) -> BN -> GELU -> Dropout
  -> MaxPool(2); each conv is ``F.conv1d`` and each BN + GELU + dropout +
  pool tail is the stem-tail kernel
  (:func:`..kernels.conv_stem_train.fused_stage_train`)
- frequency branch: channel mean -> Linear(T->128) -> GELU -> Linear(128->64)
- 2-layer BiLSTM (hidden feat_dim/2 per direction) through
  :func:`..ops.rnn.bilstm_layer`, mean-pooled over time
- fusion: Linear(feat_dim+64 -> feat_dim) -> LayerNorm -> GELU

BatchNorm follows the JAX ``_BNVars``: in train mode the statistics are the
batch's over (B, T), ``E[x^2] - E[x]^2``, computed without gradient and fed
to the kernel (whose backward carries their dependence); the running stats
take ``0.9 * running + 0.1 * batch`` with the *biased* variance, as flax
does (torch ``BatchNorm1d`` would use the unbiased one). Eval mode uses the
running stats and no dropout. Inside
:func:`..parallel.collectives.global_batch` the statistics are the global
batch's (all-reduced sums over the global row count), and the stem tail's
backward forms its batch-statistic terms over the global batch too.

Tensor parallelism (:mod:`..parallel.tp`) swaps in
:class:`ShardedEEGMultiScaleNet`, whose stem runs each conv on this rank's
output channels and the stem tail on that channel shard (BatchNorm is per
channel, and the shard's dropout bits are the unsharded layer's columns),
then gathers the channels, and :class:`ShardedBiLSTM`, which gathers each
layer's gate rows and runs the whole layer's kernels on every model rank
(the recurrence needs the whole ``h`` every step); the backward of that
gather keeps this rank's rows of each weight gradient.

The public input is the reference's ``(B, C, T)``; the stem runs NLC
``(B, T, C)`` inside, as the JAX package does. Module names follow the
reference ``state_dict`` (``temp_conv.0``, ``freq_branch.2``,
``bilstm.weight_ih_l0_reverse``, ``fusion.1``, ...).
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.conv_stem_train import fused_stage_train
from ..kernels.lstm import check_schedule
from ..ops.rnn import bilstm_layer
from ..parallel.collectives import batch_group, reduce_sum_
from .layers import LayerNorm, Linear

BN_MOMENTUM = 0.1  # torch convention: running = (1 - m) * running + m * batch


class BiLSTM(nn.Module):
    """Parameters of a bidirectional multi-layer ``nn.LSTM``, under its
    names, run through :func:`..ops.rnn.bilstm_layer` (``nn.LSTM``'s own
    forward would be cuDNN's kernel) under the kernel schedule
    ``schedule`` (:data:`..kernels.lstm.SCHEDULES`; neither a parameter nor
    a buffer)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, device=None,
                 schedule: str = "v9"):
        super().__init__()
        check_schedule(schedule, torch.float32)
        self.num_layers = num_layers
        self.schedule = schedule
        for k in range(num_layers):
            in_dim = input_size if k == 0 else 2 * hidden_size
            for suffix in ("", "_reverse"):
                shapes = {"weight_ih": (4 * hidden_size, in_dim),
                          "weight_hh": (4 * hidden_size, hidden_size),
                          "bias_ih": (4 * hidden_size,),
                          "bias_hh": (4 * hidden_size,)}
                for part, shape in shapes.items():
                    self.register_parameter(f"{part}_l{k}{suffix}",
                                            nn.Parameter(torch.empty(shape, device=device)))

    def layer_params(self, k: int):
        """``(fwd, bwd)`` parameter tuples ``(w_ih, w_hh, b_ih, b_hh)`` of layer ``k``."""
        return tuple(
            tuple(getattr(self, f"{part}_l{k}{suffix}")
                  for part in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            for suffix in ("", "_reverse"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_layers):
            x = bilstm_layer(x, *self.layer_params(k), self.schedule)
        return x


class ShardedBiLSTM(BiLSTM):
    """:class:`BiLSTM` whose gate rows may be split over the model axis:
    each layer's parameters are gathered whole before the layer runs."""

    def layer_params(self, k: int):
        return tuple(
            tuple(self.tp.whole(self, f"{part}_l{k}{suffix}")
                  for part in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            for suffix in ("", "_reverse"))


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm1d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """The JAX rule: running stats move toward the batch's by the momentum,
    the variance being the biased batch variance."""
    for running, batch in ((bn.running_mean, mean), (bn.running_var, var)):
        running.mul_(1.0 - BN_MOMENTUM).add_(batch, alpha=BN_MOMENTUM)


class EEGMultiScaleNet(nn.Module):
    """Input ``(B, in_channels, time_len)`` -> ``(B, feat_dim)``."""

    def __init__(self, in_channels: int = 32, time_len: int = 585, feat_dim: int = 256,
                 dropout: float = 0.4, device=None, lstm_schedule: str = "v9"):
        super().__init__()
        self.temp_conv = nn.Sequential(
            nn.Conv1d(in_channels, 64, 15, padding=7, device=device),
            nn.BatchNorm1d(64, device=device), nn.GELU(), nn.Dropout(dropout),
            nn.MaxPool1d(4),
            nn.Conv1d(64, feat_dim, 5, padding=2, device=device),
            nn.BatchNorm1d(feat_dim, device=device), nn.GELU(), nn.Dropout(dropout),
            nn.MaxPool1d(2),
        )
        self.freq_branch = nn.Sequential(
            Linear(time_len, 128, device=device), nn.GELU(),
            Linear(128, 64, device=device),
        )
        self.bilstm = BiLSTM(feat_dim, feat_dim // 2, num_layers=2, device=device,
                             schedule=lstm_schedule)
        self.fusion = nn.Sequential(
            Linear(feat_dim + 64, feat_dim, device=device),
            LayerNorm(feat_dim, eps=1e-5, device=device), nn.GELU(),
        )

    def _stage(self, h: torch.Tensor, conv: nn.Conv1d, bn: nn.BatchNorm1d, drop: nn.Dropout,
               pool: nn.MaxPool1d, generator: torch.Generator | None,
               channels: tuple[int, int] | None = None) -> torch.Tensor:
        """NLC in, NLC out: conv, then the fused BN + GELU + dropout + pool
        tail (on the channel shard ``channels``, where given)."""
        y = F.conv1d(h.transpose(1, 2), conv.weight, conv.bias, padding=conv.padding)
        y = y.transpose(1, 2).contiguous()
        group = batch_group() if self.training else None
        n_rows = sum_ranks = None
        if group is not None:
            with torch.no_grad():  # the global batch's [sum, sum of squares, row count]
                c = y.shape[-1]
                tot = reduce_sum_(torch.cat([y.sum((0, 1)), (y * y).sum((0, 1)),
                                             y.new_full((1,), y.shape[0] * y.shape[1])]), group)
                mean = tot[:c] / tot[2 * c]
                var = tot[c:2 * c] / tot[2 * c] - mean * mean
            update_running_stats(bn, mean, var)
            p, n_rows = drop.p, tot[2 * c]
            sum_ranks = functools.partial(reduce_sum_, group=group)
        elif self.training:
            with torch.no_grad():
                mean = y.mean((0, 1))
                var = (y * y).mean((0, 1)) - mean * mean
            update_running_stats(bn, mean, var)
            p = drop.p
        else:
            mean, var, p = bn.running_mean, bn.running_var, 0.0
        return fused_stage_train(y, bn.weight, bn.bias, mean, var, p, pool.kernel_size, bn.eps,
                                 generator, batch_stats=self.training, n_rows=n_rows,
                                 sum_ranks=sum_ranks, channels=channels)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        tc = self.temp_conv
        h = self._stage(x.transpose(1, 2), tc[0], tc[1], tc[3], tc[4], generator)  # (B, T/4, 64)
        h = self._stage(h, tc[5], tc[6], tc[8], tc[9], generator)  # (B, T/8, feat_dim)
        freq = self.freq_branch(x.mean(dim=1))
        temp_feat = self.bilstm(h).mean(dim=1)
        return self.fusion(torch.cat([temp_feat, freq], dim=1))


class ShardedEEGMultiScaleNet(EEGMultiScaleNet):
    """:class:`EEGMultiScaleNet` whose conv stem may be split on its output
    channels: each stage whose conv is split runs on this rank's channels
    and returns the whole channels, gathered. Its Linear, LayerNorm and
    BiLSTM children are sharded forms of their own."""

    def _stage(self, h, conv, bn, drop, pool, generator, channels=None):
        if conv.tp_split.get("weight") is None:
            return super()._stage(h, conv, bn, drop, pool, generator)
        tp, c = self.tp, conv.weight.shape[0]
        out = super()._stage(tp.copy(h), conv, bn, drop, pool, generator,
                             channels=(tp.index * c, tp.size * c))
        return tp.gather(out, -1)

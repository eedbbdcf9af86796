"""The EEG multi-scale encoder that both configurations share: two Conv1d
stages, each BatchNorm, exact GELU, dropout and MaxPool; a frequency branch
over the channel mean; a two-layer bidirectional LSTM, mean-pooled over
time; a Linear, LayerNorm and GELU over both."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nn as rnn

STAGES = (("temp_conv.0", "temp_conv.1", 15, 7, 4), ("temp_conv.5", "temp_conv.6", 5, 2, 2))


def spec(cfg: dict, name: str = "eeg_net") -> list:
    e = cfg["eeg"]
    f = cfg["feat_dim"]
    return (rnn.conv_spec(f"{name}.temp_conv.0", e["channels"], e["conv1_out"], e["conv1_kernel"])
            + rnn.norm_spec(f"{name}.temp_conv.1", e["conv1_out"])
            + rnn.conv_spec(f"{name}.temp_conv.5", e["conv1_out"], f, e["conv2_kernel"])
            + rnn.norm_spec(f"{name}.temp_conv.6", f)
            + rnn.linear_spec(f"{name}.freq_branch.0", e["time"], e["freq_hidden"])
            + rnn.linear_spec(f"{name}.freq_branch.2", e["freq_hidden"], e["freq_out"])
            + rnn.lstm_spec(f"{name}.bilstm", f, f // 2, e["lstm_layers"])
            + rnn.linear_spec(f"{name}.fusion.0", f + e["freq_out"], f)
            + rnn.norm_spec(f"{name}.fusion.1", f))


def stats_spec(cfg: dict, name: str = "eeg_net") -> list:
    return (rnn.bn_stats_spec(f"{name}.temp_conv.1", cfg["eeg"]["conv1_out"])
            + rnn.bn_stats_spec(f"{name}.temp_conv.6", cfg["feat_dim"]))


def stage_shapes(cfg: dict, batch: int) -> list[tuple[int, int, int]]:
    """Each stage's conv output ``(B, T, C)``, channels last: the shape of
    its dropout bits."""
    e = cfg["eeg"]
    t1 = e["time"]
    t2 = t1 // e["pool1"]
    return [(batch, t1, e["conv1_out"]), (batch, t2, cfg["feat_dim"])]


def forward(num: rnn.Numerics, cfg: dict, p: dict, stats: dict, new: dict, x: torch.Tensor,
            keeps: list, name: str = "eeg_net") -> torch.Tensor:
    """``x (B, C, T)`` to ``(B, feat_dim)``; ``keeps`` holds each stage's
    ``(B, T, C)`` keep bits, or None in eval mode."""
    e = cfg["eeg"]
    pools = (e["pool1"], e["pool2"])
    pads = (e["conv1_kernel"] // 2, e["conv2_kernel"] // 2)
    h = x
    for j, (conv, bn) in enumerate((("temp_conv.0", "temp_conv.1"),
                                    ("temp_conv.5", "temp_conv.6"))):
        y = F.conv1d(num.q(h), num.q(p[f"{name}.{conv}.weight"]), p[f"{name}.{conv}.bias"],
                     padding=pads[j])
        y = F.gelu(rnn.batch_norm_train(p, stats, new, f"{name}.{bn}", y, (0, 2)))
        keep = None if keeps[j] is None else keeps[j].transpose(1, 2)
        h = F.max_pool1d(rnn.dropout(y, keep, e["stem_dropout"]), pools[j])
    freq = rnn.linear(num, p, f"{name}.freq_branch.2",
                      F.gelu(rnn.linear(num, p, f"{name}.freq_branch.0", x.mean(1))))
    temp = rnn.bilstm(num, p, f"{name}.bilstm", h.transpose(1, 2), e["lstm_layers"]).mean(1)
    out = rnn.linear(num, p, f"{name}.fusion.0", torch.cat([temp, freq], 1))
    return F.gelu(rnn.layer_norm(p, f"{name}.fusion.1", out))

"""Plain float32 reference of the SimCLR pretrain model and its objective
(reference repository ``MultimodalModel.py:325-451``, ``train.py:16-40``).

``encoder``: the EEG encoder (:mod:`.eeg`, its stem the only dropout),
eye and PPS MLPs ([Linear, ReLU, BatchNorm] twice), each output
L2-normalised, the three as a length-3 sequence under 8-head
self-attention, the maximum over the modality axis, then Linear, ReLU,
BatchNorm. ``projector``: Linear, ReLU, BatchNorm, Dropout twice, then a
Linear. The objective is the two-view supervised NT-Xent over the two
trials of each pair, whose label says whether the pair is positive; the
second view's BatchNorm running stats start from the first's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import eeg
from . import nn as rnn

MLP_HIDDEN = 128


def spec(cfg: dict) -> list:
    f = cfg["feat_dim"]
    out = eeg.spec(cfg, "encoder.eeg_net")
    for net, width in (("encoder.eye_net", cfg["eye_dim"]), ("encoder.pps_net", cfg["pps_dim"])):
        out += (rnn.linear_spec(f"{net}.net.0", width, MLP_HIDDEN)
                + rnn.norm_spec(f"{net}.net.2", MLP_HIDDEN)
                + rnn.linear_spec(f"{net}.net.3", MLP_HIDDEN, f) + rnn.norm_spec(f"{net}.net.5", f))
    out += (rnn.mha_spec("encoder.multihead_attn", f)
            + rnn.linear_spec("encoder.fusion_mlp.0", f, f) + rnn.norm_spec("encoder.fusion_mlp.2", f))
    h, o = cfg["proj_hidden"], cfg["proj_out"]
    out += (rnn.linear_spec("projector.net.0", f, h) + rnn.norm_spec("projector.net.2", h)
            + rnn.linear_spec("projector.net.4", h, o) + rnn.norm_spec("projector.net.6", o)
            + rnn.linear_spec("projector.net.8", o, o))
    return out


def classifier_spec(cfg: dict) -> list:
    c = cfg["classes"]
    return (rnn.linear_spec("shared.0", cfg["feat_dim"], cfg["clf_hidden"])
            + rnn.linear_spec("fc_arousal", cfg["clf_hidden"], c)
            + rnn.linear_spec("fc_valence", cfg["clf_hidden"], c))


def stats_spec(cfg: dict) -> list:
    out = eeg.stats_spec(cfg, "encoder.eeg_net")
    for net in ("encoder.eye_net", "encoder.pps_net"):
        out += (rnn.bn_stats_spec(f"{net}.net.2", MLP_HIDDEN)
                + rnn.bn_stats_spec(f"{net}.net.5", cfg["feat_dim"]))
    out += rnn.bn_stats_spec("encoder.fusion_mlp.2", cfg["feat_dim"])
    out += (rnn.bn_stats_spec("projector.net.2", cfg["proj_hidden"])
            + rnn.bn_stats_spec("projector.net.6", cfg["proj_out"]))
    return out


def draws(cfg: dict, n_models: int, batch: int) -> list[tuple[str, tuple]]:
    """Each view's stem draws, then its projector's two dropout sites."""
    one = ([("stem", shape) for shape in eeg.stage_shapes(cfg, batch)]
           + [("u", (batch, cfg["proj_hidden"])), ("u", (batch, cfg["proj_out"]))])
    return one + one


def _view(num, cfg, p, stats, view, stem_keeps, keeps):
    new: dict = {}
    e = eeg.forward(num, cfg, p, stats, new, view["eeg"], stem_keeps, "encoder.eeg_net")
    feats = [F.normalize(t, dim=-1, eps=1e-12) for t in
             (e, _mlp(num, p, stats, new, "encoder.eye_net", view["eye"]),
              _mlp(num, p, stats, new, "encoder.pps_net", view["pps"]))]
    seq = torch.stack(feats, 1)
    fused = torch.amax(rnn.mha(num, p, "encoder.multihead_attn", seq, seq, seq,
                               cfg["encoder_heads"]), 1)
    h = rnn.batch_norm_train(p, stats, new, "encoder.fusion_mlp.2",
                             F.relu(rnn.linear(num, p, "encoder.fusion_mlp.0", fused)), (0,))
    rate = cfg["dropout"]
    for lin, bn, keep in (("projector.net.0", "projector.net.2", keeps[0]),
                          ("projector.net.4", "projector.net.6", keeps[1])):
        h = rnn.batch_norm_train(p, stats, new, bn, F.relu(rnn.linear(num, p, lin, h)), (0,))
        h = rnn.dropout(h, keep, rate)
    return rnn.linear(num, p, "projector.net.8", h), new


def _mlp(num, p, stats, new, net, x):
    for lin, bn in ((f"{net}.net.0", f"{net}.net.2"), (f"{net}.net.3", f"{net}.net.5")):
        x = rnn.batch_norm_train(p, stats, new, bn, F.relu(rnn.linear(num, p, lin, x)), (0,))
    return x


def loss(num: rnn.Numerics, cfg: dict, p: dict, stats: dict, batch: dict, stem_keeps: list,
         keeps: list) -> tuple[torch.Tensor, dict]:
    """``batch``: ``view1`` and ``view2`` (each ``eeg``, ``eye``, ``pps``)
    and the pair ``labels``; ``stem_keeps`` and ``keeps`` hold both views'
    draws in order."""
    z1, new1 = _view(num, cfg, p, stats, batch["view1"], stem_keeps[:2], keeps[:2])
    z2, new2 = _view(num, cfg, p, {**stats, **new1}, batch["view2"], stem_keeps[2:], keeps[2:])
    return rnn.ntxent_two_view(z1, z2, batch["labels"], cfg["temperature"]), new2

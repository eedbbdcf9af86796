"""Plain float32 reference of ``MultimodalTransformerModel`` in train mode
and its LOSO objective (reference repository ``MultimodalModel.py``).

Per model: the EEG encoder (:mod:`.eeg`); eye and PPS transformer
subnetworks (projection, row 0 of the sin/cos table, two post-norm ReLU
encoder layers of 4 heads and feed-forward 3F with dropout at three sites,
LayerNorm); two EEG-queried gated cross-modal blocks; softmax modality
weights; a fusion trunk and two heads of [Linear, BatchNorm, GELU,
Dropout] blocks; three supervised InfoNCE terms on the arousal labels
scaled by the model's contrastive weight. The objective is the masked
cross-entropy of both heads plus the trainer's contrastive weight times
the three terms.

Dropout bits are drawn in the order the forward meets them (:func:`draws`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import eeg
from . import nn as rnn

TRAINER_CW = "trainer.contrastive_weight"
AROUSAL = (128,)
VALENCE = (256, 256, 128, 64)


def _fusion(cfg: dict) -> tuple[int, int]:
    return (cfg["feat_dim"], 128)


def _trunk_names(prefix: str, widths) -> list[tuple[str, str, int]]:
    """(linear, batchnorm, width) of each block: indices 4k and 4k + 1."""
    return [(f"{prefix}.{4 * k}", f"{prefix}.{4 * k + 1}", w) for k, w in enumerate(widths)]


def spec(cfg: dict) -> list:
    f = cfg["feat_dim"]
    out = eeg.spec(cfg)
    for net, width in (("eye_net", cfg["eye_dim"]), ("pps_net", cfg["pps_dim"])):
        out += rnn.linear_spec(f"{net}.proj", width, f)
        for k in range(cfg["encoder_layers"]):
            lay = f"{net}.transformer.layers.{k}"
            out += (rnn.mha_spec(f"{lay}.self_attn", f)
                    + rnn.linear_spec(f"{lay}.linear1", f, cfg["ff_mult"] * f)
                    + rnn.linear_spec(f"{lay}.linear2", cfg["ff_mult"] * f, f)
                    + rnn.norm_spec(f"{lay}.norm1", f) + rnn.norm_spec(f"{lay}.norm2", f))
        out += rnn.norm_spec(f"{net}.norm", f)
    for blk in ("cross_attn_e2p", "cross_attn_p2e"):
        out += (rnn.mha_spec(f"{blk}.multihead_attn", f)
                + rnn.linear_spec(f"{blk}.gate.0", 2 * f, f) + rnn.norm_spec(f"{blk}.norm", f))
    out += (rnn.linear_spec("attention_weights.0", 3 * f, 64)
            + rnn.linear_spec("attention_weights.2", 64, 3))
    fusion = _fusion(cfg)
    for prefix, widths, n_in, classes in (("fusion", fusion, 3 * f, None),
                                          ("arousal_head", AROUSAL, fusion[-1], cfg["classes"]),
                                          ("valence_head", VALENCE, fusion[-1], cfg["classes"])):
        for lin, bn, w in _trunk_names(prefix, widths):
            out += rnn.linear_spec(lin, n_in, w) + rnn.norm_spec(bn, w)
            n_in = w
        if classes:
            out += rnn.linear_spec(f"{prefix}.{4 * len(widths)}", n_in, classes)
    out += [("contrastive_weight", (1,), ("const", 1.0)),
            ("temperature", (), ("const", cfg["temperature"])),
            (TRAINER_CW, (1,), ("const", 1.0))]
    return out


def stats_spec(cfg: dict) -> list:
    out = eeg.stats_spec(cfg)
    for prefix, widths in (("fusion", _fusion(cfg)), ("arousal_head", AROUSAL),
                           ("valence_head", VALENCE)):
        for _, bn, w in _trunk_names(prefix, widths):
            out += rnn.bn_stats_spec(bn, w)
    return out


def draws(cfg: dict, n_models: int, batch: int) -> list[tuple[str, tuple]]:
    """The dropout draws of one train step, in the forward's order: each
    stem stage's seeds (a card) or bits (the CPU), then the uniform draws
    ``(S, *shape)`` of every other site."""
    f = cfg["feat_dim"]
    out = [("stem", shape) for shape in eeg.stage_shapes(cfg, batch)]
    for _ in ("eye_net", "pps_net"):
        for _ in range(cfg["encoder_layers"]):
            out += [("u", (batch, 1, f)), ("u", (batch, 1, cfg["ff_mult"] * f)),
                    ("u", (batch, 1, f))]
    for widths in (_fusion(cfg), AROUSAL, VALENCE):
        out += [("u", (batch, w)) for w in widths]
    return out


def _subnetwork(num, cfg, p, net, x, keeps, rate):
    f = cfg["feat_dim"]
    h = rnn.linear(num, p, f"{net}.proj", x)[:, None, :] + rnn.sincos_row0(f, x)
    for k in range(cfg["encoder_layers"]):
        lay = f"{net}.transformer.layers.{k}"
        a = rnn.mha(num, p, f"{lay}.self_attn", h, h, h, cfg["encoder_heads"])
        h = rnn.layer_norm(p, f"{lay}.norm1", h + rnn.dropout(a, next(keeps), rate))
        ff = F.relu(rnn.linear(num, p, f"{lay}.linear1", h))
        ff = rnn.linear(num, p, f"{lay}.linear2", rnn.dropout(ff, next(keeps), rate))
        h = rnn.layer_norm(p, f"{lay}.norm2", h + rnn.dropout(ff, next(keeps), rate))
    return rnn.layer_norm(p, f"{net}.norm", h[:, 0])


def _cross(num, cfg, p, blk, q, kv):
    attn = rnn.mha(num, p, f"{blk}.multihead_attn", q[:, None], kv[:, None], kv[:, None],
                   cfg["cross_heads"])[:, 0]
    g = torch.sigmoid(rnn.linear(num, p, f"{blk}.gate.0", torch.cat([q, attn], 1)))
    return rnn.layer_norm(p, f"{blk}.norm", g * q + (1.0 - g) * attn)


def _trunk(num, p, stats, new, prefix, widths, x, keeps, rate, head: bool):
    for lin, bn, _ in _trunk_names(prefix, widths):
        x = rnn.linear(num, p, lin, x)
        x = F.gelu(rnn.batch_norm_train(p, stats, new, bn, x, (0,)))
        x = rnn.dropout(x, next(keeps), rate)
    return rnn.linear(num, p, f"{prefix}.{4 * len(widths)}", x) if head else x


def loss(num: rnn.Numerics, cfg: dict, p: dict, stats: dict, batch: dict, stem_keeps: list,
         keeps: list) -> tuple[torch.Tensor, dict]:
    """One model's train-step objective and its new BatchNorm running
    stats. ``batch``: ``eeg (B, C, T)``, ``eye``, ``pps``, ``arousal``,
    ``valence`` (int64) and ``mask`` (1 for a real row)."""
    new: dict = {}
    rate = cfg["dropout"]
    it = iter(keeps)
    e = eeg.forward(num, cfg, p, stats, new, batch["eeg"], stem_keeps)
    eye = _subnetwork(num, cfg, p, "eye_net", batch["eye"], it, rate)
    pps = _subnetwork(num, cfg, p, "pps_net", batch["pps"], it, rate)
    mask = batch["mask"]
    c = sum(rnn.supervised_infonce(f, f, batch["arousal"], p["temperature"], mask)
            for f in (e, eye, pps))
    eye_x = _cross(num, cfg, p, "cross_attn_e2p", e, eye)
    pps_x = _cross(num, cfg, p, "cross_attn_p2e", e, pps)
    w = rnn.linear(num, p, "attention_weights.2",
                   F.gelu(rnn.linear(num, p, "attention_weights.0", torch.cat([e, eye, pps], 1))))
    w = torch.softmax(w, 1)
    fused = _trunk(num, p, stats, new, "fusion", _fusion(cfg),
                   torch.cat([e * w[:, 0:1], eye_x * w[:, 1:2], pps_x * w[:, 2:3]], 1),
                   it, rate, head=False)
    a = _trunk(num, p, stats, new, "arousal_head", AROUSAL, fused, it, rate, head=True)
    v = _trunk(num, p, stats, new, "valence_head", VALENCE, fused, it, rate, head=True)
    ce = (rnn.masked_ce(torch.nan_to_num(a), batch["arousal"], mask)
          + rnn.masked_ce(torch.nan_to_num(v), batch["valence"], mask))
    return ce + p[TRAINER_CW][0] * p["contrastive_weight"][0] * c, new

"""Serving engine: the inference forward built from trained weights.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/eval/serving.py``. The
model (:class:`..models.MultimodalTransformerModel`) is written for parity
with the reference; this module exports the same eval-mode math as a lean
functional forward:

- both EEG conv stages fold BatchNorm and the conv bias into a per-channel
  affine (:func:`..kernels.conv_stem.fold_bn`); with ``use_pallas=True``
  each stage is the fused conv-stem kernel
  (:func:`..kernels.conv_stem.fused_conv_bn_gelu_pool`), otherwise
  ``F.conv1d`` followed by the affine, GELU and pool
- every sequence-length-1 attention site (the eye/PPS self-attention and
  both cross-modal blocks) collapses: softmax over one key is 1, so
  ``MHA(q, k, v) == out_proj(v_proj(v))``
- the positional encoding of a length-1 sequence is its row 0
- BatchNorm in the fusion trunk and heads folds into the preceding Linear
- the BiLSTM runs through :func:`..kernels.lstm.fused_bilstm_layer`, on
  every device: the ops ``msa_torch::bilstm_fwd`` (``bilstm_fwd_xp`` under
  v5), which launch the kernel on CUDA and run its plain version on the CPU,
  so that an export holds the same graph node on both

The math sits in :class:`ServingModule`, which ``torch.export`` traces
(:mod:`.export`); :func:`build_serving_forward` calls it under
``no_grad``.

``use_pallas`` keeps the JAX package's name for the switch to the fused
stem kernel.

``compute_dtype=torch.bfloat16`` serves in bf16 as the JAX forward does:
the weights and BatchNorm statistics are cast first and folded after, in
bf16; each call casts its inputs; the logits come back in fp32. The conv
stem then runs ``F.conv1d`` and the BiLSTM its kernel's bf16 form. The
fused conv-stem kernel has no bf16 form (its JAX counterpart did not
compile for packed bf16 on Mosaic, and the JAX package serves bf16 on the
XLA stem), so ``use_pallas=True`` with bf16 raises.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.conv_stem import fold_bn, fused_conv_bn_gelu_pool, gelu_max_pool
from ..kernels.lstm import check_schedule, fused_bilstm_layer
from ..models.layers import gelu, make_sincos_pe

Forward = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]


def _linear(sd: Mapping[str, torch.Tensor], prefix: str):
    return sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]


def _ln(sd: Mapping[str, torch.Tensor], prefix: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], 1e-5)


def _mha_seq1(sd: Mapping[str, torch.Tensor], prefix: str, value: torch.Tensor):
    """MHA with a single key/query position: ``out_proj(v_proj(value))``."""
    e = value.shape[-1]
    v = F.linear(value, sd[f"{prefix}.in_proj_weight"][2 * e:],
                 sd[f"{prefix}.in_proj_bias"][2 * e:])
    return F.linear(v, *_linear(sd, f"{prefix}.out_proj"))


def _folded_trunk(sd: Mapping[str, torch.Tensor], prefix: str) -> list:
    """[Linear, BN, GELU, Dropout] blocks -> Linears with the running-stat BN
    folded in: ``BN(W x + b) == (s W) x + (s b + shift)``."""
    layers = []
    j = 1
    while f"{prefix}.{j}.running_mean" in sd:
        w, b = _linear(sd, f"{prefix}.{j - 1}")
        scale, shift = fold_bn(sd[f"{prefix}.{j}.weight"], sd[f"{prefix}.{j}.bias"],
                               sd[f"{prefix}.{j}.running_mean"],
                               sd[f"{prefix}.{j}.running_var"], b)
        layers.append((w * scale[:, None], shift))
        j += 4
    return layers


def _run_trunk(layers: list, x: torch.Tensor) -> torch.Tensor:
    for w, b in layers:
        x = gelu(F.linear(x, w, b))
    return x


class ServingModule(nn.Module):
    """The eval forward ``(eeg, eye, pps) -> (arousal, valence)`` as a
    module, for :func:`build_serving_forward` and for ``torch.export``
    (:func:`.export.export_serving`).

    The weights are read from a :class:`..models.MultimodalTransformerModel`
    or its ``state_dict`` once, here: detached, cast to ``compute_dtype``
    where given, BatchNorm folded. They are held as plain tensor attributes,
    not parameters or buffers, so an export bakes them into the program as
    constants, as the JAX export bakes its weights in. The module runs on
    the device the weights are on (``device``); its arguments are
    :func:`build_serving_forward`'s.
    """

    def __init__(self, state_or_model: nn.Module | Mapping[str, torch.Tensor],
                 feat_dim: int = 256, use_pallas: bool = False,
                 compute_dtype: torch.dtype | None = None, lstm_schedule: str = "v9"):
        super().__init__()
        check_schedule(lstm_schedule, compute_dtype or torch.float32)
        if use_pallas and compute_dtype not in (None, torch.float32):
            raise ValueError(
                f"use_pallas=True serves fp32 only, not {compute_dtype}: the fused conv-stem "
                "kernel has no bf16 form (the JAX package serves bf16 on the XLA stem, its "
                "Pallas stem did not compile for packed bf16)")
        sd = (state_or_model.state_dict() if isinstance(state_or_model, nn.Module)
              else dict(state_or_model))
        sd = {k: v.detach() for k, v in sd.items()}
        if compute_dtype is not None:  # cast first, fold after: the JAX order
            sd = {k: v.to(compute_dtype) if v.is_floating_point() else v for k, v in sd.items()}
        self.sd = sd
        self.use_pallas = use_pallas
        self.compute_dtype = compute_dtype
        self.lstm_schedule = lstm_schedule

        self.stem = []
        for conv, bn, padding, pool in (("0", "1", 7, 4), ("5", "6", 2, 2)):
            w, b = _linear(sd, f"eeg_net.temp_conv.{conv}")
            bn = f"eeg_net.temp_conv.{bn}"
            scale, shift = fold_bn(sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                                   sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"], b)
            self.stem.append((w, scale, shift, padding, pool))
        self.lstm_layers = []
        k = 0
        while f"eeg_net.bilstm.weight_ih_l{k}" in sd:
            self.lstm_layers.append(tuple(
                tuple(sd[f"eeg_net.bilstm.{part}_l{k}{suffix}"]
                      for part in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
                for suffix in ("", "_reverse")))
            k += 1
        proj = sd["eye_net.proj.weight"]
        self.device = proj.device
        self.pe0 = make_sincos_pe(feat_dim, 1, device=proj.device)[0].to(proj.dtype)
        self.trunks = {name: _folded_trunk(sd, name)
                       for name in ("fusion", "arousal_head", "valence_head")}
        self.heads = {name: _linear(sd, f"{name}.{4 * len(self.trunks[name])}")
                      for name in ("arousal_head", "valence_head")}

    def eeg_encoder(self, eeg: torch.Tensor) -> torch.Tensor:
        sd = self.sd
        h = eeg.transpose(1, 2).contiguous()  # (B, T, C)
        for w, scale, shift, padding, pool in self.stem:
            if self.use_pallas:
                h = fused_conv_bn_gelu_pool(h, w, scale, shift, padding, pool)
            else:
                y = F.conv1d(h.transpose(1, 2), w, padding=padding).transpose(1, 2)
                h = gelu_max_pool(y * scale + shift, pool)
        freq = F.linear(gelu(F.linear(eeg.mean(dim=1), *_linear(sd, "eeg_net.freq_branch.0"))),
                        *_linear(sd, "eeg_net.freq_branch.2"))
        for fwd, bwd in self.lstm_layers:
            h = fused_bilstm_layer(h, fwd, bwd, schedule=self.lstm_schedule)
        fused = F.linear(torch.cat([h.mean(dim=1), freq], dim=1),
                         *_linear(sd, "eeg_net.fusion.0"))
        return gelu(_ln(sd, "eeg_net.fusion.1", fused))

    def subnetwork(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        sd = self.sd
        h = F.linear(x, *_linear(sd, f"{prefix}.proj")) + self.pe0
        li = 0
        while f"{prefix}.transformer.layers.{li}.linear1.weight" in sd:
            lp = f"{prefix}.transformer.layers.{li}"
            h = _ln(sd, f"{lp}.norm1", h + _mha_seq1(sd, f"{lp}.self_attn", h))
            ff = F.linear(F.relu(F.linear(h, *_linear(sd, f"{lp}.linear1"))),
                          *_linear(sd, f"{lp}.linear2"))
            h = _ln(sd, f"{lp}.norm2", h + ff)
            li += 1
        return _ln(sd, f"{prefix}.norm", h)

    def cross_modal(self, prefix: str, query: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        sd = self.sd
        attn = _mha_seq1(sd, f"{prefix}.multihead_attn", value)
        gate = torch.sigmoid(F.linear(torch.cat([query, attn], dim=1),
                                      *_linear(sd, f"{prefix}.gate.0")))
        return _ln(sd, f"{prefix}.norm", gate * query + (1.0 - gate) * attn)

    def forward(self, eeg: torch.Tensor, eye: torch.Tensor, pps: torch.Tensor):
        if self.compute_dtype is not None:
            eeg, eye, pps = (t.to(self.compute_dtype) for t in (eeg, eye, pps))
        eeg_feat = self.eeg_encoder(eeg)
        eye_feat = self.subnetwork("eye_net", eye)
        pps_feat = self.subnetwork("pps_net", pps)
        eye_enh = self.cross_modal("cross_attn_e2p", eeg_feat, eye_feat)
        pps_enh = self.cross_modal("cross_attn_p2e", eeg_feat, pps_feat)
        concat = torch.cat([eeg_feat, eye_feat, pps_feat], dim=1)
        hidden = gelu(F.linear(concat, *_linear(self.sd, "attention_weights.0")))
        w = torch.softmax(F.linear(hidden, *_linear(self.sd, "attention_weights.2")), dim=1)
        fused = _run_trunk(self.trunks["fusion"], torch.cat(
            [eeg_feat * w[:, 0:1], eye_enh * w[:, 1:2], pps_enh * w[:, 2:3]], dim=1))
        logits = tuple(F.linear(_run_trunk(self.trunks[name], fused), *self.heads[name])
                       for name in ("arousal_head", "valence_head"))
        if self.compute_dtype is not None:
            logits = tuple(t.to(torch.float32) for t in logits)
        return logits


def build_serving_forward(state_or_model: nn.Module | Mapping[str, torch.Tensor],
                          feat_dim: int = 256, use_pallas: bool = False,
                          compute_dtype: torch.dtype | None = None,
                          lstm_schedule: str = "v9") -> Forward:
    """Eval forward ``(eeg, eye, pps) -> (arousal, valence)`` from a
    :class:`..models.MultimodalTransformerModel` or its ``state_dict``: a
    :class:`ServingModule` called under ``no_grad``.

    The forward runs on the device the weights are on. ``use_pallas=True``
    runs both EEG conv stages through the fused conv-stem kernel (fp32
    only). ``compute_dtype`` is the dtype the forward computes in (the
    weights' when None); the logits are fp32 when it is given.
    ``lstm_schedule`` is the BiLSTM's kernel schedule
    (:data:`..kernels.lstm.SCHEDULES`); under ``no_grad`` only v5's forward
    differs from the others'.
    """
    module = ServingModule(state_or_model, feat_dim, use_pallas, compute_dtype, lstm_schedule)

    @torch.no_grad()
    def forward(eeg: torch.Tensor, eye: torch.Tensor, pps: torch.Tensor):
        return module(eeg, eye, pps)

    return forward

"""Int8 post-training quantization of the serving forward.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/eval/quantization.py``,
the same scheme on the port's ``state_dict`` names:

- **weights**: symmetric int8 per output channel, quantized once at build
  time (``scale = max|w| / 127`` over the input and tap axes), BatchNorm
  folded into the preceding conv or Linear first (:func:`quantize_weight`);
- **activations**: a dynamic symmetric scale computed in each call, one per
  row (the last axis) for a Linear (:func:`_qdot`) and one for the whole
  tensor, over the whole batch, for a conv (:func:`_qconv1d`);
- **products**: int8 x int8 with int32 accumulation (``torch._int_mm``;
  the conv as an im2col ``unfold`` then ``_int_mm``), rescaled to float by
  ``sx * sw`` after. The JAX package computes them with
  ``lax.dot_general`` / ``lax.conv_general_dilated`` outside any Pallas
  kernel, so a library product is their counterpart here.

``torch._int_mm`` on CUDA takes more than 16 rows and an inner and outer
size that are multiples of 8; the model's shapes are not (the eye input has
38 features, the PPS input 230, each head 3 outputs) and a serving batch
may have 16 rows or fewer. So every product is zero-padded, on every device
and in one code path: the weight codes once, at build time, to ``(N8, K8)``
(output channel major, the operand ``_int_mm`` reads transposed), the
activation codes in each call to at least 17 rows and K8 columns. Zero
padding is exact in integer arithmetic.

What runs int8: both EEG conv stages, the BiLSTM's input projections, every
Linear of the subnetworks, cross-modal blocks, fusion trunk and heads, and
the collapsed length-1 attention projections. What stays float, in
``compute_dtype``: the LSTM recurrence (:func:`..ops.rnn.bilstm_recurrence`:
row 1's recurrence kernel on a card, the plain scan on the CPU), layer
norms, softmax and sigmoid gates, GELU and pooling. Rounding is half to
even (``torch.round``, as ``jnp.rint``), the clip ±127.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.conv_stem import fold_bn, gelu_max_pool
from ..models.layers import gelu, make_sincos_pe
from ..ops.rnn import bilstm_recurrence

_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
_ALIGN = 8  # ... and inner and outer sizes that are multiples of 8


def _pad_to(n: int, multiple: int = _ALIGN) -> int:
    return -(-n // multiple) * multiple


# --------------------------------------------------------------------------
# build-time weight quantization
# --------------------------------------------------------------------------


def quantize_weight(w: torch.Tensor, reduce_axes: tuple[int, ...]) -> dict:
    """Symmetric int8 per channel: ``{"q": int8, "s": fp32 per channel}``.
    ``reduce_axes`` are folded into each output channel's scale (the input
    and tap axes); the other axes are the channel axes."""
    w = w.detach().float()
    amax = w.abs().amax(dim=reduce_axes, keepdim=True)
    s = amax.clamp_min(1e-12) / 127.0
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s.squeeze(reduce_axes)}


def _with_operand(qw: dict, bias: torch.Tensor) -> dict:
    """``qw`` (``"q"`` of shape ``(..., N)``, the leading axes the
    reduction) with its float ``bias`` and ``"mat"``: the codes as the
    zero-padded ``(N8, K8)`` operand of :func:`_int_mm`."""
    q2 = qw["q"].reshape(-1, qw["q"].shape[-1])  # (K, N)
    k, n = q2.shape
    qw["mat"] = F.pad(q2.T, (0, _pad_to(k) - k, 0, _pad_to(n) - n)).contiguous()
    qw["bias"] = bias.detach().float()
    return qw


def _q_linear_t(w: torch.Tensor, b: torch.Tensor, fold=None) -> dict:
    """Quantize a torch-layout ``x @ w.T + b`` site (``w (out, in)``).
    ``fold=(scale, shift)`` folds a per-output affine (BatchNorm's running
    stats) into the weight and bias first; ``fold_bn`` has already folded
    ``b`` into ``shift``."""
    w = w.detach().float()
    if fold is not None:
        scale, shift = (a.detach().float() for a in fold)
        w, b = w * scale[:, None], shift
    return _with_operand(quantize_weight(w.T, (0,)), b)


def _q_dense(sd: Mapping[str, torch.Tensor], prefix: str, fold=None) -> dict:
    """Quantize the Linear ``prefix`` of a ``state_dict`` (the JAX package's
    Dense site), with an optional BatchNorm ``fold``."""
    return _q_linear_t(sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], fold)


def _q_conv(w: torch.Tensor, fold) -> dict:
    """Quantize a torch-layout conv weight ``(O, I, K)`` with BatchNorm
    folded in: codes ``(K, I, O)`` (tap-major, the im2col order), one scale
    per output channel; the bias is the fold's shift."""
    scale, shift = (a.detach().float() for a in fold)
    w = w.detach().float() * scale[:, None, None]
    return _with_operand(quantize_weight(w.permute(2, 1, 0), (0, 1)), shift)


def _q_bn_trunk(sd: Mapping[str, torch.Tensor], prefix: str) -> list[dict]:
    """Quantize a ``[Linear, BatchNorm, GELU, Dropout]`` trunk: each
    BatchNorm's running stats folded into its Linear."""
    out, j = [], 1
    while f"{prefix}.{j}.running_mean" in sd:
        bn = f"{prefix}.{j}"
        fold = fold_bn(sd[f"{bn}.weight"], sd[f"{bn}.bias"], sd[f"{bn}.running_mean"],
                       sd[f"{bn}.running_var"], sd[f"{prefix}.{j - 1}.bias"])
        out.append(_q_dense(sd, f"{prefix}.{j - 1}", fold))
        j += 4
    return out


def _value_out(sd: Mapping[str, torch.Tensor], prefix: str, e: int) -> tuple[dict, dict]:
    """The length-1 attention of ``prefix``'s MHA: its value and output
    projections."""
    return (_q_linear_t(sd[f"{prefix}.in_proj_weight"][2 * e:],
                        sd[f"{prefix}.in_proj_bias"][2 * e:]),
            _q_linear_t(sd[f"{prefix}.out_proj.weight"], sd[f"{prefix}.out_proj.bias"]))


def _q_subnetwork(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    """Quantize an eye/PPS subnetwork: the projection and each encoder
    layer's value, output and feed-forward Linears; its norms stay float
    (their ``state_dict`` prefixes)."""
    q = {"proj": _q_dense(sd, f"{prefix}.proj"), "layers": [], "norm": f"{prefix}.norm"}
    li = 0
    while f"{prefix}.transformer.layers.{li}.linear1.weight" in sd:
        lp = f"{prefix}.transformer.layers.{li}"
        e = sd[f"{lp}.norm1.weight"].shape[-1]
        v, out = _value_out(sd, f"{lp}.self_attn", e)
        q["layers"].append({"v": v, "out": out, "linear1": _q_dense(sd, f"{lp}.linear1"),
                            "linear2": _q_dense(sd, f"{lp}.linear2"),
                            "norm1": f"{lp}.norm1", "norm2": f"{lp}.norm2"})
        li += 1
    return q


def _q_cross_modal(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    """Quantize a cross-modal block: value, output and gate Linears; its
    norm stays float (its prefix)."""
    e = sd[f"{prefix}.norm.weight"].shape[-1]
    v, out = _value_out(sd, f"{prefix}.multihead_attn", e)
    return {"v": v, "out": out, "gate": _q_dense(sd, f"{prefix}.gate.0"),
            "norm": f"{prefix}.norm"}


# --------------------------------------------------------------------------
# the int8 products
# --------------------------------------------------------------------------


def _quantize_act(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    return torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8)


def _int_mm(xq: torch.Tensor, qw: dict) -> torch.Tensor:
    """``xq (..., K)`` int8 times the site's codes: int32 ``(..., N)``. The
    rows are padded to at least 17 and K to the operand's K8 with zeros."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    n8, k8 = qw["mat"].shape
    rows = xq.reshape(-1, k)
    m = rows.shape[0]
    rows = F.pad(rows, (0, k8 - k, 0, max(_ROWS - m, 0)))
    acc = torch._int_mm(rows, qw["mat"].T)
    return acc[:m, :qw["s"].shape[0]].reshape(*lead, -1)


def _qdot(x: torch.Tensor, qw: dict, out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ dequant(qw) + bias`` with the product in int8: a dynamic
    symmetric scale per row (the last axis), int32 accumulation, the float
    rescale by ``sx * sw`` after."""
    sx = x.abs().amax(dim=-1, keepdim=True).float().clamp_min(1e-12) / 127.0
    acc = _int_mm(_quantize_act(x, sx), qw)
    return (acc.float() * sx * qw["s"] + qw["bias"]).to(out_dtype)


def _qconv1d(x: torch.Tensor, qw: dict, padding: int, out_dtype: torch.dtype) -> torch.Tensor:
    """NLC int8 conv ``x (B, T, C)`` -> ``(B, L, O)``: one dynamic scale for
    the whole tensor, the zero-padded codes unfolded into tap-major windows
    (im2col), then one :func:`_int_mm`."""
    sx = x.abs().amax().float().clamp_min(1e-12) / 127.0
    xq = F.pad(_quantize_act(x, sx), (0, 0, padding, padding))  # (B, T + 2p, C)
    taps = qw["q"].shape[0]
    windows = xq.unfold(1, taps, 1).transpose(-1, -2)  # (B, L, K, C)
    acc = _int_mm(windows.flatten(-2), qw)
    return (acc.float() * (sx * qw["s"]) + qw["bias"]).to(out_dtype)


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------


def build_quantized_serving_forward(
        state_or_model: nn.Module | Mapping[str, torch.Tensor], feat_dim: int = 256,
        compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Int8 eval forward ``(eeg, eye, pps) -> (arousal, valence)`` of a
    :class:`..models.MultimodalTransformerModel` or its ``state_dict``, in
    place of :func:`.serving.build_serving_forward`; the weights are
    quantized here, once, on their device. ``compute_dtype`` is the dtype
    of the float glue between the int8 products (bf16 by default); the
    logits are fp32. Runs under ``no_grad`` on the device the weights are
    on."""
    sd = (state_or_model.state_dict() if isinstance(state_or_model, nn.Module)
          else dict(state_or_model))
    sd = {k: v.detach() for k, v in sd.items()}
    dt = compute_dtype
    glue = {k: v.to(dt) for k, v in sd.items() if v.is_floating_point()}  # norms, w_hh

    def ln(prefix: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], glue[f"{prefix}.weight"], glue[f"{prefix}.bias"],
                            1e-5)

    convs = []
    for conv, bn, padding, pool in (("0", "1", 7, 4), ("5", "6", 2, 2)):
        c, b = f"eeg_net.temp_conv.{conv}", f"eeg_net.temp_conv.{bn}"
        fold = fold_bn(sd[f"{b}.weight"], sd[f"{b}.bias"], sd[f"{b}.running_mean"],
                       sd[f"{b}.running_var"], sd[f"{c}.bias"])
        convs.append((_q_conv(sd[f"{c}.weight"], fold), padding, pool))
    lstm_layers = []
    k = 0
    while f"eeg_net.bilstm.weight_ih_l{k}" in sd:
        p = f"eeg_net.bilstm.{{}}_l{k}{{}}"
        lstm_layers.append({
            d: _q_linear_t(sd[p.format("weight_ih", sfx)],
                           sd[p.format("bias_ih", sfx)] + sd[p.format("bias_hh", sfx)])
            for d, sfx in (("f", ""), ("b", "_reverse"))})
        lstm_layers[-1]["whf"] = glue[p.format("weight_hh", "")]
        lstm_layers[-1]["whb"] = glue[p.format("weight_hh", "_reverse")]
        k += 1
    freq1, freq2 = _q_dense(sd, "eeg_net.freq_branch.0"), _q_dense(sd, "eeg_net.freq_branch.2")
    eeg_fusion = _q_dense(sd, "eeg_net.fusion.0")
    subnets = {name: _q_subnetwork(sd, name) for name in ("eye_net", "pps_net")}
    crosses = {name: _q_cross_modal(sd, name)
               for name in ("cross_attn_e2p", "cross_attn_p2e")}
    attn1, attn2 = _q_dense(sd, "attention_weights.0"), _q_dense(sd, "attention_weights.2")
    trunks = {name: _q_bn_trunk(sd, name) for name in ("fusion", "arousal_head", "valence_head")}
    heads = {name: _q_dense(sd, f"{name}.{4 * len(trunks[name])}")
             for name in ("arousal_head", "valence_head")}
    proj = sd["eye_net.proj.weight"]
    pe0 = make_sincos_pe(feat_dim, 1, device=proj.device)[0].to(dt)

    def trunk(layers: list[dict], x: torch.Tensor) -> torch.Tensor:
        for qw in layers:
            x = gelu(_qdot(x, qw, dt))
        return x

    def subnet(q: dict, x: torch.Tensor) -> torch.Tensor:
        h = _qdot(x, q["proj"], dt) + pe0
        for lp in q["layers"]:
            h = ln(lp["norm1"], h + _qdot(_qdot(h, lp["v"], dt), lp["out"], dt))
            ff = _qdot(F.relu(_qdot(h, lp["linear1"], dt)), lp["linear2"], dt)
            h = ln(lp["norm2"], h + ff)
        return ln(q["norm"], h)

    def cross(q: dict, query: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        attn = _qdot(_qdot(value, q["v"], dt), q["out"], dt)
        gate = torch.sigmoid(_qdot(torch.cat([query, attn], dim=1), q["gate"], dt))
        return ln(q["norm"], gate * query + (1.0 - gate) * attn)

    @torch.no_grad()
    def forward(eeg: torch.Tensor, eye: torch.Tensor, pps: torch.Tensor):
        eeg, eye, pps = (a.to(dt) for a in (eeg, eye, pps))
        h = eeg.transpose(1, 2)  # (B, T, C)
        for qw, padding, pool in convs:
            h = gelu_max_pool(_qconv1d(h, qw, padding, dt), pool)
        freq = _qdot(gelu(_qdot(eeg.mean(dim=1), freq1, dt)), freq2, dt)
        for lw in lstm_layers:
            xf = _qdot(h, lw["f"], dt)
            xb = _qdot(h.flip(1), lw["b"], dt)
            h = bilstm_recurrence(xf, xb, lw["whf"], lw["whb"])
        eeg_feat = gelu(ln("eeg_net.fusion.1",
                            _qdot(torch.cat([h.mean(dim=1), freq], dim=1), eeg_fusion, dt)))
        eye_feat = subnet(subnets["eye_net"], eye)
        pps_feat = subnet(subnets["pps_net"], pps)
        eye_enh = cross(crosses["cross_attn_e2p"], eeg_feat, eye_feat)
        pps_enh = cross(crosses["cross_attn_p2e"], eeg_feat, pps_feat)
        concat = torch.cat([eeg_feat, eye_feat, pps_feat], dim=1)
        w = torch.softmax(_qdot(gelu(_qdot(concat, attn1, dt)), attn2, dt), dim=1)
        fused = trunk(trunks["fusion"], torch.cat(
            [eeg_feat * w[:, 0:1], eye_enh * w[:, 1:2], pps_enh * w[:, 2:3]], dim=1))
        return tuple(_qdot(trunk(trunks[name], fused), heads[name], torch.float32)
                     for name in ("arousal_head", "valence_head"))

    return forward

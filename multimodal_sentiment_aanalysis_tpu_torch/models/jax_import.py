"""JAX package variables -> this port's ``state_dict``.

:func:`state_dict_from_jax_variables` is the exact inverse of
``multimodal_sentiment_aanalysis_tpu/models/torch_import.py::
variables_from_torch_state_dict`` for the flagship model: it takes the JAX
``{"params": ..., "batch_stats": ...}`` tree (arrays of any kind numpy can
read) and returns the reference-named ``state_dict`` that
:class:`.fusion_model.MultimodalTransformerModel` loads with
``strict=True``. Flax ``(in, out)`` Dense kernels transpose back to torch
``(out, in)``; Conv1d, attention and LSTM weights are already in torch
layout. :func:`trainer_state_from_jax` also carries the JAX ``Trainer``'s
own learnable ``params["trainer"]["contrastive_weight"]``, so both trainers
can start from one state. Needs only numpy and torch.

The ME-MHACL importers invert ``memhacl_encoder_variables_from_torch_state_dict``
and the SimCLR projection and classifier importers, whose layouts ME-MHACL
shares: :func:`memhacl_encoder_state_dict_from_jax`,
:func:`projection_head_state_dict_from_jax` and
:func:`classifier_state_dict_from_jax` give the ``state_dict`` of
:class:`.memhacl.MEMHACLEncoder`, :class:`.simclr.ProjectionHead` and
:class:`.memhacl.MEMHACLClassifier`.

The SimCLR encoder importer, :func:`simclr_encoder_state_dict_from_jax`,
inverts ``simclr_encoder_variables_from_torch_state_dict`` and gives the
``state_dict`` of :class:`.simclr.MultiModalEncoder`;
:func:`simclr_state_from_jax` carries the JAX ``VectorizedSimCLRTrainer``'s
stacked ``(params, batch_stats, clf_params)`` to the three modules' stacked
``state_dict`` s.

The flagship importers also take the JAX ``VectorizedLOSOTrainer``'s and
``VectorizedPhasedTrainer``'s stacked variables (the ``vmap(init_one)``
output, every leaf with a leading model axis S) and then return every
tensor with that leading axis, the layout of
:class:`..train.vloso.VectorizedLOSOTrainer`'s stacked state
(:func:`trainer_state_from_jax`) and of
:class:`..train.vphased.VectorizedPhasedTrainer`'s
(:func:`phased_state_from_jax`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(p: Mapping[str, Any], prefix: str) -> dict:
    return {f"{prefix}.weight": _t(np.swapaxes(np.asarray(p["kernel"]), -1, -2)),
            f"{prefix}.bias": _t(p["bias"])}


def _norm(p: Mapping[str, Any], prefix: str) -> dict:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _bn(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str) -> dict:
    return {**_norm(p, prefix),
            f"{prefix}.running_mean": _t(stats["mean"]),
            f"{prefix}.running_var": _t(stats["var"]),
            f"{prefix}.num_batches_tracked": torch.zeros(np.shape(stats["mean"])[:-1],
                                                         dtype=torch.long)}


def _mha(p: Mapping[str, Any], prefix: str) -> dict:
    return {f"{prefix}.in_proj_weight": _t(p["in_proj_weight"]),
            f"{prefix}.in_proj_bias": _t(p["in_proj_bias"]),
            f"{prefix}.out_proj.weight": _t(p["out_proj_weight"]),
            f"{prefix}.out_proj.bias": _t(p["out_proj_bias"])}


def _trunk(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str) -> dict:
    """``dense_j``/``bn_j`` -> Sequential positions ``4j`` and ``4j + 1``."""
    sd: dict = {}
    j = 0
    while f"dense_{j}" in p:
        sd.update(_linear(p[f"dense_{j}"], f"{prefix}.{4 * j}"))
        sd.update(_bn(p[f"bn_{j}"], stats[f"bn_{j}"], f"{prefix}.{4 * j + 1}"))
        j += 1
    return sd


def _head(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str) -> dict:
    blocks = sum(name.startswith("dense_") for name in p["trunk"])
    return {**_trunk(p["trunk"], stats["trunk"], prefix),
            **_linear(p["out"], f"{prefix}.{4 * blocks}")}


def _subnetwork(p: Mapping[str, Any], prefix: str) -> dict:
    sd = {**_linear(p["proj"], f"{prefix}.proj"), **_norm(p["norm"], f"{prefix}.norm")}
    for name, lp in p["transformer"].items():
        lpre = f"{prefix}.transformer.layers.{int(name.split('_')[1])}"
        sd.update(_mha(lp["self_attn"], f"{lpre}.self_attn"))
        for part in ("linear1", "linear2"):
            sd.update(_linear(lp[part], f"{lpre}.{part}"))
        for part in ("norm1", "norm2"):
            sd.update(_norm(lp[part], f"{lpre}.{part}"))
    return sd


def _cross_modal(p: Mapping[str, Any], prefix: str) -> dict:
    return {**_mha(p["attn"], f"{prefix}.multihead_attn"),
            **_linear(p["gate"], f"{prefix}.gate.0"),
            **_norm(p["norm"], f"{prefix}.norm")}


def _eeg_net(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str) -> dict:
    sd = {
        f"{prefix}.temp_conv.0.weight": _t(p["conv1_weight"]),
        f"{prefix}.temp_conv.0.bias": _t(p["conv1_bias"]),
        f"{prefix}.temp_conv.5.weight": _t(p["conv2_weight"]),
        f"{prefix}.temp_conv.5.bias": _t(p["conv2_bias"]),
        **_bn(p["bn1"], stats["bn1"], f"{prefix}.temp_conv.1"),
        **_bn(p["bn2"], stats["bn2"], f"{prefix}.temp_conv.6"),
        **_linear(p["freq1"], f"{prefix}.freq_branch.0"),
        **_linear(p["freq2"], f"{prefix}.freq_branch.2"),
        **_linear(p["fusion_dense"], f"{prefix}.fusion.0"),
        **_norm(p["fusion_ln"], f"{prefix}.fusion.1"),
    }
    k = 0
    while f"lstm{k}_w_ih_fwd" in p:
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            for part, torch_part in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                     ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                sd[f"{prefix}.bilstm.{torch_part}_l{k}{suffix}"] = _t(
                    p[f"lstm{k}_{part}_{direction}"])
        k += 1
    return sd


def state_dict_from_jax_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``MultimodalTransformerModel`` variables -> the port's
    ``state_dict`` (CPU fp32 tensors; ``num_batches_tracked`` 0), stacked
    where the variables are."""
    p, s = variables["params"], variables["batch_stats"]
    return {
        **_eeg_net(p["eeg_net"], s["eeg_net"], "eeg_net"),
        **_subnetwork(p["eye_net"], "eye_net"),
        **_subnetwork(p["pps_net"], "pps_net"),
        **_cross_modal(p["cross_attn_e2p"], "cross_attn_e2p"),
        **_cross_modal(p["cross_attn_p2e"], "cross_attn_p2e"),
        **_linear(p["attn_w1"], "attention_weights.0"),
        **_linear(p["attn_w2"], "attention_weights.2"),
        **_trunk(p["fusion_stack"], s["fusion_stack"], "fusion"),
        **_head(p["arousal_head"], s["arousal_head"], "arousal_head"),
        **_head(p["valence_head"], s["valence_head"], "valence_head"),
        "contrastive_weight": _t(p["contrastive_weight"]),
        # one model's is () (flax may give (1,)); stacked, (S,)
        "temperature": _t(p["temperature"]).reshape(np.shape(p["contrastive_weight"])[:-1]),
    }


def trainer_state_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                           ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """A JAX ``train.engine.Trainer``'s ``(params, batch_stats)``, whose
    params are ``{"model": ..., "trainer": {"contrastive_weight": (1,)}}``
    -> the model's ``state_dict`` and the trainer-level contrastive weight
    (:attr:`..train.engine.Trainer.contrastive_weight`). The stacked state of
    the JAX ``VectorizedLOSOTrainer`` gives the stacked ``state_dict`` and
    the ``(S, 1)`` contrastive weights."""
    sd = state_dict_from_jax_variables({"params": params["model"], "batch_stats": batch_stats})
    return sd, _t(params["trainer"]["contrastive_weight"])


def phased_state_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                          ) -> dict[str, torch.Tensor]:
    """The JAX ``VectorizedPhasedTrainer``'s stacked ``(params,
    batch_stats)`` (its ``vmap(init_one)`` init, or its state after any
    phase) -> the stacked ``state_dict`` of
    :class:`..train.vphased.VectorizedPhasedTrainer`. Its params are the
    model's alone: the phased row has no trainer-level contrastive weight.
    One subject's ``(params, batch_stats)`` (``MultiTaskTrainer``'s) give the
    model's ``state_dict``."""
    return state_dict_from_jax_variables({"params": params, "batch_stats": batch_stats})


def _conv_gap_stack(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str) -> dict:
    """``conv{j}_weight``/``conv{j}_bias``/``bn{j}`` and ``proj`` -> the
    Sequential ``[Conv1d, BatchNorm1d, ReLU]*n, AdaptiveAvgPool1d, Flatten,
    Linear``: conv at ``3j``, BN at ``3j + 1``, Linear at ``3n + 2``."""
    sd: dict = {}
    n = 0
    while f"conv{n}_weight" in p:
        sd[f"{prefix}.{3 * n}.weight"] = _t(p[f"conv{n}_weight"])
        sd[f"{prefix}.{3 * n}.bias"] = _t(p[f"conv{n}_bias"])
        sd.update(_bn(p[f"bn{n}"], stats[f"bn{n}"], f"{prefix}.{3 * n + 1}"))
        n += 1
    return {**sd, **_linear(p["proj"], f"{prefix}.{3 * n + 2}")}


def memhacl_encoder_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``MEMHACLEncoder`` variables -> the port's ``state_dict``."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for name in ("eeg_encoder", "eye_encoder", "phy_encoder"):
        sd.update(_conv_gap_stack(p[name], s[name], name))
    return {**sd, **_mha(p["multihead_attn"], "multihead_attn")}


def projection_head_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``ProjectionHead`` variables -> ``net.0/2/4/6/8``."""
    p, s = variables["params"], variables["batch_stats"]
    return {**_linear(p["dense_0"], "net.0"), **_bn(p["bn_0"], s["bn_0"], "net.2"),
            **_linear(p["dense_1"], "net.4"), **_bn(p["bn_1"], s["bn_1"], "net.6"),
            **_linear(p["out"], "net.8")}


def classifier_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``MEMHACLClassifier`` (or SimCLR ``Classifier``) variables ->
    ``shared.0``, ``fc_arousal``, ``fc_valence``."""
    p = variables["params"]
    return {**_linear(p["shared"], "shared.0"), **_linear(p["fc_arousal"], "fc_arousal"),
            **_linear(p["fc_valence"], "fc_valence")}


def _relu_bn_mlp(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str) -> dict:
    """``net.dense_j``/``net.bn_j`` -> the Sequential ``[Linear, ReLU,
    BatchNorm1d]*``: Linear at ``3j``, BN at ``3j + 2``."""
    p, stats = p["net"], stats["net"]
    sd: dict = {}
    j = 0
    while f"dense_{j}" in p:
        sd.update(_linear(p[f"dense_{j}"], f"{prefix}.net.{3 * j}"))
        sd.update(_bn(p[f"bn_{j}"], stats[f"bn_{j}"], f"{prefix}.net.{3 * j + 2}"))
        j += 1
    return sd


def simclr_encoder_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX SimCLR ``MultiModalEncoder`` variables -> the port's
    ``state_dict`` (``eeg_net``, ``eye_net.net``, ``pps_net.net``,
    ``multihead_attn``, ``fusion_mlp.0/2``), stacked where the variables
    are."""
    p, s = variables["params"], variables["batch_stats"]
    return {
        **_eeg_net(p["eeg_net"], s["eeg_net"], "eeg_net"),
        **_relu_bn_mlp(p["eye_net"], s["eye_net"], "eye_net"),
        **_relu_bn_mlp(p["pps_net"], s["pps_net"], "pps_net"),
        **_mha(p["multihead_attn"], "multihead_attn"),
        **_linear(p["fusion_dense"], "fusion_mlp.0"),
        **_bn(p["fusion_bn"], s["fusion_bn"], "fusion_mlp.2"),
    }


def simclr_state_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                          clf_params: Mapping[str, Any]) -> tuple[dict, dict, dict]:
    """The JAX ``VectorizedSimCLRTrainer``'s ``(params, batch_stats,
    clf_params)`` (its ``vmap(init_one)`` init, or its state after a stage;
    ``params`` and ``batch_stats`` are ``{"enc": ..., "proj": ...}``) -> the
    stacked ``state_dict`` s of the encoder, the projection head and the
    classifier, every tensor with the leading model axis, which
    :meth:`..train.vsimclr.VectorizedSimCLRTrainer.load_stacked_state`
    takes. One subject's state gives the three modules' ``state_dict`` s."""
    return (simclr_encoder_state_dict_from_jax({"params": params["enc"],
                                                "batch_stats": batch_stats["enc"]}),
            projection_head_state_dict_from_jax({"params": params["proj"],
                                                 "batch_stats": batch_stats["proj"]}),
            classifier_state_dict_from_jax({"params": clf_params}))

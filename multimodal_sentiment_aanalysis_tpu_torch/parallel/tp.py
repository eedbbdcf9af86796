"""Tensor parallelism over a 2-D ``(data, model)`` mesh of ranks.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/parallel/tp.py``. JAX
annotates the parameter tree with Megatron-style ``PartitionSpec`` s and
``jit`` s the unchanged step, and GSPMD inserts the collectives. The port
runs one process per card, and a CUDA tensor launches its kernel or raises,
so the flagship has sharded forms that compute on this rank's blocks with
explicit collectives over the model axis
(:class:`.collectives.ModelAxis`) and still launch their kernels:

- :func:`make_mesh_2d`: a ``(dp, tp)`` :class:`DeviceMesh` over the ranks,
  axes ``("data", "model")``, the model axis innermost (rank ``d tp + m``);
- :func:`param_partition_specs`: JAX's placement of every parameter of
  the flagship, under its ``state_dict`` name, in torch layout (a tuple of
  axis names and None, one per dim, ``()`` replicated). The rules are
  JAX's, quirks included (qkv row blocks not aligned to heads, a sharded
  ``out_proj`` bias, ``eeg_net.fusion_ln``'s bias sharded and its scale
  not), applied to each flax leaf the port's parameter imports from
  (:mod:`..models.jax_import`), a flax Dense kernel's two dims swapped;
- :func:`shard_by_specs`: a copy of the model holding this rank's block of
  every split parameter under its unsharded name (and its BatchNorm's
  running stats, which follow its scale), each module swapped for its
  sharded form (:data:`SHARDED_FORMS`); ``torch.func.functional_call``,
  ``torch.optim.AdamW`` and the step helpers of :mod:`.dp` run on it
  unchanged;
- :func:`batch_sharding`: this rank's block of a batch over the data axis,
  replicated over the model axis;
- :func:`gather_state_dict`: the inverse JAX gets from ``np.asarray`` of a
  sharded array, the whole ``state_dict`` on every rank.

How each family computes (the layout is JAX's, so this is what the port's
forms do with it): the transformer feed-forward is Megatron's pair (one
sum over the model axis); attention gathers ``in_proj``'s weight and bias
and projects whole, and sums ``out_proj``'s partial products, adding its
gathered bias once; every other split Linear is column-parallel and
gathers its output where the next op needs whole rows, except the trunk's,
whose BatchNorm, GELU and dropout run on this rank's features; the conv
stem runs on this rank's output channels, the stem-tail kernel on that
channel shard; the BiLSTM gathers each layer's gate rows and runs the whole
layer's kernels, since its recurrence needs the whole ``h`` every step.

The data axis: inside :func:`.collectives.global_batch` over the data
group (what :func:`.dp.global_batch_step` enters on a 2-D mesh), the
BatchNorm statistics, the stem tail's backward, the CE means and the
InfoNCE gather reduce over the data axis alone. A replicated parameter's
gradient is the same on every model rank, so gradients are summed over
the data axis only, and :func:`..train.state.clip_by_global_norm` forms the
norm of the whole parameter vector. Every model rank of a data row draws
one dropout stream (:func:`.mesh.rank_seed` of the data index).
"""

from __future__ import annotations

import copy
import re
from typing import Any

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from ..models.eeg import BiLSTM, EEGMultiScaleNet, ShardedBiLSTM, ShardedEEGMultiScaleNet
from ..models.fusion_model import MultimodalTransformerModel, ShardedMultimodalTransformerModel
from ..models.layers import (LayerNorm, Linear, MultiheadAttention, ShardedLayerNorm,
                             ShardedLinear, ShardedMultiheadAttention,
                             ShardedTransformerEncoderLayer, TransformerEncoderLayer)
from .collectives import ModelAxis
from .mesh import shard_batch, start_group

# each module type of the flagship and its sharded form
SHARDED_FORMS = {
    Linear: ShardedLinear,
    LayerNorm: ShardedLayerNorm,
    MultiheadAttention: ShardedMultiheadAttention,
    TransformerEncoderLayer: ShardedTransformerEncoderLayer,
    BiLSTM: ShardedBiLSTM,
    EEGMultiScaleNet: ShardedEEGMultiScaleNet,
    MultimodalTransformerModel: ShardedMultimodalTransformerModel,
}
# modules whose split parameters the parent's sharded form reads
_READ_BY_PARENT = (nn.Conv1d, nn.BatchNorm1d)
# the mesh's axis names, as JAX's
DATA, MODEL = "data", "model"


def make_mesh_2d(dp: int, tp: int, device_type: str | None = None) -> DeviceMesh:
    """A ``(dp, tp)`` mesh over the ranks of the default process group
    (started when there is none, as :func:`.mesh.make_mesh` does), the
    model axis innermost. ``dp * tp`` other than the world size raises."""
    device_type = start_group(device_type)
    world = dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks, the process group has "
                         f"{world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(dp, tp),
                      mesh_dim_names=(DATA, MODEL))


def _jax_spec(parent: str, name: str, shape: tuple, tp: int) -> tuple:
    """JAX ``_specs_for_module``'s rule for one flax leaf ``name`` of module
    ``parent``, of flax shape ``shape``, in its order."""
    def splits(d: int) -> bool:
        return shape[d] % tp == 0

    lstm = name.startswith("lstm")
    if name == "in_proj_weight" and splits(0):
        return (MODEL, None)
    if name == "out_proj_weight" and splits(1):
        return (None, MODEL)
    if lstm and "_w_" in name and splits(0):
        return (MODEL, None)
    if lstm and "_b_" in name and splits(0):
        return (MODEL,)
    if name == "in_proj_bias" and splits(0):
        return (MODEL,)
    if name == "kernel" and len(shape) == 2:
        if parent == "linear2":
            return (MODEL, None) if splits(0) else ()
        return (None, MODEL) if splits(1) else ()
    if name == "bias" and len(shape) == 1:
        if parent == "linear2" or parent.startswith("norm"):
            return ()
        return (MODEL,) if splits(0) else ()
    if name.endswith("_weight") and len(shape) == 3 and splits(0):
        return (MODEL, None, None)
    if name.endswith("_bias") and splits(0):
        return (MODEL,)
    if parent.startswith("bn") and name in ("scale", "bias") and splits(0):
        return (MODEL,)
    return ()


def _flax_leaf(module_name: str, module: nn.Module, pname: str) -> tuple[str, str, bool]:
    """``(flax module, flax leaf, transposed)`` of the port's parameter
    ``pname`` of ``module`` (:mod:`..models.jax_import`'s correspondence;
    only the names the rules read are kept)."""
    last = module_name.rsplit(".", 1)[-1]
    affine = "scale" if pname == "weight" else "bias"
    if isinstance(module, MultiheadAttention):
        return "attn", pname, False
    if isinstance(module, nn.Linear) and last == "out_proj":
        return "attn", f"out_proj_{pname}", False
    if isinstance(module, nn.Linear):  # a flax Dense: kernel (in, out)
        parent = "linear2" if last == "linear2" else "dense"
        return parent, "kernel" if pname == "weight" else "bias", pname == "weight"
    if isinstance(module, nn.LayerNorm):  # norm, norm1, norm2 or eeg_net's fusion_ln
        return last if last.startswith("norm") else "fusion_ln", affine, False
    if isinstance(module, nn.BatchNorm1d):
        return "bn", affine, False
    if isinstance(module, nn.Conv1d):
        return "eeg_net", f"conv_{pname}", False
    if isinstance(module, BiLSTM):  # weight_ih_l0_reverse -> lstm0_w_ih_bwd
        kind, gate, k, reverse = re.fullmatch(r"(weight|bias)_(ih|hh)_l(\d+)(_reverse)?",
                                              pname).groups()
        return "eeg_net", f"lstm{k}_{kind[0]}_{gate}_{'bwd' if reverse else 'fwd'}", False
    if isinstance(module, MultimodalTransformerModel):  # temperature, contrastive_weight
        return "", pname, False
    raise ValueError(f"no JAX placement rule for {type(module).__name__} parameter "
                     f"{module_name}.{pname}")


def param_partition_specs(model: nn.Module, tp: int) -> dict[str, tuple]:
    """JAX's Megatron-style placement of every parameter of the flagship
    ``model``, by ``state_dict`` name, in torch layout: a tuple with the
    mesh axis name at the split dim and None elsewhere, ``()`` for a
    replicated parameter. A dim that ``tp`` does not divide stays
    replicated; ``tp <= 1`` replicates everything."""
    specs = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            if tp <= 1:
                specs[full] = ()
                continue
            parent, leaf, transposed = _flax_leaf(mname, m, pname)
            shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
            spec = _jax_spec(parent, leaf, shape, tp)
            specs[full] = spec[::-1] if transposed else spec
    return specs


def _split_dim(spec: tuple) -> int | None:
    return spec.index(MODEL) if MODEL in spec else None


def shard_by_specs(mesh: DeviceMesh, model: nn.Module, specs: dict[str, tuple]) -> nn.Module:
    """A copy of ``model`` for this rank of ``mesh``: every parameter that
    ``specs`` splits replaced by this rank's block along the model axis
    (tagged ``tp_axis``), a split BatchNorm's running stats with it, and
    each module of :data:`SHARDED_FORMS` swapped for its sharded form, which
    reads ``tp`` (the model axis) and ``tp_split`` (the split dim of each of
    its tensors, None where whole). ``model`` stays as it is."""
    axis = ModelAxis(mesh.get_group(MODEL))
    sharded = copy.deepcopy(model)
    for mname, m in sharded.named_modules():
        m.tp, m.tp_split = axis, {}
        for pname, p in list(m.named_parameters(recurse=False)):
            dim = _split_dim(specs[f"{mname}.{pname}" if mname else pname])
            m.tp_split[pname] = dim
            if dim is None:
                continue
            if type(m) not in SHARDED_FORMS and not isinstance(m, _READ_BY_PARENT):
                raise ValueError(f"{mname}.{pname}: no sharded form of {type(m).__name__}")
            n = p.shape[dim] // axis.size
            block = nn.Parameter(p.detach().narrow(dim, axis.index * n, n).clone(),
                                 requires_grad=p.requires_grad)
            block.tp_axis = axis
            setattr(m, pname, block)
        if isinstance(m, nn.BatchNorm1d) and m.tp_split["weight"] is not None:
            n = m.num_features // axis.size
            for name in ("running_mean", "running_var"):
                setattr(m, name, getattr(m, name).narrow(0, axis.index * n, n).clone())
                m.tp_split[name] = 0
        if type(m) in SHARDED_FORMS:
            m.__class__ = SHARDED_FORMS[type(m)]
    return sharded


def batch_sharding(mesh: DeviceMesh, batch: dict[str, Any]) -> dict[str, Any]:
    """This rank's block of every tensor of ``batch`` over the data axis,
    replicated over the model axis (JAX's ``P('data')``)."""
    return shard_batch(mesh, batch)


@torch.no_grad()
def gather_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a :func:`shard_by_specs` model, on every
    rank: each split tensor's blocks gathered along its split dim (a
    collective over the model axis, so every rank calls it)."""
    splits = {}
    for mname, m in model.named_modules():
        for name, dim in getattr(m, "tp_split", {}).items():
            if dim is not None:
                splits[f"{mname}.{name}" if mname else name] = (m.tp, dim)
    out = {}
    for k, v in model.state_dict().items():
        axis, dim = splits.get(k, (None, None))
        out[k] = v if axis is None else axis.gather(v, dim)
    return out

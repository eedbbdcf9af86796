"""Shared layers with the reference's torch numerics and parameter names.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/models/layers.py``:
sin/cos positional encoding, ``nn.MultiheadAttention``-layout attention
with a packed ``in_proj``, and the post-norm ReLU transformer encoder
layer. GELU is the exact erf form everywhere.

Dropout is :func:`dropout`: a keep mask drawn with ``torch.rand`` from the
``generator`` the caller passes (the device's default generator when None),
applied in train mode only. The modules keep no generator of their own.

:class:`Linear` and :class:`LayerNorm` follow flax's dtype rule: the input
and the parameters are promoted to their common dtype. Where the dtypes
agree nothing changes; where they do not, as in the bf16 trainer's forward
(bf16 parameters, and fp32 activations after the fp32 positional encoding,
exactly as in the JAX model), the layer computes in the wider dtype instead
of raising.

Tensor parallelism (:mod:`..parallel.tp`) swaps each of these modules for
its sharded form (:class:`ShardedLinear`, :class:`ShardedLayerNorm`,
:class:`ShardedMultiheadAttention`, :class:`ShardedTransformerEncoderLayer`),
which holds this rank's block of each split parameter (``tp_split`` names
the split dim of each, ``tp`` is the model axis,
:class:`..parallel.collectives.ModelAxis`) and computes with explicit
collectives over the model axis; a module none of whose parameters is
split computes as it does in one process. Dropout on a sharded activation
draws the whole activation's mask from the generator and keeps this rank's
columns (``dropout(..., shard=)``), so every model rank draws one process's
stream.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.attention import flash_mha


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.linear`` with the input and the parameters promoted to their
    common dtype (flax ``Dense``)."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


class Linear(nn.Linear):
    """``nn.Linear`` whose forward is :func:`linear`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with the input and the parameters promoted to their
    common dtype (flax ``LayerNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape, self.weight.to(dt),
                            self.bias.to(dt), self.eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-GELU (torch ``nn.GELU`` default)."""
    return F.gelu(x)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None = None,
            shard: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout: ``x * keep / (1 - p)`` with ``keep ~ Bernoulli(1 - p)``
    from ``generator``; identity in eval mode or at ``p == 0``. ``shard=(i,
    n)``: ``x`` is block ``i`` of ``n`` of an activation split on its last
    dim, whose whole mask is drawn and whose block ``i`` is kept."""
    if not training or p == 0.0:
        return x
    if shard is None:
        keep = torch.rand(x.shape, device=x.device, generator=generator) >= p
    else:
        i, n = shard
        c = x.shape[-1]
        u = torch.rand((*x.shape[:-1], n * c), device=x.device, generator=generator)
        keep = u[..., i * c:(i + 1) * c] >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def make_sincos_pe(d_model: int, max_len: int, device=None) -> torch.Tensor:
    """Standard sin/cos positional table ``(max_len, d_model)``."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    pe = torch.zeros(max_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """Additive sin/cos PE. The table is computed, not a trained weight, so
    it stays out of the ``state_dict`` (as the import path drops it)."""

    def __init__(self, d_model: int, max_len: int = 5000, device=None):
        super().__init__()
        self.register_buffer("pe", make_sincos_pe(d_model, max_len, device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[None, : x.shape[1]]


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` numerics (batch_first, no attention
    dropout): packed ``in_proj_weight`` rows ``[W_q; W_k; W_v]``, scaled
    dot-product attention per head through
    :func:`..kernels.attention.flash_mha` (plain tensor math when both
    lengths are at most 8, the flash kernels above that), ``out_proj``.
    Query, key and value meet in their common dtype, as ``jnp.einsum``
    promotes them."""

    def __init__(self, embed_dim: int, num_heads: int, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, device=device))
        self.out_proj = Linear(embed_dim, embed_dim, device=device)

    def _in_proj(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``in_proj``'s weight and bias."""
        return self.in_proj_weight, self.in_proj_bias

    def forward(self, query, key, value):
        e, nh = self.embed_dim, self.num_heads
        b, tq, _ = query.shape
        tk = key.shape[1]
        w, bias = self._in_proj()
        w_q, w_k, w_v = w.chunk(3)
        b_q, b_k, b_v = bias.chunk(3)
        q, k, v = linear(query, w_q, b_q), linear(key, w_k, b_k), linear(value, w_v, b_v)
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        q = q.to(dt).reshape(b, tq, nh, e // nh).transpose(1, 2)
        k = k.to(dt).reshape(b, tk, nh, e // nh).transpose(1, 2)
        v = v.to(dt).reshape(b, tk, nh, e // nh).transpose(1, 2)
        out = flash_mha(q, k, v).transpose(1, 2).reshape(b, tq, e)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """``nn.TransformerEncoderLayer`` numerics: post-norm, ReLU feed-forward.
    x -> MHA -> dropout -> +x -> norm1 -> linear1 -> relu -> dropout ->
    linear2 -> dropout -> +x -> norm2 (the JAX layer's three sites)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        p, train = self.dropout, self.training
        x = self.norm1(x + dropout(self.self_attn(x, x, x), p, train, generator))
        return self.norm2(x + dropout(self._feed_forward(x, generator), p, train, generator))

    def _feed_forward(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        return self.linear2(dropout(F.relu(self.linear1(x)), self.dropout, self.training,
                                    generator))


class TransformerEncoder(nn.Module):
    """Stack of encoder layers (``nn.TransformerEncoder``'s ``layers.{i}``)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, dropout: float = 0.1, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, device=device)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, generator)
        return x


# --------------------------------------------------------------------------
# tensor-parallel forms
# --------------------------------------------------------------------------


def _split(module: nn.Module, name: str) -> int | None:
    return module.tp_split.get(name)


class ShardedLinear(Linear):
    """A :class:`Linear` whose weight may be split over the model axis:
    column-parallel (split dim 0, output features; the bias split with
    it), row-parallel (split dim 1, input features) or whole.

    ``forward(x)`` takes a whole (replicated) ``x`` and returns the whole
    output: a column-parallel layer gathers its output blocks; a
    row-parallel one takes its block of ``x`` and sums the ranks' partial
    products, then adds the whole bias. ``local_out`` keeps a
    column-parallel output as this rank's block (Megatron's pair, a
    sharded BatchNorm), ``local_in`` gives a row-parallel layer this
    rank's block of the input."""

    @property
    def column(self) -> bool:
        return _split(self, "weight") == 0

    def forward(self, x: torch.Tensor, local_in: bool = False,
                local_out: bool = False) -> torch.Tensor:
        tp = self.tp
        if _split(self, "weight") == 1:
            xl = x if local_in else tp.block(x, -1)
            y = tp.reduce(linear(xl, self.weight))
            return y + tp.whole(self, "bias").to(y.dtype)
        if local_in:
            raise ValueError("local_in needs a row-parallel weight")
        if self.column:  # JAX's rules split the bias with the output features
            y = linear(tp.copy(x), self.weight, self.bias)
            return y if local_out else tp.gather(y, -1)
        return super().forward(x)


class ShardedLayerNorm(LayerNorm):
    """A :class:`LayerNorm` over whole rows, its scale and bias gathered
    where they are split (the JAX layout splits ``eeg_net.fusion_ln``'s
    bias alone)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.tp.whole(self, "weight"), self.tp.whole(self, "bias")
        dt = torch.promote_types(x.dtype, w.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape, w.to(dt), b.to(dt), self.eps)


class ShardedMultiheadAttention(MultiheadAttention):
    """:class:`MultiheadAttention` with ``in_proj`` split on its rows (JAX's
    ``P('model', None)``: contiguous row blocks of ``[W_q; W_k; W_v]``, not
    aligned to heads or to q, k and v). The weight and bias are gathered
    whole, so q, k and v are projected and attended as in one process; the
    gather's backward keeps this rank's rows of their gradients.
    ``out_proj`` (a :class:`ShardedLinear`, row-parallel) sums the ranks'
    partial products."""

    def _in_proj(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.tp.whole(self, "in_proj_weight"), self.tp.whole(self, "in_proj_bias")


class ShardedTransformerEncoderLayer(TransformerEncoderLayer):
    """:class:`TransformerEncoderLayer` with Megatron's feed-forward pair:
    ``linear1`` column-parallel, its ReLU and dropout on this rank's hidden
    block, ``linear2`` row-parallel, one sum over the model axis."""

    def _feed_forward(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.linear1.column:
            return super()._feed_forward(x, generator)
        tp = self.tp
        ff = dropout(F.relu(self.linear1(x, local_out=True)), self.dropout, self.training,
                     generator, shard=(tp.index, tp.size))
        return self.linear2(ff, local_in=True)

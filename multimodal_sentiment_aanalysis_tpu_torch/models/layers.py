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
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout: ``x * keep / (1 - p)`` with ``keep ~ Bernoulli(1 - p)``
    from ``generator``; identity in eval mode or at ``p == 0``."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= p
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

    def forward(self, query, key, value):
        e, nh = self.embed_dim, self.num_heads
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        b, tq, _ = query.shape
        tk = key.shape[1]
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
        ff = dropout(F.relu(self.linear1(x)), p, train, generator)
        return self.norm2(x + dropout(self.linear2(ff), p, train, generator))


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

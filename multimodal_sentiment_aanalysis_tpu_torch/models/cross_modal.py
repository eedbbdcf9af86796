"""Gated cross-modal attention block.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/models/cross_modal.py``:
MHA over length-1 query/key/value, then a sigmoid gate over
``[query | attn_out]`` forming ``g * q + (1 - g) * attn``, then LayerNorm.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import LayerNorm, Linear, MultiheadAttention


class CrossModalTransformer(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 4, device=None):
        super().__init__()
        self.multihead_attn = MultiheadAttention(embed_dim, num_heads, device=device)
        self.gate = nn.Sequential(Linear(2 * embed_dim, embed_dim, device=device),
                                  nn.Sigmoid())
        self.norm = LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        # (B, E) inputs, as the reference passes them, become length-1 sequences
        q, k, v = (t[:, None, :] if t.dim() == 2 else t for t in (query, key, value))
        attn = self.multihead_attn(q, k, v)[:, 0]
        q2 = q[:, 0]
        g = self.gate(torch.cat([q2, attn], dim=1))
        return self.norm(g * q2 + (1.0 - g) * attn)

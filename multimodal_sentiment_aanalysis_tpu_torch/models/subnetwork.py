"""Eye/PPS transformer subnetwork.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/models/subnetwork.py``:
linear projection to ``feat_dim``, a length-1 sequence, sin/cos PE
(``max_len=100``), a 2-layer post-norm encoder (4 heads, feed-forward
``3 * feat_dim``, dropout 0.3 in train mode), final LayerNorm, back to
``(B, feat_dim)``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import LayerNorm, Linear, PositionalEncoding, TransformerEncoder


class Subnetwork(nn.Module):
    def __init__(self, input_dim: int, feat_dim: int = 256, num_layers: int = 2,
                 nhead: int = 4, dropout: float = 0.3, device=None):
        super().__init__()
        self.proj = Linear(input_dim, feat_dim, device=device)
        self.pos_encoder = PositionalEncoding(feat_dim, max_len=100, device=device)
        self.transformer = TransformerEncoder(num_layers, feat_dim, nhead,
                                              3 * feat_dim, dropout, device=device)
        self.norm = LayerNorm(feat_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.pos_encoder(self.proj(x)[:, None, :])  # (B, 1, F)
        return self.norm(self.transformer(h, generator)[:, 0])

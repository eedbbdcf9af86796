"""SimCLR-variant modules.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/models/simclr.py``;
only :class:`ProjectionHead` so far, which ME-MHACL shares (the SimCLR
encoders, fusion and classifier wait for the SimCLR slice, ROADMAP A9).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .fusion_model import init_parameters, run_trunk


class ProjectionHead(nn.Module):
    """SimCLR projection MLP (reference ``MultimodalModel.py:409-429``):
    ``net`` = Linear -> ReLU -> BN -> Dropout -> Linear -> ReLU -> BN ->
    Dropout -> Linear, so the reference's ``net.0/2/4/6/8`` names. BN keeps
    the JAX running-stat rule and dropout draws from the ``generator`` passed
    to :meth:`forward`."""

    def __init__(self, in_dim: int = 256, hidden_dim: int = 256, out_dim: int = 128,
                 dropout: float = 0.5, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(in_dim, hidden_dim, device=device), nn.ReLU(),
            nn.BatchNorm1d(hidden_dim, device=device), nn.Dropout(dropout),
            nn.Linear(hidden_dim, out_dim, device=device), nn.ReLU(),
            nn.BatchNorm1d(out_dim, device=device), nn.Dropout(dropout),
            nn.Linear(out_dim, out_dim, device=device),
        )
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return run_trunk(self.net, x, generator)

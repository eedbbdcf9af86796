"""SimCLR-variant modules.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/models/simclr.py``
(reference ``MultimodalModel.py:325-451``), with the reference's
``state_dict`` names:

- :class:`EyeMLPNet`, :class:`PPSMLPNet`: ``net`` = Linear -> ReLU -> BN ->
  Linear -> ReLU -> BN (``net.0/2/3/5``), BN after the activation;
- :class:`MultiModalEncoder`: ``eeg_net`` (the flagship's
  :class:`.eeg.EEGMultiScaleNet`, whose stem runs the stem-tail kernel and
  whose BiLSTM the BiLSTM kernels), ``eye_net`` and ``pps_net``; each output
  L2-normalised, the three stacked as a length-3 sequence, 8-head
  ``multihead_attn`` self-attention (length 3: the plain path, never a flash
  kernel), the **max** over the modality axis, then ``fusion_mlp`` = Linear
  -> ReLU -> BN;
- :class:`ProjectionHead`: Linear -> ReLU -> BN -> Dropout -> Linear -> ReLU
  -> BN -> Dropout -> Linear (``net.0/2/4/6/8``);
- :class:`Classifier`: ``shared`` = Linear -> ReLU -> Dropout, then 3-way
  ``fc_arousal`` and ``fc_valence``.

Every BatchNorm keeps the JAX running-stat rule (:func:`.fusion_model.run_trunk`)
and every dropout draws from the ``generator`` passed to ``forward``. Each
module draws its weights from the ``generator`` given to its constructor
(:func:`.fusion_model.init_parameters`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .eeg import EEGMultiScaleNet
from .fusion_model import init_parameters, run_trunk
from .layers import MultiheadAttention


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    """``x / max(||x||, 1e-12)`` over the last axis."""
    return F.normalize(x, dim=-1, eps=1e-12)


class _ReluBNMLP(nn.Module):
    """``net`` = [Linear, ReLU, BatchNorm1d] per width (BN after the
    activation), run by :func:`.fusion_model.run_trunk`."""

    def __init__(self, in_dim: int, widths: tuple[int, ...], *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        mods: list[nn.Module] = []
        for w in widths:
            mods += [nn.Linear(in_dim, w, device=device), nn.ReLU(),
                     nn.BatchNorm1d(w, device=device)]
            in_dim = w
        self.net = nn.Sequential(*mods)
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_trunk(self.net, x, None)


class EyeMLPNet(_ReluBNMLP):
    """Eye-feature encoder ``(B, input_dim)`` -> ``(B, feat_dim)``."""

    def __init__(self, input_dim: int = 38, feat_dim: int = 256, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(input_dim, (128, feat_dim), device=device, generator=generator)


class PPSMLPNet(_ReluBNMLP):
    """Peripheral-signal encoder ``(B, input_dim)`` -> ``(B, feat_dim)``."""

    def __init__(self, input_dim: int = 230, feat_dim: int = 256, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(input_dim, (128, feat_dim), device=device, generator=generator)


class MultiModalEncoder(nn.Module):
    """``eeg (B, eeg_channels, eeg_time)``, ``eye (B, eye_dim)``, ``pps (B,
    pps_dim)`` -> the fused ``(B, feat_dim)``. ``dropout`` is the EEG stem's
    rate, the encoder's only dropout."""

    def __init__(self, feat_dim: int = 256, num_heads: int = 8, eeg_channels: int = 32,
                 eeg_time: int = 585, dropout: float = 0.4, eye_dim: int = 38,
                 pps_dim: int = 230, *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.eeg_net = EEGMultiScaleNet(eeg_channels, eeg_time, feat_dim, dropout, device=device)
        self.eye_net = EyeMLPNet(eye_dim, feat_dim, device=device)
        self.pps_net = PPSMLPNet(pps_dim, feat_dim, device=device)
        self.multihead_attn = MultiheadAttention(feat_dim, num_heads, device=device)
        self.fusion_mlp = nn.Sequential(nn.Linear(feat_dim, feat_dim, device=device), nn.ReLU(),
                                        nn.BatchNorm1d(feat_dim, device=device))
        init_parameters(self, generator)

    def forward(self, eeg: torch.Tensor, eye: torch.Tensor, pps: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feats = torch.stack([_l2norm(self.eeg_net(eeg, generator)), _l2norm(self.eye_net(eye)),
                             _l2norm(self.pps_net(pps))], dim=1)  # (B, 3, F)
        # amax splits the gradient of a tie evenly, as JAX's reduce_max does
        fused = torch.amax(self.multihead_attn(feats, feats, feats), dim=1)
        return run_trunk(self.fusion_mlp, fused, None)


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


class Classifier(nn.Module):
    """Arousal and valence heads on a shared Linear + ReLU + Dropout
    (reference ``MultimodalModel.py:432-451``)."""

    def __init__(self, in_dim: int = 256, hidden_dim: int = 128, num_classes: int = 3,
                 dropout: float = 0.5, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.shared = nn.Sequential(nn.Linear(in_dim, hidden_dim, device=device), nn.ReLU(),
                                    nn.Dropout(dropout))
        self.fc_arousal = nn.Linear(hidden_dim, num_classes, device=device)
        self.fc_valence = nn.Linear(hidden_dim, num_classes, device=device)
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        h = run_trunk(self.shared, x, generator)
        return self.fc_arousal(h), self.fc_valence(h)

"""ME-MHACL model family.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/models/memhacl.py``
(reference ``ME-MHACL/model.py:7-119``), with the reference's ``state_dict``
names:

- :class:`_ConvStack`: ``[Conv1d(k3, pad 1), BatchNorm1d, ReLU]`` per
  width, then ``AdaptiveAvgPool1d(1)``, ``Flatten`` and a ``Linear`` to
  ``feat_dim`` (Sequential indices ``0, 1, 3, 4, ...``, Linear last);
- :class:`MEMHACLEncoder`: ``eeg_encoder`` (32 -> 64 -> 128 channels),
  ``eye_encoder`` and ``phy_encoder`` (the feature vector as a 1-channel
  sequence: 16 -> 32, 16 -> 32 -> 64), ``multihead_attn`` (8 heads) over the
  three embeddings as a length-3 sequence, and the **mean** over them;
- :class:`MEMHACLClassifier`: ``shared`` Linear + ReLU + Dropout, binary
  ``fc_arousal`` and ``fc_valence`` (the SimCLR ``Classifier`` with two
  classes);
- ``ProjectionHead``: the SimCLR one (:mod:`.simclr`).

Every BatchNorm uses the JAX running-stat rule (momentum 0.1, biased batch
variance) in train mode; convolutions stay cuDNN. Dropout draws from the
``generator`` passed to ``forward``. :meth:`MEMHACLEncoder.embed` gives the
three modality embeddings, which the fused head
(:func:`..kernels.fusion_head.fused_mha_fusion_head`) consumes in place of
:meth:`MEMHACLEncoder.fuse` and the classifier.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .fusion_model import init_parameters, run_trunk
from .layers import MultiheadAttention
from .simclr import Classifier, ProjectionHead

__all__ = ["MEMHACLClassifier", "MEMHACLEncoder", "ProjectionHead"]


class _ConvStack(nn.Sequential):
    """``(B, C_in, T)`` -> ``(B, feat_dim)``."""

    def __init__(self, in_channels: int, channels: tuple[int, ...], feat_dim: int, device=None):
        mods: list[nn.Module] = []
        for ch in channels:
            mods += [nn.Conv1d(in_channels, ch, 3, padding=1, device=device),
                     nn.BatchNorm1d(ch, device=device), nn.ReLU()]
            in_channels = ch
        mods += [nn.AdaptiveAvgPool1d(1), nn.Flatten(),
                 nn.Linear(in_channels, feat_dim, device=device)]
        super().__init__(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_trunk(self, x, None)


class MEMHACLEncoder(nn.Module):
    """``eeg (B, 32, T)``, ``eye (B, 38)``, ``phy (B, 230)`` (or ``(B, 1,
    ·)``) -> the fused ``(B, feat_dim)`` representation."""

    def __init__(self, feat_dim: int = 256, num_heads: int = 8, eeg_channels: int = 32, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.eeg_encoder = _ConvStack(eeg_channels, (64, 128), feat_dim, device)
        self.eye_encoder = _ConvStack(1, (16, 32), feat_dim, device)
        self.phy_encoder = _ConvStack(1, (16, 32, 64), feat_dim, device)
        self.multihead_attn = MultiheadAttention(feat_dim, num_heads, device=device)
        init_parameters(self, generator)

    def embed(self, eeg: torch.Tensor, eye: torch.Tensor,
              phy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The three modality embeddings, each ``(B, feat_dim)``."""
        if eye.dim() == 2:
            eye = eye[:, None, :]
        if phy.dim() == 2:
            phy = phy[:, None, :]
        return self.eeg_encoder(eeg), self.eye_encoder(eye), self.phy_encoder(phy)

    def fuse(self, x_eeg: torch.Tensor, x_eye: torch.Tensor, x_phy: torch.Tensor) -> torch.Tensor:
        """Self-attention over the length-3 modality axis, then the mean."""
        feats = torch.stack([x_eeg, x_eye, x_phy], dim=1)  # (B, 3, F)
        return self.multihead_attn(feats, feats, feats).mean(dim=1)

    def forward(self, eeg: torch.Tensor, eye: torch.Tensor, phy: torch.Tensor) -> torch.Tensor:
        return self.fuse(*self.embed(eeg, eye, phy))


class MEMHACLClassifier(Classifier):
    """Binary arousal and valence heads on a shared Linear + ReLU + Dropout:
    the SimCLR :class:`.simclr.Classifier` with two classes."""

    def __init__(self, in_dim: int = 256, hidden_dim: int = 128, num_classes: int = 2,
                 dropout: float = 0.5, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(in_dim, hidden_dim, num_classes, dropout, device=device,
                         generator=generator)

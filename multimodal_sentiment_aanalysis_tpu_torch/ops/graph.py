"""Electrode-graph construction for GCN-style models.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/ops/graph.py`` (the
reference's ``common/process_graph.py:25-181``, dormant GCN infrastructure
kept for parity): distance weights ``min(1, delta / d^2)`` from 3-D
electrode positions with hemisphere-symmetric pairs shifted by -1, the
symmetric normalization ``D^-1/2 A D^-1/2``, and a ``.npz`` cache. As in
JAX, the batch of graphs is one dense ``(ch, ch)`` matrix broadcast over
the batch (an ``expand``, no copy), not the reference's block-diagonal
sparse matrix.

The weights are numpy on the host (copies of the JAX package's); the
normalized adjacency is a tensor under the device and dtype rules of
:mod:`.dsp` (fp32, as the JAX package computes it with x64 off). The cache
keeps the JAX file name and key (``adj_norm_{ch}.npz``, ``adj``), so a cache
either package writes loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .dsp import as_signal

# hemisphere-symmetric electrode pairs whose weight is shifted by -1
# (reference ``processing_weights``, ``common/process_graph.py:63-96``)
SYMMETRIC_PAIRS: dict[int, list[list[int]]] = {
    62: [
        [0, 2], [3, 4], [6, 12], [15, 21], [24, 30], [33, 39], [42, 48],
        [51, 55], [58, 60],
        [2, 0], [4, 3], [12, 6], [21, 15], [30, 24], [39, 33], [48, 42],
        [55, 51], [60, 58],
    ],
    32: [
        [0, 16], [1, 17], [4, 21], [8, 26], [13, 31],
        [16, 0], [17, 1], [21, 4], [26, 8], [31, 13],
    ],
}
DEFAULT_PAIRS = [[0, 30], [4, 26], [9, 20], [14, 16]]


def synthetic_electrode_positions(ch_nums: int = 32, seed: int = 0) -> np.ndarray:
    """Plausible (ch, 3) electrode coordinates on a unit sphere cap, for use
    when the reference's ``channels_pos_{ch}.xlsx`` is not available."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, ch_nums)
    phi = rng.uniform(0, np.pi / 2, ch_nums)
    r = 9.0  # ~cm, so /10 lands in the reference's coordinate scale
    return np.stack(
        [r * np.sin(phi) * np.cos(theta), r * np.sin(phi) * np.sin(theta),
         r * np.cos(phi)], axis=1)


def load_electrode_positions(path: str) -> np.ndarray:
    """Read (ch, 3) positions from the reference's xlsx layout (columns
    1:4 of each row; reference ``processing_weights``, ``:102-104``)."""
    import pandas as pd

    pos = pd.read_excel(path)
    return pos.iloc[:, 1:4].to_numpy(dtype=np.float64)


def distance_weights(positions: np.ndarray, delta: float = 5.0,
                     symmetric_pairs: list[list[int]] | None = None) -> np.ndarray:
    """Dense (ch, ch) distance weights, on the host in float64.

    Reference semantics (``processing_weights``, ``:106-116``): coordinates
    are divided by 10; ``w = min(1, delta / ||xi - xj||^2)``; self-links get
    1; hemisphere-symmetric pairs get ``w - 1`` (a negative link).
    """
    ch = positions.shape[0]
    if symmetric_pairs is None:
        symmetric_pairs = SYMMETRIC_PAIRS.get(ch, DEFAULT_PAIRS)
    p = np.asarray(positions, np.float64) / 10.0
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    with np.errstate(divide="ignore"):
        w = np.minimum(1.0, delta / np.where(d2 == 0, np.inf, d2))
    w[d2 == 0] = 1.0
    for i, j in symmetric_pairs:
        w[i, j] -= 1.0
    return w


def normalize_adjacency(adj, device="cuda") -> torch.Tensor:
    """Symmetric normalization ``D^-1/2 A D^-1/2`` (reference
    ``normalization``, ``:164-181``; no self-loops are added: the ``A + I``
    line is commented out there, and self-links already carry weight 1 from
    :func:`distance_weights`)."""
    adj = as_signal(adj, device)
    d_inv_sqrt = adj.sum(dim=-1).pow(-0.5)
    return adj * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]


def graph_indicator(batch_size: int, ch_nums: int) -> np.ndarray:
    """Node->graph id vector (reference ``createGraphStructer``, ``:144-150``)."""
    return np.repeat(np.arange(batch_size, dtype=np.int64), ch_nums)


def create_graph_structure(ch_nums: int = 32, positions: np.ndarray | None = None,
                           cache_dir: str | None = None, delta: float = 5.0,
                           device="cuda") -> torch.Tensor:
    """Normalized dense (ch, ch) adjacency on ``device``, cached as
    ``cache_dir/adj_norm_{ch}.npz`` (key ``adj``) where a directory is
    given: a cached file is loaded as it is, whatever ``positions``."""
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = os.path.join(cache_dir, f"adj_norm_{ch_nums}.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path) as cached:
                return torch.as_tensor(cached["adj"], device=device)
    if positions is None:
        positions = synthetic_electrode_positions(ch_nums)
    adj = normalize_adjacency(distance_weights(positions, delta), device=device)
    if cache_path is not None:
        np.savez(cache_path, adj=adj.cpu().numpy())
    return adj


def initialize_graph(batch_size: int, ch_nums: int = 32, positions: np.ndarray | None = None,
                     cache_dir: str | None = None, device="cuda"):
    """Parity wrapper for reference ``initialize_graph`` (``:25-31``):
    ``(adjacency expanded to (batch, ch, ch), int64 graph indicator)``."""
    adj = create_graph_structure(ch_nums, positions, cache_dir, device=device)
    indicator = torch.as_tensor(graph_indicator(batch_size, ch_nums), device=adj.device)
    return adj.expand(batch_size, ch_nums, ch_nums), indicator

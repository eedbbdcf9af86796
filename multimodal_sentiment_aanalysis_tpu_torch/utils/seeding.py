"""Seeding (JAX ``utils/seeding.py``, reference ``common/utils.py:97-100``).

One integer seed fans out to a ``torch.Generator`` on the device (dropout
draws) and a numpy ``Generator`` (host-side shuffles and pair sampling).
"""

from __future__ import annotations

import numpy as np
import torch


def seed_all(seed: int = 42, device: torch.device | str = "cpu"
             ) -> tuple[torch.Generator, np.random.Generator]:
    """``(torch.Generator on device, numpy Generator)``, both from ``seed``;
    also seeds numpy's legacy global stream, as the JAX function does."""
    np.random.seed(seed)
    return (torch.Generator(device=torch.device(device)).manual_seed(seed),
            np.random.default_rng(seed))

"""Traversal helpers — port of ``repro.algorithms.traverse``, cut to
``seeds_to_frontier``. The BFS and k-hop word loops wait (ROADMAP item
7)."""
from __future__ import annotations

import numpy as np
import torch


def seeds_to_frontier(seeds, n: int, device="cuda") -> torch.Tensor:
    """(F,) seed vertex ids -> one-hot (n, F) float32 frontier on
    ``device``."""
    seeds = torch.as_tensor(np.asarray(seeds, dtype=np.int64)).to(device)
    out = torch.zeros((n, len(seeds)), dtype=torch.float32, device=device)
    out[seeds, torch.arange(len(seeds), device=device)] = 1.0
    return out

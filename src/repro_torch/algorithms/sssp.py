"""Single-source shortest paths = Bellman-Ford over the min_plus semiring.
Port of ``repro.algorithms.sssp``.

Zero-weight edges are carried by every storage kind: ELL stores them
mask-true, and BSR keeps a per-entry structural mask (``emask``) where
explicit 0.0 values occur, so the tropical product relaxes through them
instead of reading them as the +inf identity. On BSR each relaxation is
one ``bsr_mxm`` launch in its bcast min_plus mode, pulling along in-edges
through the handle's stored transpose. The JAX ``while_loop`` is a host
loop here: the "anything changed" flag is read once a round.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import grb, semiring as S


def sssp(A, seeds, max_iter: int = 0, rel=None) -> torch.Tensor:
    """dist (n, F) float32: tropical distance from each seed column (+inf
    where unreached), after at most ``max_iter`` rounds (0: n - 1)."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    dev = A.store.device
    seeds = torch.as_tensor(np.asarray(seeds, dtype=np.int64)).to(dev)
    f = seeds.shape[0]
    dist = torch.full((n, f), torch.inf, dtype=torch.float32, device=dev)
    dist[seeds, torch.arange(f, device=dev)] = 0.0
    iters = max_iter or n - 1
    t, changed = 0, True
    while t < iters and changed:
        relaxed = grb.mxm(A, dist, S.MIN_PLUS, grb.TRANSPOSE_A)
        new = torch.minimum(dist, relaxed)
        changed = bool((new < dist).any())
        t, dist = t + 1, new
    return dist

"""PageRank by plus_times pulls with the dangling-mass correction. Port of
``repro.algorithms.pagerank``.

The out-degree is one plus_times ``mxm`` against a column of ones; each of
the ``iters`` rounds pulls the pushed ranks along in-edges with a width-1
``grb.mxv`` through the handle's stored transpose (on BSR the ``bsr_mxm``
kernel at F = 1) and spreads the dangling vertices' rank evenly.
"""
from __future__ import annotations

import torch

from repro_torch.core import grb, semiring as S


def pagerank(A, alpha: float = 0.85, iters: int = 50,
             rel=None) -> torch.Tensor:
    """Ranks (n,) float32 on the graph's device, summing to 1."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    dev = A.store.device
    ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
    deg = grb.mxm(A, ones, S.PLUS_TIMES)[:, 0]                 # out-degree
    dangling = deg == 0
    inv_deg = torch.where(dangling, 0.0, 1.0 / torch.clamp(deg, min=1e-30))
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        push = r * inv_deg
        pulled = grb.mxv(A, push, S.PLUS_TIMES, grb.TRANSPOSE_A)
        dmass = torch.where(dangling, r, 0.0).sum() / n
        r = (1.0 - alpha) / n + alpha * (pulled + dmass)
    return r

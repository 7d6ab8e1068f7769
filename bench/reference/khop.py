"""k-hop neighbourhood sizes: for a start vertex s, the number of distinct
vertices at breadth-first distance 1 to k from s along out-edges (s itself,
at distance 0, is not counted), as the TigerGraph / RedisGraph k-hop
benchmark counts them.

All starts advance together: one sparse product a hop over a 0/1 frontier
matrix with a column per start.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from bench.reference.precision import exact


def khop_counts(A: sp.csr_matrix, starts: np.ndarray, hops: int,
                block: int = 256, rounding=exact) -> np.ndarray:
    """int64 count per start; ``A`` is the 0/1 adjacency, row = source.
    Starts are taken ``block`` columns at a time. ``rounding`` is applied
    to the counts (``precision.bfloat16`` for the control)."""
    n = A.shape[0]
    At = A.T.tocsr()
    starts = np.asarray(starts, np.int64)
    out = np.zeros(len(starts), np.int64)
    for j0 in range(0, len(starts), block):
        cols = starts[j0:j0 + block]
        f = len(cols)
        visited = np.zeros((n, f), bool)
        visited[cols, np.arange(f)] = True
        frontier = visited.astype(np.float32)
        reached = np.zeros(f, np.int64)
        for _ in range(hops):
            nxt = (At @ frontier) > 0
            nxt &= ~visited
            visited |= nxt
            reached += nxt.sum(axis=0)
            frontier = nxt.astype(np.float32)
        out[j0:j0 + f] = reached
    return np.asarray(rounding(out), np.float64).astype(np.int64)

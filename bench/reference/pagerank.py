"""PageRank by power iteration in float64: ranks start at 1/n, and each
iteration r' = (1 - alpha) / n + alpha * (A^T (r / outdeg) + d / n), where d
is the rank held by vertices without out-edges (spread over all vertices)."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def pagerank(A: sp.csr_matrix, alpha: float, iters: int,
             rounding=None) -> np.ndarray:
    """Ranks (n,) from the 0/1 adjacency ``A`` (row = source), in float64.
    With ``rounding`` (``precision.bfloat16`` for the control) the
    iteration runs in float32 and every vector it makes is rounded by it."""
    n = A.shape[0]
    deg = np.asarray(A.sum(axis=1)).ravel()
    dangling = deg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.maximum(deg, 1.0))
    At = A.T.tocsr()
    if rounding is None:
        dtype, rounding = np.float64, np.asarray
    else:
        dtype = np.float32
        inv, At = rounding(inv), At.astype(np.float32)
    r = np.full(n, 1.0 / n, dtype=dtype)
    for _ in range(iters):
        d = r[dangling].sum(dtype=dtype) / n
        pulled = rounding((At @ rounding(r * inv)).astype(dtype))
        r = rounding(((1.0 - alpha) / n + alpha * (pulled + d)).astype(dtype))
    return np.asarray(r, np.float64)

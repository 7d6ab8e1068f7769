"""Triangle count of an undirected simple graph (HPEC Graph Challenge): the
number of vertex triples that are pairwise adjacent, self-loops ignored.

With A the symmetric 0/1 adjacency (diagonal dropped), the support of edge
(i, j), the common neighbours of i and j, is entry (i, j) of A .* (A @ A);
every triangle is counted once at each of its six directed edges. The
product runs in blocks of rows so that it fits.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from bench.reference.precision import exact


def triangle_count(A: sp.csr_matrix, rows: int = 2048,
                   rounding=exact) -> int:
    """Exact count from the symmetric 0/1 adjacency ``A``. ``rounding`` is
    applied to each edge's support before the sum (``precision.bfloat16``
    for the control)."""
    A = A.astype(np.int64).tolil()
    A.setdiag(0)
    A = A.tocsr()
    A.eliminate_zeros()
    A.data[:] = 1
    total = 0
    for i0 in range(0, A.shape[0], rows):
        Ai = A[i0:i0 + rows]
        support = (Ai @ A).multiply(Ai).tocsr()
        total += int(np.asarray(rounding(support.data), np.float64).sum())
    return total // 6 if rounding is exact else total / 6

"""The work a cell's queries need, counted from the benchmark's own CSR of
the edges and not from the program's layout (an ELL's padding, a tile's
zeros), so the count stays the same whatever implements the query. Each
function returns ``(bytes, float32 operations)``; ``peaks.bound_s`` turns
them into the least time the card could take."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

WORD_BITS = 32


def khop_sweeps(A: sp.csr_matrix, starts, sweeps, hops: int):
    """k-hop sweeps over the 0/1 adjacency ``A`` (row = source): query j
    starts at ``starts[j]`` and is answered in sweep ``sweeps[j]``. A hop of
    a sweep reads the 4-byte id of each out-edge of the vertices in its
    frontier (those first reached at the hop before, in any of the sweep's
    columns) once, and reads and writes the sweep's ``n x columns / 32``
    visited words once."""
    n = A.shape[0]
    q = len(starts)
    if q == 0:
        return 0.0, 0.0
    deg = np.diff(A.indptr).astype(np.float64)
    At = A.T.tocsr()
    col = np.arange(q)
    _, sid = np.unique(np.asarray(sweeps), return_inverse=True)
    member = sp.csr_matrix((np.ones(q), (col, sid)),
                           shape=(q, sid.max() + 1))
    frontier = sp.csr_matrix((np.ones(q), (np.asarray(starts), col)),
                             shape=(n, q))
    visited = frontier.copy()
    edges = 0.0
    for h in range(hops):
        union = (frontier @ member).tocsr()
        union.data[:] = 1.0
        edges += float(deg @ union.sum(axis=1).A1)
        if h + 1 < hops:
            nxt = (At @ frontier).tocsr()
            nxt.data[:] = 1.0
            nxt = (nxt - nxt.multiply(visited)).tocsr()
            nxt.eliminate_zeros()
            visited = visited + nxt
            frontier = nxt
    words = n * q / WORD_BITS
    return 4 * edges + hops * 2 * 4 * words, 0.0


def triangles(n: int, nnz: int, count: int):
    """One masked ``C<A> = A (x) A`` over plus_pair and its sum: the CSR
    (4-byte ids and row pointers) read once for each of A, A and the mask;
    one add a closed wedge, six a triangle."""
    return 3 * (4 * nnz + 4 * (n + 1)), 6.0 * count


def pagerank(n: int, nnz: int, iters: int):
    """``iters`` pull iterations: the CSR ids and row pointers and the rank
    vector read once, the new vector written once, and a multiply and an
    add a stored edge."""
    return iters * (4 * nnz + 4 * (n + 1) + 2 * 4 * n), iters * 2.0 * nnz

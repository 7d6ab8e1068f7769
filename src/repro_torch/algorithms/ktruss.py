"""k-truss — the Graphulo formulation on the masked SpGEMM. Port of
``repro.algorithms.ktruss``.

The k-truss of an undirected graph is the maximal subgraph in which every
edge closes at least k-2 triangles. One peeling round is two sparse
primitives:

  support<A> = A (x)_plus_pair A     masked SpGEMM: common-neighbour counts
                                     on A's stored edges only
  A'         = select(support >= k-2)

iterated to a fixpoint (the pattern only shrinks). On BSR every step stays
sparse: the support comes out of ``bsr_spgemm`` with <A> pruning output
tiles, and the select (``bsr_ewise`` on the card) prunes emptied tiles.
ELL handles are reblocked to BSR through their entry list first, and a
delta handle takes its materialization. A dense handle runs the same
rounds on dense tensors (the JAX package's dense pipeline).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import grb, semiring as S
from repro_torch.core.bsr import BSR, as_bsr
from repro_torch.core.grb import Descriptor, GBMatrix


def ktruss(A, k: int, rel: Optional[str] = None,
           max_iter: Optional[int] = None) -> GBMatrix:
    """Edges of the k-truss, values = each surviving edge's final triangle
    support (common-neighbour count within the truss).

    A: Graph / Relation / GBMatrix / raw storage of a symmetric adjacency,
    BSR, ELL, delta or dense. Self-loops are dropped first (they would add
    diagonal walk terms to the support). k <= 2 returns the input
    unchanged.
    """
    A = grb.matrix(A, rel)
    n, m = A.shape
    if n != m:
        raise ValueError(f"ktruss needs a square adjacency, got {A.shape}")
    if k <= 2:
        return A
    if A.fmt == "delta":
        A = GBMatrix(A.store.materialize())
    if A.fmt == "ell":          # sparse-to-sparse reblock, no densification
        A = GBMatrix(as_bsr(A.store, 128))
    if A.fmt == "bsr":
        r, c, v = A.store.to_coo()
        loops = r == c
        if loops.any():
            A = GBMatrix(BSR.from_coo(r[~loops], c[~loops], v[~loops],
                                      A.shape, block=A.store.block,
                                      device=A.store.device))
    elif A.fmt == "dense":
        D = A.store.to(torch.float32)
        A = GBMatrix(D * (1.0 - torch.eye(n, dtype=torch.float32,
                                          device=D.device)))
    else:
        raise TypeError(f"ktruss takes BSR, ELL, delta or dense storage, "
                        f"got {A.fmt}")
    keep = S.ewise("ge", k - 2)
    rounds = 0
    while True:
        # plus_pair counts common neighbours; the mask <A> restricts both
        # the symbolic schedule and the element pattern to current edges
        C = GBMatrix.wrap(grb.mxm(A, A, S.PLUS_PAIR, Descriptor(mask=A)))
        T = GBMatrix.wrap(grb.select(keep, C))
        rounds += 1
        if T.nvals == A.nvals or T.nvals == 0:
            return T
        if max_iter is not None and rounds >= max_iter:
            return T
        A = T

"""Triangle counting — C<A> = A (x)_plus_pair A, sum(C) / 6 (the
GraphChallenge kernel). Port of ``repro.algorithms.triangles``.

Requires a symmetric (undirected) adjacency. On BSR both operands stay
sparse: ``grb.mxm`` takes its route rule (``grb.dot_route_ok``), the
masked dot SpGEMM on sparse tiles (``bsr_spgemm_dot`` on the card: one
count per entry of the mask <A>, from A's rows and its stored transpose's
rows, no tile made) or the two-phase tile SpGEMM (``bsr_spgemm``) with <A>
pruning output tiles; then ``grb.reduce`` sums the stored counts (the dot
route's as entries). ELL handles reblock to BSR through their entry
list first (the JAX package multiplies them densely; the count is the
same), a delta handle takes its materialization, and a dense handle runs
the dense product. BitELL and ShardedBitELL handles skip the semiring:
the masked plus_pair product is a neighbourhood intersection, word-AND +
SWAR popcount over tile pairs (``core.bitadj.triangle_count``, on the
sharded panels assembled on the mesh's first device).

The sum passes 2^24 on Graph500 R-MAT from scale 14, where a float32
accumulation is not exact; both routes count exactly (float64 / int64).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitadj as _bitadj
from repro_torch.core import grb, semiring as S
from repro_torch.core.bsr import as_bsr
from repro_torch.core.grb import Descriptor, GBMatrix


def triangle_count(A, rel=None) -> torch.Tensor:
    """The number of triangles, a 0-d int64 tensor on the graph's
    device."""
    A = grb.matrix(A, rel)
    if A.fmt == "delta":
        A = GBMatrix(A.store.materialize())
    if A.fmt in ("bitadj", "bitshard"):
        total = _bitadj.triangle_count(A.store)
    else:
        if A.fmt == "ell":
            A = GBMatrix(as_bsr(A.store, 128))
        C = grb.mxm(A, A, S.PLUS_PAIR, Descriptor(mask=A))
        total = grb.reduce(C, S.PLUS, dtype=torch.float64) / 6.0
    return total.to(torch.int64)     # truncates, as the JAX int32 cast

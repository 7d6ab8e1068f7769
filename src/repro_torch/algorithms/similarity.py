"""Neighbourhood similarity (Jaccard / cosine / overlap) on the semiring.
Port of ``repro.algorithms.similarity``.

Every variant normalizes one common-neighbour count, a plus_pair product:

  jaccard(u, v)  = |N(u) & N(v)| / |N(u) | N(v)|
  cosine(u, v)   = |N(u) & N(v)| / sqrt(deg(u) * deg(v))
  overlap(u, v)  = |N(u) & N(v)| / min(deg(u), deg(v))

  similarity(A, sources, kind)   dense (n, F) scores of every vertex
      against F sources: the source neighbourhoods as an or_and frontier,
      the plus_pair counts, a plus_pair degree product, then element-wise
      normalization.
  similarity_matrix(A, kind)     sparse scores on a candidate pattern
      (default: the adjacency). Masked plus_pair SpGEMM for the counts,
      then a sparse ``ewise_mult`` (``bsr_ewise`` on the card) with the
      reciprocal denominators assembled on the same stored pattern.
      Symmetric adjacency only (it reuses A for A^T).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.traverse import seeds_to_frontier
from repro_torch.core import grb, semiring as S
from repro_torch.core.bsr import BSR, as_bsr
from repro_torch.core.grb import Descriptor, GBMatrix

KINDS = ("jaccard", "cosine", "overlap")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown similarity kind {kind!r} "
                         f"(one of {', '.join(KINDS)})")


def _normalize(kind: str, M, deg_rows, deg_cols):
    """Scores from counts M and the two degree vectors; entries with no
    common neighbour are 0 under every kind."""
    _check_kind(kind)
    if kind == "jaccard":
        denom = deg_rows + deg_cols - M
    elif kind == "cosine":
        # in float64, rounded once: torch's float32 sqrt on the CPU is not
        # correctly rounded, XLA's and the card's are
        denom = torch.sqrt((deg_rows * deg_cols).double()).float()
    else:
        denom = torch.minimum(deg_rows, deg_cols)
    # denom >= 1 wherever M > 0; the inner where keeps M == 0 from 0 / 0
    return torch.where(M > 0, M / torch.where(M > 0, denom, 1.0), 0.0)


def degrees(A, rel=None) -> torch.Tensor:
    """(n,) stored-entry out-degrees, one plus_pair mxm against ones."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    ones = torch.ones((n, 1), dtype=torch.float32, device=A.store.device)
    return grb.mxm(A, ones, S.PLUS_PAIR)[:, 0]


def similarity(A, sources, kind: str = "jaccard", rel=None) -> torch.Tensor:
    """(n, F) scores: column j compares every vertex's out-neighbourhood
    with that of ``sources[j]``. 0 where two share no neighbour; a vertex
    with edges scores 1 against itself."""
    _check_kind(kind)
    A = grb.matrix(A, rel)
    n = A.shape[0]
    dev = A.store.device
    sources = np.asarray(sources, dtype=np.int64)
    f = len(sources)
    if f == 0 or A.nvals == 0:
        return torch.zeros((n, f), dtype=torch.float32, device=dev)
    E = seeds_to_frontier(sources, n, device=dev)
    # NB[w, j] = 1 iff (sources[j], w) is a stored edge (A^T, or_and)
    NB = grb.mxm(A, E, S.OR_AND, Descriptor(transpose_a=True))
    # M[v, j] = |N(v) & N(sources[j])|
    M = grb.mxm(A, NB, S.PLUS_PAIR)
    deg = degrees(A)
    return _normalize(kind, M, deg[:, None],
                      deg[torch.from_numpy(sources).to(dev)][None, :])


def similarity_matrix(A, kind: str = "jaccard", rel=None,
                      mask=None) -> GBMatrix:
    """Sparse all-pairs similarity on the ``mask`` pattern (default: A's
    own edges): C<mask> = A (x)_plus_pair A, then a sparse ``ewise_mult``
    with the reciprocal denominators, assembled once on C's stored pattern
    from its host entry list. ELL and BitELL handles are reblocked to BSR
    through their entry lists (a ShardedBitELL gathered first, counted),
    a delta handle takes its materialization;
    a dense handle runs the dense pipeline and returns a dense handle."""
    _check_kind(kind)
    A = grb.matrix(A, rel)
    n, m = A.shape
    if n != m:
        raise ValueError(f"similarity_matrix needs a square adjacency, "
                         f"got {A.shape}")
    if A.fmt == "delta":
        A = GBMatrix(A.store.materialize())
    if A.fmt in ("bitadj", "bitshard"):
        A = GBMatrix(A.store.to_ell())
    if A.fmt == "ell":
        A = GBMatrix(as_bsr(A.store, 128))
    if A.fmt == "dense":
        # the dense pipeline: a dense count product, normalized whole
        deg = degrees(A)
        C = grb.mxm(A, A, S.PLUS_PAIR,
                    Descriptor(mask=mask if mask is not None else A))
        return GBMatrix(_normalize(kind, C, deg[:, None], deg[None, :]))
    deg = degrees(A).cpu().numpy()
    C = grb.mxm(A, A, S.PLUS_PAIR,
                Descriptor(mask=mask if mask is not None else A))
    r, c, v = C.store.to_coo()
    if kind == "jaccard":
        denom = deg[r] + deg[c] - v
    elif kind == "cosine":
        denom = np.sqrt(deg[r] * deg[c])
    else:
        denom = np.minimum(deg[r], deg[c])
    recip = BSR.from_coo(r, c, (1.0 / np.maximum(denom, 1.0)).astype(
        np.float32), C.shape, block=C.store.block, device=C.store.device)
    return grb.ewise_mult(C, GBMatrix(recip), S.ewise("times"))

"""BFS / k-hop over the boolean semiring — port of
``repro.algorithms.traverse``.

``MATCH (a)-[:R*1..k]->(b) WHERE id(a)=seed RETURN count(DISTINCT b)``
lowers to ``khop_counts``: k masked or_and hops with a complemented visited
mask, batched over seeds in the frontier's F dimension (one column, one
query). Every entry point takes the graph's adjacency (a Graph, Relation,
GBMatrix or raw storage) and pulls along out-edges through the handle's
stored transpose (``transpose_a``).

The JAX package runs each hop loop as a ``jax.lax.while_loop``; here it is
a host loop whose condition (hops left, frontier not empty) is read once a
hop. The hop counter stays a float32 ``t``, so levels are stamped as the
JAX package stamps them. Frontiers that ``grb.words_route_ok`` admits
(ELL at a width the packing policy packs, BitELL always) stay packed in
``core.bitmap`` words across hops: one pack in, word-wise visited blends
per hop through ``grb.mxm_words`` (the ``ell_mxv_packed`` /
``bitadj_mxv_packed`` kernels on the card), one unpack out; the level stamp
is the only per-hop unpack, on the device. BSR keeps the 0/1 float loop,
one masked ``grb.mxm`` a hop (``bsr_mxm``, the <!visited> mask in its
epilogue).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitmap, grb, semiring as S
from repro_torch.core.grb import Descriptor


def seeds_to_frontier(seeds, n: int, device="cuda") -> torch.Tensor:
    """(F,) seed vertex ids -> one-hot (n, F) float32 frontier on
    ``device``."""
    seeds = torch.as_tensor(np.asarray(seeds, dtype=np.int64)).to(device)
    out = torch.zeros((n, len(seeds)), dtype=torch.float32, device=device)
    out[seeds, torch.arange(len(seeds), device=device)] = 1.0
    return out


def _unreached(frontier: torch.Tensor) -> torch.Tensor:
    """Level 0 at the seeds, +inf elsewhere."""
    return torch.where(frontier > 0, 0.0, torch.inf).to(torch.float32)


def bfs_step(A, frontier: torch.Tensor, visited: torch.Tensor) -> torch.Tensor:
    """next<!visited> = A^T (x)_or_and frontier — one traversal hop."""
    d = Descriptor(mask=visited, complement=True, transpose_a=True)
    return grb.mxm(A, frontier, S.OR_AND, d)


def _bfs_levels_words(A, frontier: torch.Tensor, iters: int) -> torch.Tensor:
    """Word-resident BFS: the frontier and visited set stay packed across
    hops; the only per-hop unpack is the level stamp."""
    f = frontier.shape[1]
    fw = bitmap.pack(frontier)
    vw = fw
    levels = _unreached(frontier)
    t = 0.0
    while t < iters and bool((fw != 0).any()):
        nw = bitmap.word_andnot(grb.mxm_words(A, fw, transpose_a=True), vw)
        levels = torch.where(bitmap.unpack(nw, f) > 0, t + 1.0, levels)
        t, fw, vw = t + 1.0, nw, bitmap.word_or(vw, nw)
    return levels


def bfs_levels(A, seeds, max_iter: int = 0, rel=None) -> torch.Tensor:
    """Levels (n, F): hop distance from each seed column; +inf if
    unreached."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    iters = max_iter or n
    frontier = seeds_to_frontier(seeds, n, device=A.store.device)
    if A.nvals == 0:
        # zero-edge adjacency: the frontier empties after hop 0
        return _unreached(frontier)
    if grb.words_route_ok(A, frontier.shape[1]):
        return _bfs_levels_words(A, frontier, iters)
    levels = _unreached(frontier)
    t = 0.0
    while t < iters and bool((frontier > 0).any()):
        visited = torch.isfinite(levels).to(torch.float32)
        frontier = bfs_step(A, frontier, visited)
        levels = torch.where(frontier > 0, t + 1.0, levels)
        t += 1.0
    return levels


def _reach_words(A, fw: torch.Tensor, iters: int,
                 both_directions: bool = False) -> torch.Tensor:
    """Visited words after up to ``iters`` or_and hops from the packed
    frontier ``fw``: the word-resident reachability loop k-hop and WCC
    share, with no unpack anywhere."""
    vw = fw
    t = 0
    while t < iters and bool((fw != 0).any()):
        nw = grb.mxm_words(A, fw, transpose_a=True)
        if both_directions:
            # (a & ~v) | (b & ~v) == (a | b) & ~v: one visited blend serves
            # both edge directions
            nw = bitmap.word_or(nw, grb.mxm_words(A, fw))
        fw = bitmap.word_andnot(nw, vw)
        vw = bitmap.word_or(vw, fw)
        t += 1
    return vw


def khop_counts(A, seeds, k: int, rel=None) -> torch.Tensor:
    """TigerGraph k-hop benchmark semantics: |{v : 1 <= dist(seed, v) <= k}|,
    (F,) int32."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    frontier = seeds_to_frontier(seeds, n, device=A.store.device)
    f = frontier.shape[1]
    if A.nvals == 0:
        # zero-edge adjacency: nothing is within 1..k of anything
        return torch.zeros((f,), dtype=torch.int32, device=frontier.device)
    if grb.words_route_ok(A, f):
        # reached-within-k minus the seed itself: levels never stamp a seed
        # above 0, so the seed column contributes exactly its own bit
        fw = bitmap.pack(frontier)
        vw = _reach_words(A, fw, k)
        counts = (bitmap.reduce_or_columns(vw, f)
                  - bitmap.reduce_or_columns(fw, f))
        return counts.to(torch.int32)
    levels = bfs_levels(A, seeds, max_iter=k, rel=rel)
    inrange = (levels >= 1.0) & (levels <= float(k))
    return inrange.to(torch.int32).sum(dim=0, dtype=torch.int32)

"""Betweenness and closeness centrality — batched multi-source Brandes.
Port of ``repro.algorithms.centrality``.

Brandes' algorithm splits betweenness into a forward BFS that counts
shortest paths (sigma) and a backward sweep that accumulates dependencies
(delta) down the BFS DAG. Both phases are one semiring mxm per hop over a
multi-source frontier matrix, so column j of every (n, F) carry belongs to
source j:

  levels  or_and BFS (``traverse.bfs_levels``), word-resident where
          ``grb.words_route_ok`` admits the packed route
  sigma   plus_times hops masked to ``levels == t+1``: path counts only
          accumulate along BFS-DAG edges
  delta   the Brandes recurrence pulled backward one level at a time:
          delta[v] += sigma[v] * sum_w A[v,w] (1 + delta[w]) / sigma[w]
          for w exactly one level below v

Every step is an mxm or an element-wise op on device tensors; the JAX
``while_loop`` conditions (frontier not empty, levels left) are read on
the host once a hop. On BSR each product is one ``bsr_mxm`` launch
(plus_times, F = the batch). Edge values are read as unit (path counts):
hand in a 0/1 adjacency. Closeness uses the Wasserman-Faust formula, so a
disconnected graph scores each source over its reachable set.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.traverse import bfs_levels, seeds_to_frontier
from repro_torch.core import grb, semiring as S

# Sources per batched Brandes sweep (and the closeness BFS batch): the JAX
# package's value, measured there on its XLA-CPU host; it matches the WCC
# closure batch.
AUTO_CENTRALITY_BATCH = 128


def brandes_parts(A, seeds, rel=None) -> torch.Tensor:
    """(n, F) per-source Brandes dependency columns: entry [v, j] is the
    dependency of source ``seeds[j]`` on vertex v (its own row zeroed).
    Summing columns gives betweenness over that source set."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    dev = A.store.device
    seeds = np.asarray(seeds, dtype=np.int64)
    f = len(seeds)
    if f == 0 or A.nvals == 0:
        # zero-edge adjacency: no vertex sits on any path
        return torch.zeros((n, f), dtype=torch.float32, device=dev)
    levels = bfs_levels(A, seeds)
    sigma = frontier = seeds_to_frontier(seeds, n, device=dev)
    t = 0.0
    while t < n and bool((frontier > 0).any()):
        nxt = grb.mxm(A, frontier, S.PLUS_TIMES, grb.TRANSPOSE_A)
        frontier = torch.where(levels == t + 1.0, nxt, 0.0)
        sigma = sigma + frontier
        t += 1.0

    finite = torch.isfinite(levels)
    d = float(torch.where(finite, levels, 0.0).max())
    delta = torch.zeros((n, f), dtype=torch.float32, device=dev)
    while d > 0.5:
        # sigma > 0 wherever levels is finite; the maximum only guards
        # unreached rows the where already zeroes
        coef = torch.where(levels == d,
                           (1.0 + delta) / torch.clamp(sigma, min=1.0), 0.0)
        pulled = grb.mxm(A, coef, S.PLUS_TIMES)
        delta = delta + torch.where(levels == d - 1.0, sigma * pulled, 0.0)
        d -= 1.0
    return torch.where(levels > 0.0, delta, 0.0)


def betweenness(A, sources=None, rel=None,
                batch: int = AUTO_CENTRALITY_BATCH) -> torch.Tensor:
    """Betweenness centrality (n,) float32 over shortest paths from
    ``sources`` (default: every vertex, exact directed betweenness); a
    subset gives source-sampled betweenness."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    if sources is None:
        sources = np.arange(n)
    sources = np.asarray(sources, dtype=np.int64)
    bc = torch.zeros((n,), dtype=torch.float32, device=A.store.device)
    if len(sources) == 0 or A.nvals == 0:
        return bc
    for c0 in range(0, len(sources), batch):
        bc = bc + brandes_parts(A, sources[c0:c0 + batch]).sum(dim=1)
    return bc


def closeness_from_levels(levels: torch.Tensor) -> torch.Tensor:
    """(F,) Wasserman-Faust closeness per BFS-level column:
    ((r-1)/(n-1)) * ((r-1)/sum_of_distances) with r the reachable count
    (the source included at distance 0); 0.0 when nothing is reachable.
    float32 arithmetic over integer counts and level sums, as the JAX
    package's."""
    n = levels.shape[0]
    finite = torch.isfinite(levels)
    r = finite.to(torch.float32).sum(dim=0)
    tot = torch.where(finite, levels, 0.0).sum(dim=0)
    denom = float(max(n - 1, 1)) * torch.where(tot > 0.0, tot, 1.0)
    # (r - 1) ** 2 as one rounded product, as XLA's integer_pow
    return torch.where(tot > 0.0, (r - 1.0) * (r - 1.0) / denom, 0.0)


def closeness(A, sources=None, rel=None,
              batch: int = AUTO_CENTRALITY_BATCH) -> torch.Tensor:
    """Closeness centrality (F,) float32 of each source vertex, over
    outgoing BFS distances (default sources: every vertex)."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    dev = A.store.device
    if sources is None:
        sources = np.arange(n)
    sources = np.asarray(sources, dtype=np.int64)
    if len(sources) == 0 or A.nvals == 0:
        return torch.zeros((len(sources),), dtype=torch.float32, device=dev)
    outs = [closeness_from_levels(bfs_levels(A, sources[c0:c0 + batch]))
            for c0 in range(0, len(sources), batch)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)

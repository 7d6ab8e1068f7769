"""Weakly-connected components on boolean frontiers (min-seed labels).
Port of ``repro.algorithms.wcc``.

The labels stay on the host; all graph work is or_and reachability
closures, the same packed mxm BFS and k-hop use:

  1. take the ``batch`` smallest unlabeled vertex ids as seed columns,
  2. run an undirected closure (both directions a hop, complemented
     visited mask) to its fixpoint: each column is its seed's whole weak
     component,
  3. label every member of a column with the column's minimum member id.

A closure column holds the whole component, so its minimum member is the
component's minimum id whichever seeds were taken: the labels equal
min-label propagation's. Isolated vertices (no stored entry in their row
or column, from two stored-entry ``or`` reductions) are labelled up front.
ELL and BitELL closures run word-resident (``ell_mxv_packed`` /
``bitadj_mxv_packed`` on the card, both directions a hop); BSR takes the
float loop, two masked ``bsr_mxm`` launches a hop.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.traverse import _reach_words, seeds_to_frontier
from repro_torch.core import bitmap, grb, semiring as S
from repro_torch.core.grb import Descriptor


def _closure(A: grb.GBMatrix, seeds, max_iter: int) -> torch.Tensor:
    """(n, F) 0/1 closure: column j is everything weakly reachable from
    seeds[j], the seed included."""
    n = A.shape[0]
    iters = max_iter or n
    frontier = seeds_to_frontier(seeds, n, device=A.store.device)
    if grb.words_route_ok(A, frontier.shape[1]):
        vw = _reach_words(A, bitmap.pack(frontier), iters,
                          both_directions=True)
        return bitmap.unpack(vw, frontier.shape[1])
    fr = visited = frontier
    t = 0
    while t < iters and bool((fr > 0).any()):
        d = Descriptor(mask=visited, complement=True)
        fr = torch.maximum(
            grb.mxm(A, fr, S.OR_AND, d.with_(transpose_a=True)),
            grb.mxm(A, fr, S.OR_AND, d))
        visited = torch.maximum(visited, fr)
        t += 1
    return visited


def wcc(A, max_iter: int = 0, rel=None, batch: int = 128) -> torch.Tensor:
    """Component labels (n,) int32 on the graph's device: each vertex gets
    the minimum vertex id of its weak component. ``batch`` seeds traverse
    a closure; ``max_iter`` bounds its hops (0: n)."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    dev = A.store.device
    if A.nvals == 0:
        # zero-edge adjacency: every vertex is its own component
        return torch.arange(n, dtype=torch.int32, device=dev)
    labels = np.full(n, -1, dtype=np.int64)
    if A.fmt == "dense":
        D = A.store != 0
        iso = (~(D.any(dim=1) | D.any(dim=0))).cpu().numpy()
    else:
        # "or" over stored entries: any entry in the row or the column
        iso = ((grb.reduce(A, S.OR, axis=1) == 0)
               & (grb.reduce(A, S.OR, axis=0) == 0)).cpu().numpy()
    labels[iso] = np.nonzero(iso)[0]
    while True:
        unlabeled = np.nonzero(labels < 0)[0]
        if len(unlabeled) == 0:
            break
        reach = (_closure(A, unlabeled[:batch], max_iter) > 0).cpu().numpy()
        for j in range(reach.shape[1]):
            members = reach[:, j]
            labels[members] = int(np.flatnonzero(members)[0])
    return torch.from_numpy(labels.astype(np.int32)).to(dev)

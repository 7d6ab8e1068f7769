"""Reference interpreter for the Cypher subset — the differential oracle for
the algebraic executor (same BFS distinct-vertex semantics).

Port of ``repro.query.reference``. It reads each relation's stored
structure once (``to_coo`` of the forward handle, or of its stored
transpose for IN) into numpy CSR arrays and runs a level-synchronous BFS
per seed; no semiring, no bitmap words and no kernel is involved. The JAX
package's version densifies the adjacency, which the slice's graphs
(65,536 and 262,144 vertices) cannot afford, so this one reads COO.

``Reference(graph)`` keeps the CSR arrays for many queries;
``execute_ref(graph, query)`` answers one.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.graph.graph import Graph
from repro_torch.query import qast as A
from repro_torch.query.executor import ExecutionContext, Result, _colname, _prop
from repro_torch.query.parser import parse
from repro_torch.query.planner import plan


def _csr(rows: np.ndarray, cols: np.ndarray, n: int):
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return indptr, cols[order]


def _neighbors(csr, frontier: np.ndarray) -> np.ndarray:
    """All neighbor ids of the frontier vertices (with repeats)."""
    indptr, idx = csr
    starts, ends = indptr[frontier], indptr[frontier + 1]
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offs = np.repeat(starts - np.cumsum(lens) + lens, lens)
    return idx[offs + np.arange(total)]


def _bfs_range(csrs, seeds, minh: int, maxh: int, allowed_dst, n: int) -> set:
    """Vertices first reached at a level in [minh, maxh] from the seed set
    (BFS levels: a vertex counts once, at its shortest distance)."""
    visited = np.zeros(n, dtype=bool)
    frontier = np.asarray(sorted(seeds), dtype=np.int64)
    visited[frontier] = True
    reach = np.zeros(n, dtype=bool)
    for h in range(1, maxh + 1):
        if frontier.size == 0:
            break
        nbr = np.concatenate([_neighbors(c, frontier) for c in csrs])
        frontier = np.unique(nbr[~visited[nbr]])
        visited[frontier] = True
        if h >= minh:
            reach[frontier] = True
    return set(int(v) for v in np.nonzero(reach & allowed_dst)[0])


class Reference:
    """The oracle over one graph, keeping each (relation, direction)'s CSR
    arrays for the queries that follow."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self._csr: Dict[tuple, tuple] = {}

    def _adj(self, rel, direction) -> list:
        r = self.graph.relation(rel)
        dirs = {A.OUT: ("out",), A.IN: ("in",), A.BOTH: ("out", "in")}
        out = []
        for d in dirs[direction]:
            key = (r.name, d)
            if key not in self._csr:
                rr, cc, vv = (r.A if d == "out" else r.A_T).store.to_coo()
                keep = vv != 0          # stored-iff-nonzero, like to_dense
                self._csr[key] = _csr(rr[keep], cc[keep], self.graph.n)
            out.append(self._csr[key])
        return out

    def execute(self, query) -> Result:
        graph = self.graph
        q = parse(query) if isinstance(query, str) else query
        p = plan(q)
        if p.semiring != "or_and":
            raise NotImplementedError(
                "reference covers distinct semantics only")

        ctx = ExecutionContext(graph)
        src_mask = ctx.node_mask(p.src_label, p.var_preds.get(p.src_var))
        if p.seeds is not None:
            seeds = [s for s in sorted(set(p.seeds)) if src_mask[s]]
        else:
            seeds = list(np.nonzero(src_mask)[0])

        per_seed: List[set] = []
        for s in seeds:
            cur = {int(s)}
            for e in p.expands:
                dst_mask = ctx.node_mask(e.dst_label,
                                         p.var_preds.get(e.dst_var))
                cur = _bfs_range(self._adj(e.rel, e.direction), cur,
                                 e.min_hops, e.max_hops, dst_mask, graph.n)
            per_seed.append(cur)

        cols = [_colname(r) for r in p.returns]
        src_var = p.src_var
        returns_src = any(r.var == src_var and r.kind != "count"
                          for r in p.returns)
        only_counts = all(r.kind == "count" for r in p.returns)

        rows = []
        if only_counts and not returns_src:
            total = sum(len(c) for c in per_seed)
            rows = [tuple(total for _ in p.returns)]
        elif only_counts or (returns_src
                             and all(r.kind == "count" or r.var == src_var
                                     for r in p.returns)):
            for j, s in enumerate(seeds):
                vals = []
                for r in p.returns:
                    if r.kind == "count":
                        vals.append(len(per_seed[j]))
                    elif r.kind == "prop":
                        vals.append(_prop(graph, r.prop, int(s)))
                    else:
                        vals.append(int(s))
                rows.append(tuple(vals))
        else:
            for j, s in enumerate(seeds):
                for d in sorted(per_seed[j]):
                    vals = []
                    for r in p.returns:
                        node = int(s) if r.var == src_var else int(d)
                        if r.kind == "prop":
                            vals.append(_prop(graph, r.prop, node))
                        else:
                            vals.append(node)
                    rows.append(tuple(vals))
            rows.sort()
        if p.limit is not None:
            rows = rows[: p.limit]
        return Result(cols, rows)


def execute_ref(graph: Graph, query) -> Result:
    return Reference(graph).execute(query)

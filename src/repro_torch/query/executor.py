"""Physical execution: plans -> GraphBLAS ops on the graph's matrices.

Port of ``repro.query.executor``, the MATCH half. The binding state is a
frontier matrix B (n, F): column j is the reachable set (or walk counts)
of source binding j. Each Expand is min..max masked semiring hops through
``core.grb``; node predicates become diagonal masks applied between hops.
Structural (or_and) expands whose relation passes ``grb.words_route_ok``
run the word-resident hop loop: pack once, ``grb.mxm_words`` per hop with
word-wise visited blends, unpack once. BSR relations take the float hop
loop, one masked ``grb.mxm`` (the ``bsr_mxm`` kernel, with the <!visited>
mask in its epilogue) per hop, or, for a structural ``*1..k`` from hop 1
in one direction on at most ``SPGEMM_EXPAND_MAX_N`` vertices, one masked
``grb.mxm`` against the hop matrix OR_{h=1..k} M^h, built once per
context with SpGEMM (the ``bsr_spgemm`` kernel). On a CUDA graph each hop
is one hand-written kernel launch.

``ExecutionContext`` is the execution surface the server composes
(``node_mask``, ``seed_frontier``, ``expand``, ``traverse``, ``project``);
``execute()`` is the solo driver over the same context and
``resolve_seeds`` the one seed semantics both share. A context reads one
frozen Graph: CREATE / DELETE raise TypeError, unknown relations raise
ValueError. ``CALL algo.*`` is not ported yet and raises
NotImplementedError. ``project`` materializes rows on the host; the
``.cpu()`` there is where the host waits for the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import bitmap as _bitmap, grb, semiring as S
from repro_torch.core.bsr import bsr_union, spgemm
from repro_torch.core.grb import Descriptor
from repro_torch.graph.graph import Graph
from repro_torch.query import qast as A
from repro_torch.query.parser import parse
from repro_torch.query.planner import CallPlan, Plan, plan

_CALL_NOT_PORTED = "CALL algo.* is not ported yet"


@dataclasses.dataclass
class Result:
    columns: List[str]
    rows: List[tuple]
    # serving error isolation: a query that failed inside a batch reports
    # here ("ValueError: no relation ...") instead of poisoning its batch
    error: Optional[str] = None

    def scalar(self):
        if len(self.rows) != 1 or len(self.rows[0]) != 1:
            raise ValueError(f"not a scalar result: {self.rows!r}")
        return self.rows[0][0]


def empty_result(p: Plan) -> Result:
    """The no-seeds-survived answer: zero rows, not a zero-count row."""
    return Result([_colname(r) for r in p.returns], [])


def resolve_seeds(p: Plan, src_mask: np.ndarray) -> np.ndarray:
    """Seed ids a seeded plan starts from. or_and binds each seed vertex
    once (sorted, deduped); plus_times keeps the seed multiset in written
    order. Seeds failing the source label/predicate mask drop out."""
    if p.semiring == "or_and":
        seeds = np.asarray(sorted(set(p.seeds)), dtype=np.int64)
    else:
        seeds = np.asarray(list(p.seeds), dtype=np.int64)
    n = len(src_mask)
    if seeds.size and (seeds.min() < 0 or seeds.max() >= n):
        raise ValueError(f"seed id out of range 0..{n - 1}: "
                         f"{[int(s) for s in seeds if s < 0 or s >= n]}")
    return seeds[src_mask[seeds]]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# -- predicate evaluation -----------------------------------------------------
def _operand_vec(graph: Graph, side, n: int):
    if side[0] == "lit":
        return np.full(n, side[1], dtype=np.float64), None
    if side[0] == "id":
        return np.arange(n, dtype=np.float64), None
    if side[0] == "prop":
        col = graph.node_props.get(side[2])
        if col is None:
            return np.full(n, np.nan), np.zeros(n, dtype=bool)
        col = _host(col).astype(np.float64)
        return col, ~np.isnan(col)
    raise TypeError(side)


_CMP = {"<": np.less, "<=": np.less_equal, ">": np.greater,
        ">=": np.greater_equal, "=": np.equal, "<>": np.not_equal}


def eval_pred(graph: Graph, node, n: int) -> np.ndarray:
    if isinstance(node, A.Comparison):
        lv, lp = _operand_vec(graph, node.lhs, n)
        rv, rp = _operand_vec(graph, node.rhs, n)
        with np.errstate(invalid="ignore"):
            out = _CMP[node.op](lv, rv)
        for present in (lp, rp):
            if present is not None:
                out &= present
        return out
    if isinstance(node, A.BoolExpr):
        parts = [eval_pred(graph, a, n) for a in node.args]
        if node.op == "AND":
            return np.logical_and.reduce(parts)
        if node.op == "OR":
            return np.logical_or.reduce(parts)
        if node.op == "NOT":
            return ~parts[0]
    if isinstance(node, A.InSeeds):
        m = np.zeros(n, dtype=bool)
        m[node.seeds] = True
        return m
    raise TypeError(node)


# -- public execution surface -------------------------------------------------
class ExecutionContext:
    """Execution primitives over one frozen Graph.

    node_mask  label + predicate scan -> bool (n,) diagonal
    expand     one variable-length traversal step on a frontier matrix
    traverse   seeds -> final frontier for a plan (launched, not awaited)
    project    frontier matrix -> Result rows per the plan's RETURN clause
    run        parse/plan/execute a full read query (also accepts a Plan)
    """

    # multi-hop SpGEMM fast path is only planned for adjacencies up to this
    # many vertices (hop-matrix fill grows with hop count)
    SPGEMM_EXPAND_MAX_N = 16384

    def __init__(self, graph: Graph, spgemm_expand: bool = True):
        self.graph = graph
        self.spgemm_expand = spgemm_expand
        # (relation, transpose, max_hops) -> hop-matrix handle
        self._hops = {}

    # -- primitives ----------------------------------------------------------
    def matrix(self, rel: Optional[str]) -> grb.GBMatrix:
        """Relation adjacency handle (``None`` is the union relation)."""
        try:
            r = self.graph.relation(rel)
        except KeyError:
            r = None
        if r is None:
            raise ValueError(f"no relation {rel!r} "
                             f"(have: {sorted(self.graph.relations)})")
        return r.A

    def node_mask(self, label, preds=None) -> np.ndarray:
        """bool (n,): vertices carrying `label` and passing all predicates."""
        n = self.graph.n
        m = _host(self.graph.label_mask(label))
        for p in preds or []:
            m = m & eval_pred(self.graph, p, n)
        return m

    def seed_frontier(self, seeds, keep=None) -> torch.Tensor:
        """One-hot (n, F) frontier from seed ids; columns where keep is False
        stay empty (filtered seeds still occupy their result column)."""
        seeds = np.asarray(seeds, dtype=np.int64)
        f = len(seeds)
        if keep is None:
            keep = np.ones(f, dtype=bool)
        dev = self.graph.device
        B = torch.zeros((self.graph.n, f), dtype=torch.float32, device=dev)
        B[torch.from_numpy(np.where(keep, seeds, 0)).to(dev),
          torch.arange(f, device=dev)] = \
            torch.from_numpy(keep.astype(np.float32)).to(dev)
        return B

    def _hop_matrix(self, rel, transpose: bool,
                    max_hops: int) -> grb.GBMatrix:
        """Union of walk matrices OR_{h=1..max} Mt^h over or_and, built once
        per (relation, direction, max_hops) with BSR x BSR SpGEMM and the
        structural union, and cached on the context."""
        key = (rel, transpose, max_hops)
        P = self._hops.get(key)
        if P is None:
            M = self.matrix(rel)
            Mt = (M.T if transpose else M).store
            acc = walk = Mt
            for _ in range(max_hops - 1):
                walk = spgemm(walk, Mt, S.OR_AND)
                acc = bsr_union(acc, walk)
            P = self._hops[key] = grb.GBMatrix(acc,
                                               name=f"{rel}^1..{max_hops}")
        return P

    def _expand_spgemm_ok(self, e, sr: S.Semiring, transposes) -> bool:
        """The hop-matrix rewrite is exact only for structural reachability
        starting at hop 1 in a single direction (walk-union == first-reach
        union once the seed columns are masked back out)."""
        return (self.spgemm_expand and sr.name == "or_and"
                and e.min_hops == 1 and e.max_hops > 1
                and len(transposes) == 1
                and self.matrix(e.rel).fmt == "bsr"
                and self.graph.n <= self.SPGEMM_EXPAND_MAX_N)

    def expand(self, B: torch.Tensor, e, sr: S.Semiring,
               dst_mask: np.ndarray) -> torch.Tensor:
        """min..max-hop traversal of B along e.rel in e.direction."""
        M = self.matrix(e.rel)
        transposes = {A.OUT: (True,), A.IN: (False,),
                      A.BOTH: (True, False)}[e.direction]
        structural = sr.name == "or_and"
        dst = torch.from_numpy(np.asarray(dst_mask, dtype=np.float32)).to(
            B.device)[:, None]
        if self._expand_spgemm_ok(e, sr, transposes):
            # one masked mxm against the precomputed 1..max hop matrix
            # replaces max_hops sequential hops; <!seeds> removes the
            # closed-walk returns the loop's visited mask would have blocked
            P = self._hop_matrix(e.rel, transposes[0], e.max_hops)
            seeds0 = (B > 0).to(torch.float32)
            reach = grb.mxm(P, B, sr, Descriptor(mask=seeds0,
                                                 complement=True))
            return ((reach * dst) > 0).to(torch.float32)
        if structural and grb.words_route_ok(M, B.shape[1]):
            # word-resident hop loop: pack once, hop on words with word-wise
            # visited blends ((a & ~v) | (b & ~v) == (a | b) & ~v), unpack
            # once at the end
            f = B.shape[1]
            fw = _bitmap.pack(B)
            vw = fw
            reach_w = torch.zeros_like(fw)
            for h in range(1, e.max_hops + 1):
                nw = None
                for t in transposes:
                    step = grb.mxm_words(M, fw, transpose_a=t)
                    nw = step if nw is None else _bitmap.word_or(nw, step)
                fw = _bitmap.word_andnot(nw, vw)
                vw = _bitmap.word_or(vw, fw)
                if h >= e.min_hops:
                    reach_w = _bitmap.word_or(reach_w, fw)
            return _bitmap.unpack(reach_w, f) * dst
        reach = torch.zeros_like(B)
        frontier = B
        visited = (B > 0).to(torch.float32)
        for h in range(1, e.max_hops + 1):
            nxt = None
            for t in transposes:
                d = Descriptor(mask=visited if structural else None,
                               complement=True, transpose_a=t)
                step = grb.mxm(M, frontier, sr, d)
                nxt = step if nxt is None else _sr_add(sr, nxt, step)
            frontier = nxt
            if structural:
                visited = torch.maximum(visited,
                                        (frontier > 0).to(torch.float32))
            if h >= e.min_hops:
                reach = _sr_add(sr, reach, frontier)
        # destination label/property diagonal
        reach = reach * dst
        if structural:
            reach = (reach > 0).to(torch.float32)
        return reach

    def traverse(self, p: Plan, seeds, keep=None) -> torch.Tensor:
        """Seeds -> final (n, F) frontier for a plan: the device half of
        `run`, and the batch hook the server composes. Kernels are launched
        asynchronously on a CUDA graph; nothing here waits for them."""
        if isinstance(p, CallPlan):
            raise NotImplementedError(_CALL_NOT_PORTED)
        sr = S.get(p.semiring)
        B = self.seed_frontier(seeds, keep=keep)
        for e in p.expands:
            dst_mask = self.node_mask(e.dst_label, p.var_preds.get(e.dst_var))
            B = self.expand(B, e, sr, dst_mask)
        return B

    def project(self, p: Plan, seeds: np.ndarray, B) -> Result:
        """Materialize RETURN rows from the final frontier matrix (a tensor,
        or its numpy copy)."""
        if isinstance(p, CallPlan):
            raise NotImplementedError(_CALL_NOT_PORTED)
        Bn = _host(B) if isinstance(B, torch.Tensor) else np.asarray(B)
        cols = [_colname(r) for r in p.returns]
        src_var = p.src_var
        graph = self.graph

        returns_src = any(r.var == src_var and r.kind != "count"
                          for r in p.returns)
        only_counts = all(r.kind == "count" for r in p.returns)

        rows: List[tuple] = []
        if only_counts and not returns_src:
            # global aggregate: one row
            vals = []
            for r in p.returns:
                tot = ((Bn > 0).sum()
                       if r.distinct or p.semiring == "or_and" else Bn.sum())
                vals.append(int(tot))
            rows = [tuple(vals)]
        elif only_counts or (returns_src
                             and all(r.kind == "count" or r.var == src_var
                                     for r in p.returns)):
            # grouped by seed
            for j, s in enumerate(seeds):
                vals = []
                for r in p.returns:
                    if r.kind == "count":
                        tot = ((Bn[:, j] > 0).sum()
                               if (r.distinct or p.semiring == "or_and")
                               else Bn[:, j].sum())
                        vals.append(int(tot))
                    elif r.kind == "prop":
                        vals.append(_prop(graph, r.prop, int(s)))
                    else:
                        vals.append(int(s))
                rows.append(tuple(vals))
        else:
            # materialize (seed, dst) bindings
            dst_rows, seed_cols = np.nonzero(Bn > 0)
            for d, j in zip(dst_rows, seed_cols):
                vals = []
                for r in p.returns:
                    node = int(seeds[j]) if r.var == src_var else int(d)
                    if r.kind == "prop":
                        vals.append(_prop(graph, r.prop, node))
                    else:
                        vals.append(node)
                rows.append(tuple(vals))
            rows.sort()
        if p.limit is not None:
            rows = rows[: p.limit]
        return Result(cols, rows)

    # -- solo driver ---------------------------------------------------------
    def run(self, query) -> Result:
        """Execute a read query: text, MatchQuery AST, or an already-built
        Plan (the server's cached-plan path — no re-parse)."""
        if isinstance(query, (Plan, CallPlan)):
            p = query
        else:
            q = parse(query) if isinstance(query, str) else query
            if isinstance(q, (A.CreateQuery, A.DeleteQuery)):
                kw = "CREATE" if isinstance(q, A.CreateQuery) else "DELETE"
                raise TypeError(f"{kw} goes through engine.Database, not a "
                                f"read ExecutionContext")
            p = plan(q)
        if isinstance(p, CallPlan):
            raise NotImplementedError(_CALL_NOT_PORTED)

        src_mask = self.node_mask(p.src_label, p.var_preds.get(p.src_var))
        if p.seeds is not None:
            seeds = resolve_seeds(p, src_mask)
        else:
            seeds = np.nonzero(src_mask)[0]
        if len(seeds) == 0:
            return empty_result(p)
        return self.project(p, seeds, self.traverse(p, seeds))


def _sr_add(sr: S.Semiring, a, b):
    return torch.maximum(a, b) if sr.name == "or_and" else a + b


# -- top level ----------------------------------------------------------------
def execute(graph: Graph, query) -> Result:
    return ExecutionContext(graph).run(query)


def _colname(r: A.ReturnItem) -> str:
    if r.alias:
        return r.alias
    if r.kind == "count":
        return f"count({'DISTINCT ' if r.distinct else ''}{r.var})"
    if r.kind == "prop":
        return f"{r.var}.{r.prop}"
    return r.var


def _prop(graph: Graph, prop: str, node: int):
    col = graph.node_props.get(prop)
    if col is None:
        return None
    v = float(col[node])
    return None if np.isnan(v) else v


def explain(graph: Graph, query) -> str:
    q = parse(query) if isinstance(query, str) else query
    return plan(q).explain()

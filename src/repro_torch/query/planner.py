"""Logical planning: MatchQuery AST -> algebraic execution plan.

The plan mirrors RedisGraph's ExecutionPlan: a NodeScan (label diagonal or
seed one-hots) followed by Expand operators (semiring vxm per hop, masked by
label/property diagonals), ending in Project/Aggregate.

Serving additions (the RedisGraph execution-plan cache analog):
`signature(plan)` is the batching-compatibility key — everything about a
plan except WHICH seed ids it starts from, predicate *content* included —
and `PlanCache` memoizes parse+plan per normalized query text so a repeat
shape never re-parses. Both are what `engine.server` schedules with.

Port of ``repro.query.planner``: a verbatim copy (the module is backend-free), kept
in the port so that ``repro_torch`` imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import re
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.query import qast as A


@dataclasses.dataclass
class Expand:
    rel: Optional[str]
    direction: str
    min_hops: int
    max_hops: int
    dst_var: Optional[str]
    dst_label: Optional[str]


@dataclasses.dataclass
class Plan:
    src_var: Optional[str]
    src_label: Optional[str]
    seeds: Optional[List[int]]          # explicit seed ids, else label scan
    var_preds: dict                     # var -> predicate AST list (conjunction)
    expands: List[Expand]
    returns: List[A.ReturnItem]
    limit: Optional[int]
    semiring: str                       # or_and (distinct) | plus_times (walks)

    def explain(self) -> str:
        lines = []
        scan = (f"NodeByIdSeek({self.src_var}, ids={self.seeds})" if self.seeds
                else f"NodeByLabelScan({self.src_var}:{self.src_label or '*'})")
        lines.append(scan)
        for e in self.expands:
            lines.append(
                f"ConditionalTraverse([{e.rel or '*'}] {e.direction} "
                f"*{e.min_hops}..{e.max_hops} -> {e.dst_var}:{e.dst_label or '*'}"
                f") [semiring={self.semiring}]")
        for v, preds in self.var_preds.items():
            if preds:
                lines.append(f"Filter({v}: {len(preds)} predicate(s))")
        lines.append(f"Project({[r.kind + ':' + r.var for r in self.returns]}"
                     f" limit={self.limit})")
        return "\n".join(lines)


# Column names each built-in procedure yields, in canonical order — the ONE
# place the surface is declared. `plan_call` fills an omitted YIELD clause
# from here; `query.executor.PROCEDURES` (the implementations) asserts it
# stays in sync at import.
PROC_COLUMNS = {
    "algo.pagerank":    ("node", "score"),
    "algo.betweenness": ("node", "score"),
    "algo.closeness":   ("node", "score"),
    "algo.similarity":  ("node1", "node2", "score"),
    "algo.wcc":         ("node", "component"),
    "algo.labelprop":   ("node", "community"),
    "algo.triangles":   ("triangles",),
    "algo.bfs":         ("source", "node", "level"),
}


@dataclasses.dataclass
class CallPlan:
    """Execution plan for `CALL algo.*` — the procedure analog of `Plan`.

    Carries the same scheduler surface a MATCH plan does (`seeds`,
    `semiring`, `src_var`/`src_label`/`var_preds`), so `engine.server`
    batches CALL sweeps through the identical admission/launch/finish
    machinery: seeded calls (a `sources:` list) coalesce with every
    signature-equal member into one device sweep whose columns are the
    union of their sources; source-less calls ride alone like label
    scans. `semiring` is pinned to or_and so `executor.resolve_seeds`
    binds each source vertex once (sorted, deduped)."""
    proc: str
    args: dict                          # named args minus `sources`
    seeds: Optional[List[int]]          # the popped `sources` list
    returns: List[A.ReturnItem]         # YIELD items (kind="var")
    limit: Optional[int] = None
    # server-compatibility surface (a CALL has no pattern to scan/filter)
    src_var: Optional[str] = None
    src_label: Optional[str] = None
    var_preds: dict = dataclasses.field(default_factory=dict)
    expands: List[Expand] = dataclasses.field(default_factory=list)
    semiring: str = "or_and"

    def explain(self) -> str:
        src = (f"sources={self.seeds}" if self.seeds is not None
               else "sources=*")
        cols = [r.alias or r.var for r in self.returns]
        return (f"ProcedureCall({self.proc}, {src}, args={self.args})\n"
                f"Project({cols} limit={self.limit})")


def plan_call(q: A.CallQuery) -> CallPlan:
    """CallQuery AST -> CallPlan. `sources:` moves out of the arg dict into
    the plan's seed slot (the batched-over dimension, excluded from the
    signature); an omitted YIELD expands to the procedure's full column
    list. Unknown procedure names plan fine and fail at *execution* — the
    server isolates them as per-query error Results instead of poisoning
    the submitter."""
    args = dict(q.args)
    seeds = args.pop("sources", None)
    if seeds is not None:
        if not isinstance(seeds, (list, tuple)):
            seeds = [seeds]             # `sources: 3` — a single id
        seeds = [int(s) for s in seeds]
    returns = list(q.yields)
    if not returns:
        returns = [A.ReturnItem("var", c)
                   for c in PROC_COLUMNS.get(q.proc, ())]
    return CallPlan(q.proc, args, seeds, returns, q.limit)


def _pred_vars(node) -> set:
    if isinstance(node, A.Comparison):
        out = set()
        for side in (node.lhs, node.rhs):
            if side[0] in ("prop", "id"):
                out.add(side[1])
        return out
    if isinstance(node, A.BoolExpr):
        out = set()
        for a in node.args:
            out |= _pred_vars(a)
        return out
    if isinstance(node, A.InSeeds):
        return {node.var}
    raise TypeError(node)


def plan(q) -> Plan:
    if isinstance(q, A.CallQuery):
        return plan_call(q)
    if not q.nodes:
        raise ValueError("empty pattern")
    src = q.nodes[0]
    var_preds: dict = {n.var: [] for n in q.nodes if n.var}
    seeds = None

    for pred in q.where:
        vars_ = _pred_vars(pred)
        if len(vars_) != 1:
            raise NotImplementedError(
                f"cross-variable predicate over {vars_} not supported")
        v = next(iter(vars_))
        if v not in var_preds:
            raise ValueError(f"unknown variable {v}")
        # seed selectors on the source variable become NodeByIdSeek
        if v == src.var and isinstance(pred, A.InSeeds):
            seeds = (seeds or []) + list(pred.seeds)
        elif (v == src.var and isinstance(pred, A.Comparison)
              and pred.op == "=" and pred.lhs[0] == "id" and pred.rhs[0] == "lit"):
            seeds = (seeds or []) + [int(pred.rhs[1])]
        else:
            var_preds[v].append(pred)

    # distinct-vertex reachability (or_and) unless someone counts walks
    semiring = "or_and"
    for r in q.returns:
        if r.kind == "count" and not r.distinct:
            semiring = "plus_times"

    expands = []
    for i, e in enumerate(q.edges):
        dst = q.nodes[i + 1]
        expands.append(Expand(e.rel, e.direction, e.min_hops, e.max_hops,
                              dst.var, dst.label))
    return Plan(src.var, src.label, seeds, var_preds, expands,
                q.returns, q.limit, semiring)


# -- serving: signatures + the plan cache -------------------------------------
def pred_key(node) -> tuple:
    """Hashable normal form of one predicate AST node."""
    if isinstance(node, A.Comparison):
        return ("cmp", node.op, tuple(node.lhs), tuple(node.rhs))
    if isinstance(node, A.BoolExpr):
        return ("bool", node.op, tuple(pred_key(a) for a in node.args))
    if isinstance(node, A.InSeeds):
        return ("in", node.var, tuple(node.seeds))
    raise TypeError(node)


def signature(p: Plan) -> tuple:
    """Batching-compatibility key: two seeded plans with equal signatures
    answer from ONE shared frontier traversal (their seed columns sit side
    by side in the same matrix sweep). The key covers the full predicate
    content — a predicate-count-only key would let queries with different
    WHERE clauses share one (wrong) node mask — and excludes exactly the
    seed ids, the batched-over dimension. CALL plans key on the procedure
    plus full argument content (seeds excluded, exactly like MATCH): two
    `algo.closeness(sources: ...)` calls with different source lists share
    one sweep; a different `kind:`/`iters:`/YIELD/LIMIT does not."""
    if isinstance(p, CallPlan):
        return ("call", p.proc, tuple(sorted(p.args.items())),
                tuple((r.kind, r.var, r.prop, r.distinct, r.alias)
                      for r in p.returns),
                p.limit)
    return (p.src_var, p.src_label,
            tuple((e.rel, e.direction, e.min_hops, e.max_hops,
                   e.dst_var, e.dst_label) for e in p.expands),
            p.semiring,
            tuple((r.kind, r.var, r.prop, r.distinct, r.alias)
                  for r in p.returns),
            p.limit,
            tuple(sorted((v, tuple(pred_key(q) for q in ps))
                         for v, ps in p.var_preds.items())))


class PlanCache:
    """LRU parse+plan cache keyed by whitespace-normalized query text — the
    RedisGraph execution-plan cache analog. `get` returns a SHARED
    (plan, signature) pair: callers must treat the plan as immutable
    (`engine.server` re-binds seeds via `dataclasses.replace`). Repeat
    query shapes skip tokenize+parse+plan entirely; the parameterized
    submit form (`QueryServer.submit(text, seeds=...)`) keeps the text
    seed-free so every seed binding of one shape is a hit."""

    def __init__(self, maxsize: int = 1024):
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._entries: "OrderedDict[str, Tuple[Plan, tuple]]" = OrderedDict()

    @staticmethod
    def key(text: str) -> str:
        """Whitespace-normal form: runs of whitespace collapse to one
        space, and spaces adjacent to punctuation drop entirely — so
        `CALL algo.pagerank( iters: 20 )` and `CALL algo.pagerank(iters:20)`
        are one cache entry (argument lists vary freely in formatting).
        Word-adjacent tokens keep their separating space, so distinct
        token streams can never normalize together."""
        return re.sub(r"\s*([^\w\s])\s*", r"\1", " ".join(text.split()))

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        seen = self.hits + self.misses
        return self.hits / seen if seen else 0.0

    def get(self, text: str) -> Tuple[Plan, tuple]:
        """(plan, signature) for the query text; parse+plan on first sight.
        Parse/plan errors propagate to the submitter and cache nothing."""
        from repro_torch.query.parser import parse  # deferred: no import cycle
        k = self.key(text)
        entry = self._entries.get(k)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(k)
            return entry
        p = plan(parse(text))
        self.misses += 1
        entry = (p, signature(p))
        self._entries[k] = entry
        if len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return entry

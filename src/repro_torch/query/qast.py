"""AST for the Cypher subset (RedisGraph 1.0-era surface).

Supported:
  MATCH (a:L1)-[:R*1..3]->(b:L2)(...linear chains...)
        directions -> <- and undirected -, variable-length hops [*min..max]
  WHERE conjunctions of single-variable predicates over node properties,
        id(v) = k / id(v) IN [..] seed selectors; OR/NOT within a predicate
  RETURN v | v.prop | count(v) | count(DISTINCT v)  (+ LIMIT)
  CREATE (:Label {id: i, prop: v}) | CREATE (i)-[:R]->(j)
         (node ids optional — engine.MutableGraph auto-assigns next_id)
  DELETE (i)-[:R]->(j) | DELETE (i)   (edge / whole-node forms; node
         deletion tombstones: incident edges, labels and props go, the id
         row stays allocated)
  CALL algo.name(arg: v, sources: [i, j], kind: word) YIELD col AS alias
       (+ LIMIT) — procedure invocation; args are named, values are
       numbers, [number lists] or bare words. YIELD omitted = every
       column the procedure defines (query.planner.PROC_COLUMNS).

Semantics note (DESIGN.md): variable-length expansion uses BFS distinct-vertex
semantics (the TigerGraph k-hop benchmark definition), not Cypher trail
semantics — this is the algebraic traversal the paper implements.

Port of ``repro.query.qast``: a verbatim copy (the module is backend-free), kept
in the port so that ``repro_torch`` imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

OUT, IN, BOTH = "OUT", "IN", "BOTH"


@dataclasses.dataclass
class NodePat:
    var: Optional[str]
    label: Optional[str]
    props: dict


@dataclasses.dataclass
class EdgePat:
    var: Optional[str]
    rel: Optional[str]
    direction: str           # OUT | IN | BOTH
    min_hops: int = 1
    max_hops: int = 1


@dataclasses.dataclass
class Comparison:
    op: str                  # < <= > >= = <>
    lhs: Tuple[str, ...]     # ("prop", var, name) | ("id", var) | ("lit", v)
    rhs: Tuple[str, ...]


@dataclasses.dataclass
class BoolExpr:
    op: str                  # AND | OR | NOT
    args: List[Union["BoolExpr", Comparison]]


@dataclasses.dataclass
class InSeeds:
    var: str
    seeds: List[int]


@dataclasses.dataclass
class ReturnItem:
    kind: str                # var | prop | count
    var: str
    prop: Optional[str] = None
    distinct: bool = False
    alias: Optional[str] = None


@dataclasses.dataclass
class MatchQuery:
    nodes: List[NodePat]
    edges: List[EdgePat]
    where: List[Union[BoolExpr, Comparison, InSeeds]]   # conjunction
    returns: List[ReturnItem]
    limit: Optional[int] = None


@dataclasses.dataclass
class CallQuery:
    proc: str                # dotted procedure name, e.g. "algo.pagerank"
    args: dict               # name -> number | tuple of numbers | str
    yields: List[ReturnItem]   # [] = all of the procedure's columns
    limit: Optional[int] = None


@dataclasses.dataclass
class CreateNode:
    label: Optional[str]
    props: dict              # "id" optional: the engine auto-assigns next_id


@dataclasses.dataclass
class CreateEdge:
    src: int
    rel: str
    dst: int


@dataclasses.dataclass
class CreateQuery:
    items: list


@dataclasses.dataclass
class DeleteNode:
    id: int


@dataclasses.dataclass
class DeleteEdge:
    src: int
    rel: str
    dst: int


@dataclasses.dataclass
class DeleteQuery:
    items: list

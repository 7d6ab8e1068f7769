"""Continuous-batching query server — 32 users per machine word.

Port of ``repro.engine.server``. The JAX package overlaps batch i+1 with
batch i through jax's asynchronous dispatch; here CUDA launches are
asynchronous the same way, and ``traverse`` returns a frontier whose
kernels may still be running. The host waits at one point: the ``.cpu()``
in ``_finish`` that copies a batch's frontier out for ``project``. On a
CPU graph every call completes before it returns and the stats contract
holds all the same. The server serves a frozen ``Graph``, a zero-arg
callable returning one, a ``MutableGraph`` or a ``Database`` (with
``graph=``); the last two are re-frozen per batch, so writes committed
between batches are visible to the next one.

RedisGraph serves reads with a threadpool: W workers, W concurrent queries.
The TPU analog is algebraic, not thread-based: pattern-compatible seeded
queries (equal `query.planner.signature`, different seed ids) coalesce into
ONE frontier traversal whose column dimension F is the threadpool width —
and for structural (or_and) traversals `grb` packs 32 of those boolean
columns into each uint32 word (docs/API.md §Bitmap), so one matrix sweep
answers up to 32 users per machine word.

The serving loop is continuous batching, not stop-the-world flushes:

  submit()   parse+plan through the shared `PlanCache` (repeat shapes skip
             both; the `seeds=` parameterized form keeps the text seed-free
             so every binding of one shape is a cache hit), then enqueue
             with an arrival timestamp.
  pump()     one scheduler tick. Admission control pops ONE batch off the
             queue head — signature-compatible members up to `max_width`
             TOTAL frontier columns (each query contributes its seed count,
             not "1") — pads it to packed-lane alignment, LAUNCHES it, and
             only then materializes/projects the PREVIOUS in-flight batch:
             with asynchronous CUDA launches the host schedules batch i+1
             while the device sweeps batch i.
  flush()    drain: pump until the queue and the pipeline are empty.

Failures are isolated per query: a member whose label / relation / seed ids
do not resolve gets an error `Result` (``result.error`` set) and costs no
other tenant their answer; the queue always drains. A kernel that fails to
build, load or launch (``kernels.KernelError``) fails its whole batch:
every member reports it, and none is answered through another route.

Serving a mutable source: every batch serves the freshest
snapshot-consistent freeze (cached per write epoch upstream, so an
unchanged graph reuses the same context). A callable is called per batch;
a plain frozen `Graph` is served as-is.

Serving over a mesh (``mesh=``, a ``distr.mesh.Mesh``): the context
distributes every relation onto it, so each batch's hops run as mesh
collectives with the word kernels on every shard; a mutable source is
frozen as compacted ELL (the mesh layout has no delta lowering).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import tracing
from repro_torch.core import bsr as _bsr, grb, xfer
from repro_torch.graph.graph import Graph
from repro_torch.kernels import KernelError
from repro_torch.query.executor import (ExecutionContext, Result,
                                        empty_result, resolve_seeds)
from repro_torch.query.planner import Plan, PlanCache

# Serving policy constants (docs/API.md §Serving has the measured table):
# MAX_WIDTH caps a sweep's total frontier columns — admission is by width,
# not query count, so many multi-seed queries can't flatten into an
# unbounded frontier. 512 keeps the s10/s11 sweep under the measured
# latency knee while still filling 16 packed words.
MAX_WIDTH = 512
# Sweep widths round up to whole uint32 words once they'd pack (32 lanes),
# else to AUTO_PACK_MIN_WIDTH: bounded shape churn (at most MAX_WIDTH/32
# distinct widths reach the compiler) and full-word packed sweeps. Padded
# lanes are keep=False columns; stats["pack_ratio"] reports utilization.
LANE_ALIGN = 32


@dataclasses.dataclass
class Submitted:
    """One queued query and, once served, its per-query serving record."""
    qid: int
    plan: Plan
    sig: tuple
    t_submit: float                     # perf_counter clock
    width: int                          # admission width: seed columns asked
    result: Optional[Result] = None
    wait_s: float = 0.0                 # queue wait: submit -> batch launch
    latency_s: float = 0.0              # submit -> result materialized


@dataclasses.dataclass
class _Batch:
    """A launched sweep: in-flight device work + the host state to finish
    it. `error` marks a launch-time failure (finish() isolates it). `bid`
    is the batch id, the request id of its spans (``repro_torch.tracing``).
    """
    bid: int
    members: List[Submitted]            # live members, column-sliced in order
    failed: List[Submitted]             # per-member launch failures (result set)
    ctx: ExecutionContext
    seed_lists: List[np.ndarray]
    B: Optional[object]                 # (n, F) device frontier, or None
    error: Optional[Exception]
    solo: bool                          # unseeded singleton (stats bucket)


def _error_result(e: Exception) -> Result:
    return Result(columns=[], rows=[], error=f"{type(e).__name__}: {e}")


def _aligned(width: int) -> int:
    a = LANE_ALIGN if width >= LANE_ALIGN else grb.AUTO_PACK_MIN_WIDTH
    return -(-width // a) * a


class QueryServer:
    """Continuous-batching scheduler over `ExecutionContext`.

    source     Graph (static) | MutableGraph | Database (+ graph=name) |
               zero-arg callable -> Graph. Non-Graph sources are re-frozen
               (or called) per batch.
    max_width  admission cap: total frontier columns per sweep.
    max_batch  secondary cap on member count per sweep.
    align      pad sweep widths to packed-lane alignment (LANE_ALIGN).
    mesh       serve over this mesh (``distr.mesh.Mesh``), or None.
    """

    def __init__(self, source, max_batch: int = 512,
                 max_width: int = MAX_WIDTH, align: bool = True,
                 graph: Optional[str] = None, mesh=None):
        self._source = source
        self._graph_name = graph
        self.mesh = mesh
        self.max_batch = max_batch
        self.max_width = max_width
        self.align = align
        self._plans = PlanCache()
        self._queue: List[Submitted] = []
        self._inflight: Optional[_Batch] = None
        self._ctx: Optional[ExecutionContext] = None
        self._next_id = 0
        self._bids = itertools.count()      # batch ids, the spans' rid
        self.log: List[Submitted] = []      # completed queries, in order
        self.stats = {
            "queries": 0, "batches": 0, "solo": 0, "errors": 0,
            "batched_width_total": 0, "batch_width_max": 0,
            "plan_cache_hits": 0, "plan_cache_misses": 0,
            "plan_cache_hit_rate": 0.0,
            "pack_lanes": 0, "pack_slots": 0, "pack_ratio": 1.0,
            "queue_wait_s_total": 0.0,
            # device->host gathers attributable to serving (grb.host_transfers
            # delta since server construction); the batched or_and sweep
            # promises this stays 0 — tests/test_transfers.py pins it
            "host_transfers": 0,
            # copies between host and card and their bytes (core.xfer),
            # SpGEMM plan tasks (core.bsr.plan_tasks) and the plans' copies
            # through core.xfer (core.bsr.plan_host_copies), deltas likewise
            "d2h_bytes": 0, "d2h_copies": 0, "h2d_bytes": 0, "h2d_copies": 0,
            "plan_tasks": 0, "plan_host_copies": 0,
        }
        self._xfer0 = grb.host_transfers()
        self._copies0 = xfer.copies()
        self._tasks0 = _bsr.plan_tasks
        self._plan_copies0 = _bsr.plan_host_copies
        self._refresh()                     # fail fast on a bad source

    # -- submission -----------------------------------------------------------
    def submit(self, text: str, seeds=None,
               arrival_s: Optional[float] = None) -> int:
        """Queue one read query; returns its qid (the key in flush()'s
        result dict). ``seeds=`` is the parameterized form: the text is the
        seed-free shape template (cached once), the ids bind per call.
        ``arrival_s`` (perf_counter clock) backdates arrival for open-loop
        load replay; it defaults to now. Parse/plan errors raise here, to
        the submitter — they never reach the queue."""
        p, sig = self._plans.get(text)
        self.stats["plan_cache_hits"] = self._plans.hits
        self.stats["plan_cache_misses"] = self._plans.misses
        self.stats["plan_cache_hit_rate"] = self._plans.hit_rate
        if seeds is not None:
            p = dataclasses.replace(p, seeds=[int(s) for s in seeds])
        s = Submitted(self._next_id, p, sig,
                      arrival_s if arrival_s is not None
                      else time.perf_counter(),
                      len(p.seeds) if p.seeds is not None else 0)
        self._next_id += 1
        self._queue.append(s)
        return s.qid

    @property
    def pending(self) -> int:
        """Queries queued or in flight (not yet projected)."""
        inflight = (len(self._inflight.members) + len(self._inflight.failed)
                    if self._inflight is not None else 0)
        return len(self._queue) + inflight

    # -- the serving loop -----------------------------------------------------
    def pump(self) -> Dict[int, Result]:
        """One continuous-batching tick: launch the next admission-
        controlled batch, then finish the previously launched one while the
        new sweep runs on the device. Returns the queries completed this
        tick (usually the previous batch). Never raises per-query errors —
        they come back as error Results."""
        out: Dict[int, Result] = {}
        nxt: Optional[_Batch] = None
        with tracing.span("pump") as sp:
            chunk = self._next_chunk()
            if chunk:
                bid = next(self._bids)
                try:
                    ctx = self._refresh()
                    with tracing.span("launch", rid=bid, batch=bid,
                                      qids=[m.qid for m in chunk]) as ls:
                        nxt = self._launch(ctx, chunk, bid, ls)
                except Exception as e:            # snapshot/refresh failure
                    t0 = time.perf_counter()
                    for m in chunk:
                        m.wait_s = t0 - m.t_submit
                    self.stats["queries"] += len(chunk)
                    nxt = _Batch(bid, chunk, [], self._ctx, [], None, e,
                                 chunk[0].plan.seeds is None)
            done = self._inflight
            sp.set(launched=nxt.bid if nxt is not None else None,
                   finished=done.bid if done is not None else None)
            if done is not None:
                with tracing.span("finish", rid=done.bid, batch=done.bid):
                    self._finish(done, out)
            self._inflight = nxt
        return out

    def flush(self) -> Dict[int, Result]:
        """Execute everything queued (and in flight); the queue always
        drains — per-query failures land as error Results, never as a
        flush-wide exception."""
        out: Dict[int, Result] = {}
        while self._queue or self._inflight is not None:
            out.update(self.pump())
        return out

    # -- scheduler internals --------------------------------------------------
    def _refresh(self) -> ExecutionContext:
        """Context over the freshest snapshot-consistent frozen view. The
        freeze is cached per epoch upstream, so an unchanged graph reuses
        the same ExecutionContext (and its hop-matrix caches)."""
        g = self._snapshot_graph()
        if self._ctx is None or self._ctx.graph is not g:
            self._ctx = ExecutionContext(g, mesh=self.mesh)
        return self._ctx

    def _snapshot_graph(self) -> Graph:
        src = self._source
        if isinstance(src, Graph):
            return src
        if callable(src):                   # refresh hook
            return src()
        # a mesh serves compacted ELL: distribute has no delta lowering
        fmt = "ell" if self.mesh is not None else None
        if hasattr(src, "freeze"):          # MutableGraph
            return src.freeze(fmt=fmt, compact=self.mesh is not None)
        if hasattr(src, "graphs"):          # Database
            if self._graph_name is None:
                raise TypeError("QueryServer(Database) needs graph=<name> "
                                "(or use Database.server(name))")
            return src._graph(self._graph_name).freeze(
                fmt=fmt, compact=self.mesh is not None)
        raise TypeError(
            f"cannot serve {type(src).__name__}: expected Graph, "
            f"MutableGraph, Database (+graph=), or a callable -> Graph")

    def _next_chunk(self) -> List[Submitted]:
        """Admission control: pop one batch off the queue head. Unseeded
        (label-scan) queries ride alone; seeded ones coalesce with every
        queued signature-equal member, in arrival order, until the chunk
        holds `max_batch` members or `max_width` total frontier columns.
        A single query wider than the cap still runs — alone."""
        if not self._queue:
            return []
        head = self._queue[0]
        if head.plan.seeds is None:
            self._queue = self._queue[1:]
            return [head]
        take, rest, width = [head], [], head.width
        for s in self._queue[1:]:
            if (len(take) < self.max_batch and s.sig == head.sig
                    and s.plan.seeds is not None
                    and width + s.width <= self.max_width):
                take.append(s)
                width += s.width
            else:
                rest.append(s)
        self._queue = rest
        return take

    def _launch(self, ctx: ExecutionContext, members: List[Submitted],
                bid: int, sp) -> _Batch:
        """Resolve the chunk's seeds and enqueue its device sweep as batch
        ``bid`` (its ``launch`` span ``sp`` gets the width). Member-
        specific failures (bad seed ids) drop only that member; chunk-level
        failures (unknown label/relation — shared by construction, the
        members are signature-equal) mark the batch for finish() to
        isolate. Does NOT block on the device."""
        t0 = time.perf_counter()
        solo = members[0].plan.seeds is None
        for m in members:
            m.wait_s = t0 - m.t_submit
        b = _Batch(bid, members, [], ctx, [], None, None, solo)
        p0 = members[0].plan
        try:
            src_mask = ctx.node_mask(p0.src_label,
                                     p0.var_preds.get(p0.src_var))
        except Exception as e:
            b.error = e
            src_mask = None
        if src_mask is not None:
            live: List[Submitted] = []
            for m in members:
                try:
                    s = (resolve_seeds(m.plan, src_mask)
                         if m.plan.seeds is not None else
                         np.nonzero(src_mask)[0])
                except Exception as e:
                    m.result = _error_result(e)
                    b.failed.append(m)
                    continue
                live.append(m)
                b.seed_lists.append(s)
            b.members = live
        width = int(sum(len(s) for s in b.seed_lists))
        sp.set(width=width)
        if width:
            flat = np.concatenate(b.seed_lists)
            pad = (_aligned(width) - width) if self.align else 0
            keep = None
            if pad:
                flat = np.concatenate([flat, np.zeros(pad, np.int64)])
                keep = np.ones(len(flat), dtype=bool)
                keep[width:] = False
            try:
                b.B = ctx.traverse(p0, flat, keep=keep)
            except Exception as e:
                b.error = e
        # serving metrics (lanes are counted at launch, where padding is)
        self.stats["queries"] += len(members)
        if solo:
            self.stats["solo"] += 1
        else:
            self.stats["batches"] += 1
            self.stats["batched_width_total"] += width
            self.stats["batch_width_max"] = max(
                self.stats["batch_width_max"], width)
            if width and b.error is None:   # lanes of sweeps actually run
                self.stats["pack_lanes"] += width
                self.stats["pack_slots"] += (_aligned(width) if self.align
                                             else width)
                self.stats["pack_ratio"] = (self.stats["pack_lanes"]
                                            / self.stats["pack_slots"])
        self.stats["queue_wait_s_total"] += sum(m.wait_s for m in members)
        return b

    def _finish(self, b: _Batch, out: Dict[int, Result]) -> None:
        """Materialize a launched batch (blocks on the device) and project
        each member's columns. A batch-level launch error degrades to
        per-member solo retries, so one bad tenant never answers for the
        others; per-member projection errors stay per-member. A
        ``KernelError`` (a kernel that did not build, load or launch) is
        no tenant's fault and is never retried: a retry would answer
        through another route. It becomes every member's error."""
        if isinstance(b.error, KernelError):
            for m in b.members:
                m.result = _error_result(b.error)
        elif b.error is not None:
            for m in b.members:
                try:
                    if b.ctx is None:       # snapshot refresh itself failed
                        raise b.error
                    m.result = b.ctx.run(m.plan)
                except Exception as e:
                    m.result = _error_result(e)
        elif b.B is not None:
            # the host waits for the device
            Bn = xfer.to_host(b.B, "frontier").numpy()
            off = 0
            with tracing.span("project", batch=b.bid,
                              members=len(b.members)):
                for m, seeds in zip(b.members, b.seed_lists):
                    w = len(seeds)
                    try:
                        m.result = (b.ctx.project(m.plan, seeds,
                                                  Bn[:, off:off + w])
                                    if w else empty_result(m.plan))
                    except Exception as e:
                        m.result = _error_result(e)
                    off += w
        else:                               # every member resolved empty
            for m in b.members:
                m.result = empty_result(m.plan)
        t1 = time.perf_counter()
        for m in b.members + b.failed:
            m.latency_s = t1 - m.t_submit
            if m.result.error is not None:
                self.stats["errors"] += 1
            out[m.qid] = m.result
            self.log.append(m)
        self.stats["host_transfers"] = grb.host_transfers() - self._xfer0
        for k, v in xfer.copies().items():
            self.stats[k] = v - self._copies0[k]
        self.stats["plan_tasks"] = _bsr.plan_tasks - self._tasks0
        self.stats["plan_host_copies"] = (_bsr.plan_host_copies
                                          - self._plan_copies0)

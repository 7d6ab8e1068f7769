"""The database shell: named graphs and query routing (GRAPH.QUERY analog).

Port of ``repro.engine.database``. Writes (CREATE / DELETE) apply as delta
appends, the paper's write path: each relation keeps a frozen base matrix
plus small pending plus/minus deltas (``core.delta.DeltaMatrix``), so a
write never triggers a rebuild. ``MutableGraph.freeze()`` returns a
snapshot-consistent view: delta updates are functional, so a reader that
froze before a write batch keeps seeing the state before it. When a
relation's pending deltas cross ``core.delta.AUTO_DELTA_COMPACT`` of its
base, freeze folds them into a fresh base of the same format (compaction,
not a rebuild: the edge log is never replayed).

Every mutating command is appended to the AOF and fsynced before
``Database.query`` returns; replay after a crash coalesces the whole log
into deltas over one base build.

Device: a ``Database`` / ``MutableGraph`` places its label and property
columns and every base on ``device`` (``"cuda"`` by default, which raises
without a card); the patches and materializations the deltas compose
follow their base. The host keeps the write state (the live edge set, the
op log) and the deltas' COO sets.

Sharded serving: ``query(..., mesh=m)`` / ``context(..., mesh=m)`` /
``server(..., mesh=m)`` serve the same reads over a ``distr.mesh.Mesh``.
The frozen view is compacted to ELL (the mesh layout has no delta
lowering) and its relation handles are distributed onto the mesh, cached
per mesh on the view's handles.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import grb
from repro_torch.core.delta import DeltaMatrix, needs_compaction
from repro_torch.core.ell import ELL
from repro_torch.engine import persistence as P
from repro_torch.graph.graph import Graph, GraphBuilder, Relation, _device
from repro_torch.query import qast as A
from repro_torch.query.executor import ExecutionContext, Result, explain
from repro_torch.query.parser import parse


class MutableGraph:
    """Host-side mutable graph with delta-served frozen views.

    Writes append to an op log and the live edge set; ``freeze()`` serves
    a Graph whose relation handles are DeltaMatrix-backed, built once per
    format and caught up functionally (``apply_ops``) on later freezes.
    ``delta=False`` restores rebuild-on-freeze (every mutation clears the
    build cache), the oracle the delta path is held against.

    Deleted nodes are tombstones: DELETE (i) removes the node's incident
    edges, labels and properties, but the id stays allocated.
    """

    def __init__(self, delta: bool = True, device="cuda"):
        self.device = _device(device)
        self.next_id = 0
        self.labels: Dict[str, list] = {}
        self.props: Dict[str, dict] = {}
        self.edges: Dict[Tuple[str, int, int], float] = {}  # live edge set
        # relation types ever created: a relation persists (possibly
        # empty) after its last edge is deleted, as RedisGraph's schema
        self.rels: set = set()
        self.delta = delta
        self.fmt = "auto"
        self.block = 64
        # write clock: every mutating call advances it; freeze() keys
        # snapshot views by (fmt, epoch)
        self.epoch = 0
        self._oplog: list = []          # (rel, "add"/"del", src, dst, w)
        self._pairs: Dict[Tuple[int, int], int] = {}  # adj ("") refcounts
        # delta serving state per fmt: (oplog index consumed, Graph view)
        self._served: Dict[str, Tuple[int, Graph]] = {}
        self._views: Dict[tuple, Graph] = {}   # (fmt, epoch[, compacted])
        self._builds: Dict[str, Graph] = {}    # rebuild mode + bulk loads
        self.rebuilds = 0               # full GraphBuilder builds
        self.compactions = 0            # delta folds back into a base

    # -- mutations ---------------------------------------------------------
    def create_node(self, label: Optional[str], props: dict) -> int:
        nid = int(props["id"]) if "id" in props else self.next_id
        self.next_id = max(self.next_id, nid + 1)
        if label:
            ids = self.labels.setdefault(label, [])
            if nid not in ids:
                ids.append(nid)
        for k, v in props.items():
            if k != "id":
                self.props.setdefault(k, {})[nid] = float(v)
        self._mutated()
        return nid

    def create_edge(self, src: int, rel: str, dst: int,
                    weight: float = 1.0) -> None:
        src, dst = int(src), int(dst)
        self.next_id = max(self.next_id, src + 1, dst + 1)
        key = (rel, src, dst)
        self.rels.add(rel)
        fresh = key not in self.edges
        self.edges[key] = float(weight)
        self._oplog.append((rel, "add", src, dst, float(weight)))
        if fresh:
            pair = (src, dst)
            self._pairs[pair] = self._pairs.get(pair, 0) + 1
            if self._pairs[pair] == 1:
                self._oplog.append(("", "add", src, dst, 1.0))
        self._mutated()

    def delete_edge(self, src: int, rel: str, dst: int) -> bool:
        """Remove one edge; False (a no-op) if it was not present."""
        src, dst = int(src), int(dst)
        if self.edges.pop((rel, src, dst), None) is None:
            return False
        self._oplog.append((rel, "del", src, dst, 0.0))
        pair = (src, dst)
        self._pairs[pair] -= 1
        if self._pairs[pair] == 0:
            del self._pairs[pair]
            self._oplog.append(("", "del", src, dst, 0.0))
        self._mutated()
        return True

    def delete_node(self, nid: int) -> int:
        """Tombstone a node: drop its incident edges, labels and props.
        Returns the number of edges removed with it."""
        nid = int(nid)
        incident = [k for k in self.edges if k[1] == nid or k[2] == nid]
        for rel, s, d in incident:
            self.delete_edge(s, rel, d)
        for ids in self.labels.values():
            if nid in ids:
                ids.remove(nid)
        for kv in self.props.values():
            kv.pop(nid, None)
        self._mutated()
        return len(incident)

    def _mutated(self) -> None:
        self.epoch += 1
        if not self.delta:
            self._builds.clear()        # rebuild-on-freeze mode

    # -- reads -------------------------------------------------------------
    def freeze(self, fmt: Optional[str] = None, compact: bool = False) -> Graph:
        """Snapshot-consistent frozen view at the current epoch.

        ``fmt=None`` keeps this graph's default; an explicit fmt gets its
        own serving state. In delta mode the base matrices are built once
        per format; later freezes catch the view up by applying the new
        op-log suffix as functional delta updates, so a reader holding an
        earlier view keeps it unchanged. ``compact=True`` folds all pending
        deltas into plain base-format handles. Bulk-loaded graphs
        (``Database.load_graph``) are served as they are."""
        want = fmt or self.fmt
        if "external" in self._builds:
            return self._builds["external"]
        if not self.delta:
            return self._freeze_rebuild(want)
        key = (want, self.epoch, compact) if compact else (want, self.epoch)
        g = self._views.get(key)
        if g is not None:
            return g
        g = self._freeze_delta(want)
        if compact:
            g = _compact_view(g)
        # keep only the freshest view per (fmt, compact) flavour: older
        # epochs live exactly as long as their readers hold them
        self._views = {k: v for k, v in self._views.items()
                       if (k[0], len(k) > 2) != (want, compact)}
        self._views[key] = g
        return g

    # -- delta serving -----------------------------------------------------
    def _freeze_delta(self, want: str) -> Graph:
        n = max(self.next_id, 1)
        served = self._served.get(want)
        if served is None:
            # the one full build this format pays: base matrices from the
            # live edge set, then delta handles over them
            base = self._build_graph(want)
            g = Graph(n=base.n,
                      relations={r.name: _delta_relation(r, (n, n))
                                 for r in base.relations.values()},
                      labels=base.labels, node_props=base.node_props,
                      adj=_delta_relation(base.adj, (n, n))
                      if base.adj else None, device=self.device)
            self._served[want] = (len(self._oplog), g)
            return g
        idx, prev = served
        ops = self._oplog[idx:]
        by_rel: Dict[str, list] = {}
        for rel, kind, s, d, w in ops:
            by_rel.setdefault(rel, []).append((kind, s, d, w))
        relations: Dict[str, Relation] = {}
        names = set(prev.relations) | {r for r in by_rel if r != ""}
        for name in sorted(names):
            relations[name] = self._advance(prev.relations.get(name), name,
                                            by_rel.get(name), n)
        adj = self._advance(prev.adj, "", by_rel.get(""), n)
        g = Graph(n=n, relations=relations,
                  labels=self._label_arrays(n),
                  node_props=self._prop_arrays(n), adj=adj,
                  device=self.device)
        self._served[want] = (len(self._oplog), g)
        return g

    def _advance(self, prev_rel: Optional[Relation], name: str, ops,
                 n: int) -> Optional[Relation]:
        """One relation's catch-up: apply the op-log suffix to the previous
        view's DeltaMatrix (functional: the previous view is untouched),
        keep the linked transpose twin current with the src/dst-swapped
        ops, then compact both if the pending set crossed the threshold."""
        if prev_rel is None:
            if not ops:
                return None
            # a relation born after the base build: an empty ELL base, all
            # content served from the deltas until its first compaction
            empty = ELL.from_coo([], [], [], (n, n), device=self.device)
            fwd = DeltaMatrix.wrap(empty)
            twin = DeltaMatrix.wrap(empty)
        else:
            fwd: DeltaMatrix = prev_rel.A.store
            twin = prev_rel.A.T.store
        if ops:
            fwd = fwd.apply_ops(ops, grow_to=(n, n))
            twin = twin.apply_ops([(k, d, s, w) for k, s, d, w in ops],
                                  grow_to=(n, n))
        elif fwd.shape[0] < n:
            fwd, twin = fwd.resize((n, n)), twin.resize((n, n))
        if needs_compaction(fwd):
            fwd, twin = fwd.compact(), twin.compact()
            self.compactions += 1
        h = grb.GBMatrix(fwd, name=name)
        h.link_transpose(grb.GBMatrix(twin, name=name + "^T"))
        return Relation(name, h, nnz=fwd.nnz)

    def _label_arrays(self, n: int) -> Dict[str, torch.Tensor]:
        out = {}
        for label, ids in self.labels.items():
            m = np.zeros(n, dtype=bool)
            m[np.asarray(ids, dtype=np.int64)] = True
            out[label] = torch.from_numpy(m).to(self.device)
        return out

    def _prop_arrays(self, n: int) -> Dict[str, torch.Tensor]:
        out = {}
        for prop, kv in self.props.items():
            col = np.full(n, np.nan, np.float32)
            for k, v in kv.items():
                col[k] = v
            out[prop] = torch.from_numpy(col).to(self.device)
        return out

    # -- rebuild mode --------------------------------------------------------
    def _freeze_rebuild(self, want: str) -> Graph:
        g = self._builds.get(want)
        if g is None:
            g = self._builds[want] = self._build_graph(want)
        return g

    def _build_graph(self, want: str) -> Graph:
        self.rebuilds += 1
        n = max(self.next_id, 1)
        b = GraphBuilder(n)
        for label, ids in self.labels.items():
            b.add_label(label, ids)
        for prop, kv in self.props.items():
            b.set_prop(prop, list(kv.keys()), list(kv.values()))
        by_rel: Dict[str, list] = {rel: [] for rel in self.rels}
        for (rel, s, d), w in self.edges.items():
            by_rel.setdefault(rel, []).append((s, d, w))
        for rel, triples in by_rel.items():
            if not triples:             # schema survives an emptied relation
                b.add_edges(rel, [], [], [])
                continue
            arr = np.asarray(triples, dtype=np.float64)
            b.add_edges(rel, arr[:, 0].astype(np.int64),
                        arr[:, 1].astype(np.int64),
                        arr[:, 2].astype(np.float32))
        return b.build(fmt=want, block=self.block, device=self.device)


def _delta_relation(r: Relation, shape) -> Relation:
    """Wrap a freshly built relation's storage in empty-delta handles,
    keeping the builder's explicit transpose as the linked twin."""
    fwd = DeltaMatrix.wrap(r.A.store, shape)
    twin = DeltaMatrix.wrap(r.A.T.store, (shape[1], shape[0]))
    h = grb.GBMatrix(fwd, name=r.name)
    h.link_transpose(grb.GBMatrix(twin, name=r.name + "^T"))
    return Relation(r.name, h, nnz=fwd.nnz)


def _compact_view(g: Graph) -> Graph:
    """Every relation's deltas folded into plain base-format handles; the
    compacted view holds the folds, and the card frees them with it."""
    def plain(r: Optional[Relation]) -> Optional[Relation]:
        if r is None:
            return None
        store = r.A.store
        if not isinstance(store, DeltaMatrix):
            return r
        h = grb.GBMatrix(store.materialize(), name=r.name)
        twin = r.A.T.store
        if isinstance(twin, DeltaMatrix):
            h.link_transpose(grb.GBMatrix(twin.materialize(),
                                          name=r.name + "^T"))
        return Relation(r.name, h, nnz=r.nnz)

    return Graph(n=g.n, relations={k: plain(r)
                                   for k, r in g.relations.items()},
                 labels=g.labels, node_props=g.node_props, adj=plain(g.adj),
                 device=g.device)


class Database:
    """Named graphs over one device, with an AOF in ``data_dir`` when one
    is given (replayed on open)."""

    def __init__(self, data_dir: Optional[str] = None, delta: bool = True,
                 device="cuda"):
        self.device = _device(device)
        self.graphs: Dict[str, MutableGraph] = {}
        self.data_dir = data_dir
        self.delta = delta
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._replay_aof()

    def _graph(self, name: str) -> MutableGraph:
        g = self.graphs.get(name)
        if g is None:
            g = self.graphs[name] = MutableGraph(delta=self.delta,
                                                 device=self.device)
        return g

    # -- commands ------------------------------------------------------------
    def query(self, name: str, text: str, mesh=None) -> Result:
        """Run one command: CREATE / DELETE are fsynced to the AOF, then
        applied; anything else reads the graph's freshest frozen view (on
        ``mesh`` when one is given)."""
        q = parse(text)
        if isinstance(q, A.CreateQuery):
            self._append_aof(name, text)
            return self._apply_create(name, q)
        if isinstance(q, A.DeleteQuery):
            self._append_aof(name, text)
            return self._apply_delete(name, q)
        return self.context(name, mesh=mesh).run(q)

    def context(self, name: str, mesh=None) -> ExecutionContext:
        """Execution surface over the named graph's frozen view. The view
        is snapshot-consistent: writes issued after this call never appear
        in it. With a mesh the graph is frozen as ELL with its pending
        deltas compacted, and the relation handles are distributed onto
        the mesh."""
        g = self._graph(name).freeze(fmt="ell" if mesh is not None else None,
                                     compact=mesh is not None)
        return ExecutionContext(g, mesh=mesh)

    def server(self, name: str, mesh=None, **kw):
        """Continuous-batching server over the named graph: each batch
        serves the freshest freeze, so writes committed through ``query()``
        between batches are visible to the next one (served over ``mesh``
        when one is given)."""
        from repro_torch.engine.server import QueryServer
        return QueryServer(self._graph(name), mesh=mesh, **kw)

    def explain(self, name: str, text: str) -> str:
        return explain(self._graph(name).freeze(), text)

    def load_graph(self, name: str, graph: Graph) -> None:
        """Bulk load a pre-built Graph (the datagen path), served as is."""
        mg = self._graph(name)
        mg._builds = {"external": graph}
        mg.next_id = graph.n

    def _apply_create(self, name: str, q: A.CreateQuery) -> Result:
        mg = self._graph(name)
        created_n = created_e = 0
        for item in q.items:
            if isinstance(item, A.CreateNode):
                mg.create_node(item.label, item.props)
                created_n += 1
            else:
                mg.create_edge(item.src, item.rel, item.dst)
                created_e += 1
        return Result(["nodes_created", "edges_created"],
                      [(created_n, created_e)])

    def _apply_delete(self, name: str, q: A.DeleteQuery) -> Result:
        mg = self._graph(name)
        deleted_n = deleted_e = 0
        for item in q.items:
            if isinstance(item, A.DeleteNode):
                deleted_e += mg.delete_node(item.id)
                deleted_n += 1
            else:
                deleted_e += int(mg.delete_edge(item.src, item.rel,
                                                item.dst))
        return Result(["nodes_deleted", "edges_deleted"],
                      [(deleted_n, deleted_e)])

    # -- persistence (AOF) ---------------------------------------------------
    def _append_aof(self, name: str, text: str) -> None:
        if self.data_dir:
            P.append_aof(P.aof_path(self.data_dir, name), text)

    def _replay_aof(self) -> None:
        """Crash recovery: re-apply the append-only log. Replayed writes
        coalesce into the host state (and, once a reader freezes, into
        deltas over one base build): no per-line rebuilds."""
        for name, line in P.iter_aof(self.data_dir):
            q = parse(line)
            if isinstance(q, A.DeleteQuery):
                self._apply_delete(name, q)
            else:
                self._apply_create(name, q)

"""PyTorch port, ``repro_torch.tracing`` and ``core.xfer``'s copy counters.

Off, a span is one shared no-op and nothing is recorded; on, a CPU
``QueryServer``'s k-hop flush records the span tree pump > launch >
traverse > expand > hop and pump > finish > d2h / project, every span of a
sweep under its batch id, and ``launch`` naming the sweep's queries; a
``CALL algo.triangles`` records its SpGEMM plan's tasks, which
``QueryServer.stats["plan_tasks"]`` counts too, or, on the masked dot
route, one ``spgemm_dot`` span with the mask's entries, which
``stats["dot_entries"]`` counts; a collection is a ``gc``
span under the span it struck in; under the torch profiler the spans are
``repro.*`` ranges around the ops they launch. On a CPU graph no copy
crosses to a card, so the copy counters stay 0. The card test
(``cuda``, skipped here) counts a CUDA sweep's copies and bytes.
"""
import gc
import json

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import bsr as tbsr, grb as tgrb, xfer
from repro_torch.engine import QueryServer
from repro_torch.graph import datagen
from repro_torch.graph.graph import GraphBuilder

KHOP = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
SEEDS = [0, 3, 5, 9, 17]


@pytest.fixture(autouse=True)
def _cuda_gate(request):
    """Tests marked `cuda` need a card; decided per test, never at import."""
    if (request.node.get_closest_marker("cuda") is not None
            and not torch.cuda.is_available()):
        pytest.skip("cuda: needs an NVIDIA GPU (the copies it counts cross "
                    "to a card); run on the card")


@pytest.fixture
def traced():
    """Tracing on with no records; the process's state as it was after."""
    was = tracing.enabled()
    tracing.clear()
    tracing.enable()
    yield tracing
    tracing.clear()
    (tracing.enable if was else tracing.disable)()


def _graph(fmt="ell", device="cpu", undirected=False):
    src, dst, n = datagen.rmat_edges(7, 8, seed=3)
    if undirected:
        keep = src != dst
        src, dst = (np.concatenate([src[keep], dst[keep]]),
                    np.concatenate([dst[keep], src[keep]]))
    return GraphBuilder(n).add_edges("KNOWS", src, dst).build(
        fmt=fmt, block=32, device=device)


def _flush(g, seeds=SEEDS):
    srv = QueryServer(g)
    qids = [srv.submit(KHOP, seeds=[s]) for s in seeds]
    out = srv.flush()
    assert all(out[q].error is None for q in qids)
    return srv, qids


def _chain(recs, i):
    names = []
    while i >= 0:
        names.append(recs[i].name)
        i = recs[i].parent
    return list(reversed(names))


def test_off_records_nothing_and_leaves_the_collector_alone():
    was = tracing.enabled()
    tracing.disable()
    tracing.clear()
    try:
        hooks = list(gc.callbacks)
        assert tracing.span("pump") is tracing.span("hop", hop=1)
        with tracing.span("pump") as sp:
            sp.set(launched=0)
        _flush(_graph())
        gc.collect()
        assert tracing.records() == [] and tracing.dropped() == 0
        assert gc.callbacks == hooks
    finally:
        (tracing.enable if was else tracing.disable)()


def test_enable_adds_one_collector_hook_and_disable_removes_it():
    was = tracing.enabled()
    tracing.disable()
    try:
        n = len(gc.callbacks)
        tracing.enable()
        tracing.enable()
        assert len(gc.callbacks) == n + 1 and tracing.enabled()
        tracing.disable()
        assert len(gc.callbacks) == n and not tracing.enabled()
    finally:
        (tracing.enable if was else tracing.disable)()


def test_khop_flush_span_tree_and_batch_ids(traced):
    srv, qids = _flush(_graph())
    recs = traced.records()
    assert all(r.t1 >= r.t0 > 0 for r in recs)
    chains = {tuple(_chain(recs, i)) for i, r in enumerate(recs)
              if r.name != "gc"}
    assert ("pump", "launch", "traverse", "expand", "hop") in chains
    assert ("pump", "finish", "d2h") in chains
    assert ("pump", "finish", "project") in chains

    launch = [r for r in recs if r.name == "launch"]
    finish = [r for r in recs if r.name == "finish"]
    assert len(launch) == len(finish) == srv.stats["batches"] == 1
    bid = launch[0].attrs["batch"]
    assert launch[0].rid == finish[0].rid == finish[0].attrs["batch"] == bid
    assert launch[0].attrs["qids"] == qids
    assert launch[0].attrs["width"] == len(SEEDS)
    for i, r in enumerate(recs):
        if r.name != "gc" and _chain(recs, i)[1:2] in (["launch"],
                                                       ["finish"]):
            assert r.rid == bid, r
    pumps = [r for r in recs if r.name == "pump"]
    assert [(p.attrs["launched"], p.attrs["finished"]) for p in pumps] == \
        [(bid, None), (None, bid)]
    (expand,) = [r for r in recs if r.name == "expand"]
    assert expand.attrs["route"] == "words"
    assert [r.attrs["hop"] for r in recs if r.name == "hop"] == [1, 2]
    (project,) = [r for r in recs if r.name == "project"]
    assert project.attrs == {"batch": bid, "members": len(SEEDS)}
    tags = sorted(r.attrs["tag"] for r in recs if r.name == "d2h")
    assert tags == ["frontier", "mask", "mask"]


@pytest.mark.parametrize("fmt,hops,route,hop_spans", [
    ("ell", "*1..2", "words", [1, 2]),
    ("bsr", "*2..3", "float", [1, 2, 3]),
    ("bsr", "*1..2", "spgemm_hop", []),
])
def test_expand_names_its_route_and_hops(traced, fmt, hops, route,
                                         hop_spans):
    srv = QueryServer(_graph(fmt=fmt))
    qid = srv.submit(KHOP.replace("*1..2", hops), seeds=[3])
    assert srv.flush()[qid].error is None
    recs = traced.records()
    (expand,) = [r for r in recs if r.name == "expand"]
    assert expand.attrs == {"route": route}
    assert [r.attrs["hop"] for r in recs if r.name == "hop"] == hop_spans
    plans = [i for i, r in enumerate(recs) if r.name == "spgemm_plan"]
    assert bool(plans) == (route == "spgemm_hop")
    for i in plans:
        assert _chain(recs, i)[:5] == ["pump", "launch", "traverse",
                                       "expand", "spgemm"]


def test_triangles_call_counts_its_plan_tasks(traced):
    g = _graph(fmt="bsr", undirected=True)
    srv = QueryServer(g)
    qid = srv.submit("CALL algo.triangles(rel: KNOWS)")
    out = srv.flush()
    assert out[qid].error is None
    recs = traced.records()
    (plan,) = [r for r in recs if r.name == "spgemm_plan"]
    (mult,) = [r for r in recs if r.name == "spgemm"]
    assert _chain(recs, recs.index(plan)) == [
        "pump", "launch", "traverse", "call_device", "spgemm", "spgemm_plan"]
    (call,) = [r for r in recs if r.name == "call_device"]
    assert call.attrs == {"procedure": "algo.triangles", "rows": 1}
    (rows,) = [r for r in recs if r.name == "call_project"]
    assert rows.attrs == {"procedure": "algo.triangles", "rows": 1}

    A = g.relation("KNOWS").A.store
    before = tbsr.plan_tasks
    want = tbsr.spgemm_symbolic(A, A, mask=A)
    tasks = int(np.count_nonzero(want.valid))
    assert 0 < tasks <= want.ntasks and tbsr.plan_tasks - before == tasks
    assert plan.attrs == {"tasks": tasks, "tiles": want.nc}
    assert mult.attrs == plan.attrs
    assert srv.stats["plan_tasks"] == tasks
    # the plan's two counts, read through core.xfer inside its span
    assert srv.stats["plan_host_copies"] == 2
    served = recs.index(plan)
    reads = [r for r in recs if r.name == "d2h" and r.attrs["tag"] == "plan"
             and r.rid == plan.rid]
    assert len(reads) == 2 and all(r.parent == served for r in reads)


def test_a_dot_route_call_records_its_span_and_entries(traced, monkeypatch):
    """A triangle call on the masked dot route records one ``spgemm_dot``
    span under ``call_device``, tagged with the mask's entries and the
    work (the sum over them of the shorter list's length), runs no SpGEMM
    plan, and moves ``stats["dot_entries"]`` by the mask's entries."""
    monkeypatch.setattr(tgrb, "DOT_MAX_FILL", 1.01)
    g = _graph(fmt="bsr", undirected=True)
    srv = QueryServer(g)
    qid = srv.submit("CALL algo.triangles(rel: KNOWS)")
    assert srv.flush()[qid].error is None
    recs = traced.records()
    (dot,) = [r for r in recs if r.name == "spgemm_dot"]
    assert not [r for r in recs if r.name in ("spgemm", "spgemm_plan")]
    assert _chain(recs, recs.index(dot)) == [
        "pump", "launch", "traverse", "call_device", "spgemm_dot"]
    csr = g.relation("KNOWS").A.store.row_csr()
    deg = csr.indptr.diff()
    work = int(torch.minimum(deg[tbsr.csr_rows(csr)],
                             deg[csr.cols.long()]).sum())
    assert dot.attrs == {"entries": csr.entries, "work": work}
    assert srv.stats["dot_entries"] == csr.entries
    assert srv.stats["plan_tasks"] == 0


def test_a_collection_is_a_gc_span_under_the_span_it_struck(traced):
    with tracing.span("probe", rid=7):
        gc.collect()
    recs = traced.records()
    (probe,) = [i for i, r in enumerate(recs) if r.name == "probe"]
    mine = [r for r in recs if r.name == "gc" and r.parent == probe]
    assert mine and mine[-1].attrs == {"generation": 2}
    assert mine[-1].rid == 7
    assert recs[probe].t0 <= mine[-1].t0 <= mine[-1].t1 <= recs[probe].t1


def test_spans_past_capacity_are_dropped(traced, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    for _ in range(5):
        with tracing.span("hop", hop=1):
            pass
    assert len(tracing.records()) == 3 and tracing.dropped() == 2


def test_spans_are_profiler_ranges_around_their_ops(traced, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    g = _graph()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _flush(g)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    assert {"repro.pump", "repro.launch", "repro.traverse", "repro.expand",
            "repro.hop", "repro.finish", "repro.project",
            "repro.d2h"} <= set(ranges)
    assert "repro.gc" not in ranges
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] == "aten::zeros"]
    inside = [e for e in ops for a, b in ranges["repro.traverse"]
              if a <= e["ts"] and e["ts"] + e["dur"] <= b]
    assert inside, "no aten::zeros inside repro.traverse"


def test_copy_counters_stay_zero_on_a_cpu_graph(traced):
    c0 = xfer.copies()
    srv, _ = _flush(_graph())
    assert xfer.copies() == c0
    for k in ("d2h_bytes", "d2h_copies", "h2d_bytes", "h2d_copies",
              "plan_tasks", "plan_host_copies", "host_transfers"):
        assert srv.stats[k] == 0, k
    x = np.arange(6, dtype=np.int32)
    t = xfer.to_device(x, "cpu", "probe")
    assert t.dtype == torch.int32 and torch.equal(t, torch.from_numpy(x))
    assert xfer.to_host(t, "probe") is t
    assert xfer.copies() == c0
    d2h = [r for r in tracing.records() if r.name in ("d2h", "h2d")]
    assert d2h and all(r.attrs["bytes"] == 0 for r in d2h)


@pytest.mark.cuda
def test_cuda_sweep_counts_its_copies_and_bytes(traced):
    g = _graph(device="cuda")
    srv, _ = _flush(g)
    n, width = g.n, 8                   # 5 seeds pad to 8 columns
    assert srv.stats["d2h_copies"] == 3
    assert srv.stats["d2h_bytes"] == n * width * 4 + 2 * n
    assert srv.stats["h2d_copies"] == 3
    assert srv.stats["h2d_bytes"] == width * 8 + width * 4 + n * 4
    d2h = [r for r in tracing.records() if r.name == "d2h"]
    assert sum(r.attrs["bytes"] for r in d2h) == srv.stats["d2h_bytes"]

"""PyTorch port, the slice end to end: seeded MATCH through ``execute`` and
the continuous-batching ``QueryServer``, held against the JAX package.

Each graph is built twice: through both packages' ``GraphBuilder`` from the
same numpy-seeded generator, and as a port graph adopted with
``repro_torch.graph.from_arrays`` from the JAX graph's own storage arrays.
Rows are compared exactly (counts and ids are integers). The same slice
on the card is tested by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

from repro.engine import QueryServer as JServer
from repro.graph import datagen as jdatagen
from repro.query.executor import execute as jexecute
from repro.query.reference import execute_ref as jexecute_ref
from repro_torch.engine import QueryServer as TServer
from repro_torch.graph import datagen as tdatagen
from repro_torch.graph import from_arrays
from repro_torch.query import execute as texecute
from repro_torch.query.parser import parse
from repro_torch.query.planner import plan
from repro_torch.query.reference import execute_ref as texecute_ref


# the query list of tests/test_query.py, plus walk counts (count without
# DISTINCT, the plus_times route), a wide seed list (the packed word route
# on ELL) and an unseeded label scan
SOCIAL_QUERIES = [
    "MATCH (a:Person)-[:KNOWS]->(b) WHERE id(a) = 5 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [1, 7, 33] RETURN a, count(DISTINCT b)",
    "MATCH (a:Person)-[:KNOWS*1..3]->(b:Person) WHERE id(a) = 12 AND b.age > 40 RETURN count(DISTINCT b)",
    "MATCH (a:Person)-[:KNOWS]->(b)-[:VISITS]->(c:City) WHERE id(a) = 9 RETURN count(DISTINCT c)",
    "MATCH (a:Person)<-[:KNOWS]-(b) WHERE id(a) = 14 RETURN count(DISTINCT b)",
    "MATCH (a:Person)-[:KNOWS]-(b) WHERE id(a) = 21 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS]->(b) WHERE id(a) IN [2, 3] RETURN a, b LIMIT 10",
    "MATCH (a:Person)-[:KNOWS]->(b) WHERE id(a) = 5 AND (b.age < 20 OR b.age >= 60) RETURN count(DISTINCT b)",
    "MATCH (a:Person)-[:KNOWS]->(b) WHERE id(a) = 5 AND NOT b.age < 30 RETURN count(DISTINCT b)",
    "MATCH (a:Person)-[:KNOWS*2..3]->(b) WHERE id(a) = 40 RETURN count(DISTINCT b)",
    "MATCH (a:Person)-[:KNOWS*1..2]->(b) WHERE id(a) IN [3, 3, 5] RETURN count(b)",
    "MATCH (a)-[:KNOWS*1..2]-(b) WHERE id(a) IN [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10] RETURN a, count(DISTINCT b)",
    "MATCH (a:City)<-[:VISITS]-(b) RETURN count(DISTINCT b)",
    "MATCH (a)-[*1..2]->(b) WHERE id(a) = 9 RETURN b, b.age LIMIT 7",
]

# the same shapes on an unlabeled single-relation RMAT graph
RMAT_QUERIES = [
    "MATCH (a)-[:KNOWS]->(b) WHERE id(a) = 5 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [1, 7, 33] RETURN a, count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..3]->(b) WHERE id(a) = 12 RETURN count(DISTINCT b)",
    "MATCH (a)<-[:KNOWS]-(b) WHERE id(a) = 14 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS]-(b) WHERE id(a) = 21 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS]->(b) WHERE id(a) IN [2, 3] RETURN a, b LIMIT 10",
    "MATCH (a)-[:KNOWS*2..3]->(b) WHERE id(a) = 40 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [0, 3, 3] RETURN count(b)",
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11] RETURN a, count(DISTINCT b)",
    "MATCH (a)-[*1..2]->(b) WHERE id(a) = 9 RETURN count(DISTINCT b)",
]

GRAPHS = {
    "social_ell": lambda m, **kw: m.social_graph(n=512, seed=0, fmt="ell",
                                                 **kw),
    "social_bitadj": lambda m, **kw: m.social_graph(n=512, seed=0,
                                                    fmt="bitadj", **kw),
    "rmat8_auto": lambda m, **kw: m.rmat_graph(8, seed=0, fmt="auto", **kw),
    "rmat8_bitadj": lambda m, **kw: m.rmat_graph(8, seed=0, fmt="bitadj",
                                                 **kw),
}

_cache = {}


def _arrays(store) -> dict:
    if hasattr(store, "tiles"):
        return {"tiles": np.asarray(store.tiles), "cols": np.asarray(store.cols)}
    return {name: np.asarray(getattr(store, name))
            for name in ("indices", "mask", "values")}


def port_from_jax(gj, device="cpu"):
    """The port's graph over the JAX graph's very storage arrays."""
    def pair(r):
        return (_arrays(r.A.store), _arrays(r.A_T.store))
    return from_arrays(
        gj.n, {k: pair(r) for k, r in gj.relations.items()},
        adj=pair(gj.adj) if gj.adj is not None else None,
        labels={k: np.asarray(v) for k, v in gj.labels.items()},
        node_props={k: np.asarray(v) for k, v in gj.node_props.items()},
        device=device)


def graphs(name):
    """(JAX graph, port graph built by its GraphBuilder, port graph adopted
    from the JAX arrays), built once per module."""
    if name not in _cache:
        gj = GRAPHS[name](jdatagen)
        _cache[name] = (gj, GRAPHS[name](tdatagen, device="cpu"),
                        port_from_jax(gj))
    return _cache[name]


def _cases():
    for name in GRAPHS:
        qs = SOCIAL_QUERIES if name.startswith("social") else RMAT_QUERIES
        for i, q in enumerate(qs):
            yield pytest.param(name, q, id=f"{name}-q{i}")


@pytest.mark.parametrize("name,q", list(_cases()))
def test_execute_matches_jax(name, q):
    gj, gt_built, gt_adopted = graphs(name)
    want = jexecute(gj, q)
    for gt in (gt_built, gt_adopted):
        got = texecute(gt, q)
        assert got.columns == want.columns
        assert got.rows == want.rows, q
    if plan(parse(q)).semiring == "or_and":
        ref = texecute_ref(gt_built, q)
        assert ref.columns == want.columns
        assert sorted(ref.rows) == sorted(jexecute_ref(gj, q).rows)
        assert sorted(ref.rows) == sorted(want.rows)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_builders_agree_on_storage(name):
    gj, gt, _ = graphs(name)
    for rel in gj.relations:
        for side in ("A", "A_T"):
            js = getattr(gj.relations[rel], side).store
            ts = getattr(gt.relations[rel], side).store
            assert type(js).__name__ == type(ts).__name__
            for key, want in _arrays(js).items():
                got = getattr(ts, key).numpy()
                if key == "tiles":
                    got = got.view(np.uint32)
                np.testing.assert_array_equal(got, want)
            assert ts.nnz == js.nnz


def test_rmat_auto_picks_bitell_at_scale_8():
    _, gt, _ = graphs("rmat8_auto")
    assert gt.relations["KNOWS"].A.fmt == "bitadj"


@pytest.mark.parametrize("q", [SOCIAL_QUERIES[2], SOCIAL_QUERIES[12],
                               "CALL algo.bfs(rel: KNOWS, sources: [3])"])
def test_explain_matches_jax(q):
    from repro.query.executor import explain as jexplain
    from repro_torch.query import explain as texplain
    gj, gt, _ = graphs("social_ell")
    assert texplain(gt, q) == jexplain(gj, q)


# -- the server: per-qid results equal the JAX server's -----------------------
def _queue(n, rel):
    texts = []
    for s in range(0, n, max(1, n // 9)):
        texts.append(f"MATCH (a)-[:{rel}*1..2]->(b) WHERE id(a) = {s} "
                     f"RETURN count(DISTINCT b)")
        texts.append(f"MATCH (a)-[:{rel}*2..3]->(b) WHERE id(a) = {s} "
                     f"RETURN count(DISTINCT b)")
    texts.append(f"MATCH (a)-[:{rel}]->(b) RETURN count(DISTINCT b)")
    return texts


@pytest.mark.parametrize("name", ["social_ell", "social_bitadj",
                                  "rmat8_bitadj"])
def test_server_matches_jax_server(name):
    gj, gt, _ = graphs(name)
    texts = _queue(gj.n, "KNOWS")
    js, ts = JServer(gj), TServer(gt)
    jq = [js.submit(t) for t in texts]
    tq = [ts.submit(t) for t in texts]
    # the parameterized form: seed-free text, seeds bound per call
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    jq += [js.submit(tmpl, seeds=[s]) for s in (4, 8, 15)]
    tq += [ts.submit(tmpl, seeds=[s]) for s in (4, 8, 15)]
    jout, tout = js.flush(), ts.flush()
    assert ts.pending == 0
    for a, b in zip(jq, tq):
        assert tout[b].error is None
        assert tout[b].rows == jout[a].rows
    for key in ("queries", "batches", "solo", "errors", "batch_width_max",
                "pack_lanes", "pack_slots", "plan_cache_hits",
                "plan_cache_misses", "host_transfers"):
        assert ts.stats[key] == js.stats[key], key


def test_server_error_isolation_matches_jax():
    gj, gt, _ = graphs("social_ell")
    texts = ["MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) = 3 "
             "RETURN count(DISTINCT b)",
             "MATCH (a)-[:NOPE]->(b) WHERE id(a) = 3 RETURN count(DISTINCT b)",
             "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) = 5 "
             "RETURN count(DISTINCT b)",
             f"MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) = {10 ** 6} "
             f"RETURN count(DISTINCT b)",
             "CALL algo.pagerank(rel: KNOWS) YIELD node, score"]
    js, ts = JServer(gj), TServer(gt)
    jq = [js.submit(t) for t in texts]
    tq = [ts.submit(t) for t in texts]
    jout, tout = js.flush(), ts.flush()
    assert ts.pending == 0
    for a, b in zip(jq[:4], tq[:4]):
        assert (tout[b].error is None) == (jout[a].error is None)
        assert tout[b].rows == jout[a].rows
    assert "NOPE" in tout[tq[1]].error
    assert "seed id out of range" in tout[tq[3]].error
    # the unseeded PageRank CALL is answered, with JAX's rows (its float32
    # sums are order-sensitive: atol 1e-5, as the JAX suite holds them)
    assert tout[tq[4]].error is None and jout[jq[4]].error is None
    got, want = tout[tq[4]].rows, jout[jq[4]].rows
    assert [v for v, _ in got] == [v for v, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-5, rtol=0)
    assert ts.stats["errors"] == js.stats["errors"] == 2
    again = ts.submit("MATCH (a)-[:KNOWS]->(b) WHERE id(a) = 3 "
                      "RETURN count(DISTINCT b)")
    assert ts.flush()[again].error is None


@pytest.mark.parametrize("name", ["social_ell", "social_bitadj"])
def test_server_reports_kernel_errors_without_retrying(name, monkeypatch):
    """A batch whose kernel raises KernelError is not retried query by
    query (a one-seed ELL retry would take the float loop and answer with
    no kernel): every member reports the error, and the queue drains."""
    from repro_torch.kernels import KernelError
    from repro_torch.kernels import ops as tkops

    def broken(A, Xw):
        raise KernelError("launch failed")

    _, gt, _ = graphs(name)
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    ts = TServer(gt)
    good = [ts.submit(tmpl, seeds=[s]) for s in (1, 2, 3)]
    want = ts.flush()
    monkeypatch.setattr(tkops, "ell_mxv_packed", broken)
    monkeypatch.setattr(tkops, "bitadj_mxv_packed", broken)
    bad = [ts.submit(tmpl, seeds=[s]) for s in (1, 2, 3)]
    out = ts.flush()
    assert ts.pending == 0
    assert all(out[q].error == "KernelError: launch failed" for q in bad)
    assert ts.stats["errors"] == 3
    monkeypatch.undo()
    again = [ts.submit(tmpl, seeds=[s]) for s in (1, 2, 3)]
    out = ts.flush()
    assert [out[q].rows for q in again] == [want[q].rows for q in good]

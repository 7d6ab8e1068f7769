"""PyTorch port, ``CALL algo.*``: the eight procedures through ``execute``
and through the continuous-batching ``QueryServer``, held against the JAX
package's executor and server, the port's own direct algorithm calls and
scipy / numpy oracles.

The graph is an undirected Graph500 R-MAT scale-6 graph (so that
``algo.triangles`` counts triangles) on BSR, ELL and BitELL, built by both
packages' ``GraphBuilder`` from the same edges. Integer rows (components,
communities, triangles, BFS levels) and closeness are compared exactly;
pagerank within atol 1e-5, betweenness within 1e-4 and similarity within
2e-7 relative, as the algorithm parity tests hold them. The server tests
mirror tests/test_server.py's CALL tests: seeded CALLs coalesce into one
sweep and each padded member's slice equals its solo answer; an unseeded
CALL rides alone; a bad name, argument or YIELD comes back as that
member's ``Result.error``.
"""
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse import csgraph

from repro.engine import QueryServer as JServer
from repro.graph import datagen as jdatagen
from repro.graph.graph import GraphBuilder as JBuilder
from repro.query.executor import execute as jexecute
from repro_torch import algorithms as TA
from repro_torch.engine import QueryServer as TServer
from repro_torch.graph.graph import GraphBuilder as TBuilder
from repro_torch.query import execute as texecute
from repro_torch.query.executor import PROCEDURES
from repro_torch.query.planner import PROC_COLUMNS

FMTS = ("bsr", "ell", "bitadj")
_graphs = {}


def graphs(fmt):
    """(JAX graph, port graph, scipy CSR of the stored edges), cached: the
    undirected R-MAT s6 graph, self-loops dropped."""
    if fmt not in _graphs:
        src, dst, n = jdatagen.rmat_edges(6, 8, seed=6)
        keep = src != dst
        s = np.concatenate([src[keep], dst[keep]])
        d = np.concatenate([dst[keep], src[keep]])
        jg = JBuilder(n).add_edges("KNOWS", s, d).build(fmt=fmt, block=32)
        tg = TBuilder(n).add_edges("KNOWS", s, d).build(fmt=fmt, block=32,
                                                        device="cpu")
        key = np.unique(s * n + d)
        W = sp.csr_matrix((np.ones(len(key)), (key // n, key % n)),
                          shape=(n, n))
        _graphs[fmt] = (jg, tg, W)
    return _graphs[fmt]


SOURCES = [0, 5, 17, 33]
CALLS = {  # procedure -> (query text, row tolerance: None = exact)
    "algo.pagerank": ("CALL algo.pagerank(rel: KNOWS, iters: 40)", 1e-5),
    "algo.betweenness": (f"CALL algo.betweenness(rel: KNOWS, sources: "
                         f"{SOURCES}) YIELD node, score", 1e-4),
    "algo.closeness": (f"CALL algo.closeness(rel: KNOWS, sources: "
                       f"{SOURCES}) YIELD node, score", None),
    "algo.similarity": ("CALL algo.similarity(rel: KNOWS, sources: [0, 2], "
                        "kind: overlap) YIELD node1, node2, score", 2e-7),
    "algo.wcc": ("CALL algo.wcc(rel: KNOWS)", None),
    "algo.labelprop": ("CALL algo.labelprop(rel: KNOWS) "
                       "YIELD node, community AS c", None),
    "algo.triangles": ("CALL algo.triangles(rel: KNOWS)", None),
    "algo.bfs": ("CALL algo.bfs(rel: KNOWS, sources: [0, 9], max_hops: 2) "
                 "YIELD source, node, level", None),
}


def rows_close(got, want, tol):
    assert len(got) == len(want)
    if tol is None:
        assert got == want
        return
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=tol, abs=tol)
            else:
                assert x == y


def test_procedures_are_all_ported():
    assert set(PROCEDURES) == set(PROC_COLUMNS) == set(CALLS)


@pytest.mark.parametrize("proc", list(CALLS))
@pytest.mark.parametrize("fmt", FMTS)
def test_call_matches_jax(fmt, proc):
    jg, tg, _ = graphs(fmt)
    text, tol = CALLS[proc]
    got, want = texecute(tg, text), jexecute(jg, text)
    assert got.error is None and got.columns == want.columns
    rows_close(got.rows, want.rows, tol)


@pytest.mark.parametrize("fmt", FMTS)
def test_call_equals_the_direct_calls_and_oracles(fmt):
    """Each procedure's rows are its algorithm's output, which the oracles
    pin: scipy levels, components and the triangle trace."""
    _, tg, W = graphs(fmt)
    rel = tg.relations["KNOWS"]
    n = tg.n
    pr = texecute(tg, CALLS["algo.pagerank"][0])
    assert pr.columns == ["node", "score"]
    assert [v for v, _ in pr.rows] == list(range(n))
    assert np.array_equal([s for _, s in pr.rows],
                          TA.pagerank(rel, iters=40).numpy())
    bc = texecute(tg, CALLS["algo.betweenness"][0])
    assert np.array_equal([s for _, s in bc.rows],
                          TA.betweenness(rel, sources=SOURCES).numpy())
    cl = texecute(tg, CALLS["algo.closeness"][0])
    assert [v for v, _ in cl.rows] == SOURCES
    assert np.array_equal([s for _, s in cl.rows],
                          TA.closeness(rel, sources=SOURCES).numpy())
    lv = csgraph.shortest_path(W, unweighted=True, indices=SOURCES)
    fin = np.isfinite(lv)
    tot = np.where(fin, lv, 0).sum(axis=1)
    want = (fin.sum(axis=1) - 1.0) ** 2 / ((n - 1) * tot)
    np.testing.assert_allclose([s for _, s in cl.rows], want, rtol=1e-6)
    sim = TA.similarity(rel, [0, 2], "overlap").numpy()
    want = sorted((s, int(i), float(sim[i, j]))
                  for j, s in enumerate([0, 2])
                  for i in np.nonzero(sim[:, j] > 0)[0])
    assert texecute(tg, CALLS["algo.similarity"][0]).rows == want
    _, comp = csgraph.connected_components(W, connection="weak")
    first = {c: int(np.nonzero(comp == c)[0][0]) for c in np.unique(comp)}
    wcc = texecute(tg, CALLS["algo.wcc"][0])
    assert wcc.columns == ["node", "component"]
    assert [c for _, c in wcc.rows] == [first[c] for c in comp]
    assert [c for _, c in wcc.rows] == TA.wcc(rel).tolist()
    lp = texecute(tg, CALLS["algo.labelprop"][0])
    assert lp.columns == ["node", "c"]
    assert [c for _, c in lp.rows] == TA.label_propagation(rel).tolist()
    tri = texecute(tg, CALLS["algo.triangles"][0])
    D = W.toarray()
    assert tri.columns == ["triangles"]
    assert tri.rows == [(int(np.trace(D @ D @ D)) // 6,)]
    bfs = texecute(tg, CALLS["algo.bfs"][0])
    lv = csgraph.shortest_path(W, unweighted=True, indices=[0, 9])
    assert bfs.rows == sorted((s, int(v), int(lv[j, v]))
                              for j, s in enumerate([0, 9])
                              for v in np.nonzero(lv[j] <= 2)[0])


def test_call_yield_limit_and_errors_match_jax():
    jg, tg, _ = graphs("ell")
    text = ("CALL algo.pagerank(rel: KNOWS, iters: 40) "
            "YIELD score AS s, node LIMIT 3")
    got, want = texecute(tg, text), jexecute(jg, text)
    assert got.columns == want.columns == ["s", "node"]
    rows_close(got.rows, want.rows, 1e-5)
    for bad, match in (("CALL algo.nosuch()", "no procedure"),
                       ("CALL algo.pagerank(rel: KNOWS, bogus: 3)", "bogus"),
                       ("CALL algo.wcc(rel: KNOWS) YIELD nope", "nope"),
                       ("CALL algo.wcc(rel: KNOWS, sources: [1])",
                        "takes no sources")):
        with pytest.raises(ValueError, match=match):
            jexecute(jg, bad)
        with pytest.raises(ValueError, match=match):
            texecute(tg, bad)


# -- CALL through the server --------------------------------------------------
def _serve_both(fmt, submit):
    """Run the same submissions through both servers: (JAX results, port
    results, JAX qids, port qids, JAX server, port server)."""
    jg, tg, _ = graphs(fmt)
    js, ts = JServer(jg), TServer(tg)
    jq, tq = submit(js), submit(ts)
    jout, tout = js.flush(), ts.flush()
    assert ts.pending == 0
    return jout, tout, jq, tq, js, ts


@pytest.mark.parametrize("fmt", ["bsr", "ell"])
def test_server_call_batched_matches_solo_and_jax(fmt):
    """Seeded closeness CALLs with one signature coalesce into one sweep
    (padded to the lane alignment); each member's slice equals its solo
    answer and the JAX server's; a similarity call of another kind makes
    its own sweep and an unseeded pagerank rides alone."""
    t = "CALL algo.closeness(rel: KNOWS) YIELD node, score"
    seed_sets = [[0], [3, 9], [17], [2, 5, 30]]

    def submit(srv):
        q = [srv.submit(t, seeds=s) for s in seed_sets]
        q.append(srv.submit("CALL algo.similarity(rel: KNOWS, kind: cosine) "
                            "YIELD node1, node2, score", seeds=[1, 4]))
        q.append(srv.submit("CALL algo.pagerank(rel: KNOWS, iters: 30) "
                            "YIELD node, score LIMIT 5"))
        return q

    jout, tout, jq, tq, js, ts = _serve_both(fmt, submit)
    _, tg, _ = graphs(fmt)
    for qid, seeds in zip(tq, seed_sets):
        solo = texecute(tg, f"CALL algo.closeness(rel: KNOWS, sources: "
                            f"{seeds}) YIELD node, score")
        assert tout[qid].error is None and tout[qid].rows == solo.rows
    for a, b, tol in zip(jq, tq, [None] * 4 + [2e-7, 1e-5]):
        assert tout[b].error is None
        rows_close(tout[b].rows, jout[a].rows, tol)
    assert ts.stats["batches"] == js.stats["batches"] == 2
    assert ts.stats["solo"] == js.stats["solo"] == 1
    for key in ("queries", "errors", "batch_width_max", "pack_lanes",
                "pack_slots", "plan_cache_hits", "plan_cache_misses"):
        assert ts.stats[key] == js.stats[key], key


def test_server_call_plan_cache_normalizes_argument_lists():
    variants = [
        "CALL algo.closeness(rel: KNOWS) YIELD node, score",
        "CALL algo.closeness( rel: KNOWS ) YIELD node , score",
        "CALL  algo.closeness(rel:KNOWS)  YIELD node,score",
        "CALL algo . closeness ( rel : KNOWS ) YIELD node, score",
    ]

    def submit(srv):
        return [srv.submit(t, seeds=[i]) for i, t in enumerate(variants)]

    jout, tout, jq, tq, js, ts = _serve_both("bitadj", submit)
    assert ts.stats["plan_cache_misses"] == js.stats["plan_cache_misses"] == 1
    assert ts.stats["batches"] == js.stats["batches"] == 1
    assert [tout[q].rows for q in tq] == [jout[q].rows for q in jq]


def test_server_call_errors_are_per_member_like_jax():
    def submit(srv):
        return [srv.submit("CALL algo.closeness(rel: KNOWS) YIELD node, "
                           "score", seeds=[0]),
                srv.submit("CALL algo.nosuch() YIELD x"),
                srv.submit("CALL algo.pagerank(rel: KNOWS, bogus: 3)"),
                srv.submit("CALL algo.wcc(rel: KNOWS) YIELD nope"),
                srv.submit("CALL algo.wcc(rel: KNOWS, sources: [1])"),
                srv.submit("CALL algo.closeness(rel: NOPE) YIELD node, score",
                           seeds=[2]),
                srv.submit("MATCH (a)-[:KNOWS*1..1]->(b) "
                           "RETURN count(DISTINCT b)", seeds=[1])]

    jout, tout, jq, tq, js, ts = _serve_both("ell", submit)
    for a, b in zip(jq, tq):
        assert tout[b].error == jout[a].error
        assert tout[b].rows == jout[a].rows
    errors = [tout[q].error for q in tq]
    for i, match in ((1, "no procedure"), (2, "bogus"), (3, "nope"),
                     (4, "takes no sources"), (5, "NOPE")):
        assert errors[i] is not None and match in errors[i]
    assert errors[0] is None and errors[6] is None
    assert ts.stats["errors"] == js.stats["errors"] == 5

"""PyTorch port, the GraphChallenge analytics: triangle counting, k-truss
and neighbourhood similarity, held against the JAX package and a numpy
oracle on undirected Graph500 R-MAT graphs (scales 6-8) and named goldens.

Both packages build the same graph from the same edges. Triangle counts,
truss patterns and supports are integers: bit-identical. Similarity scores
are float32 quotients of the same integers: rtol 2e-7 (bit-identical is
expected). The JAX side runs its own dispatch (XLA on the CPU).
"""
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse import csgraph

from repro import algorithms as JA
from repro.core import bitmap as jbitmap
from repro.core import grb as jgrb
from repro.core import semiring as JS
from repro.core.bitadj import BitELL as JBitELL
from repro.core.bsr import BSR as JBSR
from repro.core.ell import ELL as JELL
from repro.graph import datagen as jdatagen
from repro.graph.graph import GraphBuilder as JBuilder
from repro_torch import algorithms as TA
from repro_torch.algorithms.similarity import degrees
from repro_torch.core import bitmap as tbitmap
from repro_torch.core import grb as tgrb, semiring as S
from repro_torch.core.bitadj import BitELL as TBitELL
from repro_torch.core.bsr import BSR as TBSR
from repro_torch.core.ell import ELL as TELL
from repro_torch.graph import graph as tgraph
from repro_torch.graph.graph import GraphBuilder as TBuilder
from repro_torch.kernels import bsr_ewise, bsr_spgemm

SCALES = (6, 7, 8)


def undirected(scale):
    """R-MAT edges, self-loops dropped, both directions (GraphBuilder
    merges duplicates)."""
    src, dst, n = jdatagen.rmat_edges(scale, 16, seed=0)
    keep = src != dst
    s, d = src[keep], dst[keep]
    return np.concatenate([s, d]), np.concatenate([d, s]), n


_graphs = {}


def graphs(scale, fmt):
    """(JAX relation, port relation, dense 0/1 adjacency), cached."""
    key = (scale, fmt)
    if key not in _graphs:
        s, d, n = undirected(scale)
        block = 32 if fmt == "bsr" else 128
        jg = JBuilder(n).add_edges("KNOWS", s, d).build(fmt=fmt, block=block)
        tg = TBuilder(n).add_edges("KNOWS", s, d).build(fmt=fmt, block=block,
                                                        device="cpu")
        D = np.zeros((n, n), np.int64)
        D[s, d] = 1
        _graphs[key] = (jg.relations["KNOWS"], tg.relations["KNOWS"], D)
    return _graphs[key]


def oracle_triangles(D):
    return int(((D @ D) * D).sum() // 6)


def oracle_truss(D, k):
    """Independent numpy peeling loop: the truss's support matrix."""
    A = D.copy()
    np.fill_diagonal(A, 0)
    while True:
        sup = (A @ A) * A
        A2 = ((sup >= k - 2) & (A != 0)).astype(np.int64)
        if (A2 == A).all():
            return sup * A2
        A = A2


def coo_equal(J, T):
    for a, b in zip(J.store.to_coo(), T.store.to_coo()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fmt", ["bsr", "ell", "auto", "bitadj"])
@pytest.mark.parametrize("scale", SCALES)
def test_triangle_count_matches_jax_and_oracle(scale, fmt):
    jr, tr, D = graphs(scale, fmt)
    got = TA.triangle_count(tr)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(JA.triangle_count(jr)) == oracle_triangles(D)


def test_triangle_count_from_adopted_bsr_arrays():
    """``graph.from_arrays`` adopts the JAX build's BSR arrays as they are;
    the count is the same."""
    jr, _, D = graphs(7, "bsr")

    def arrays(store):
        out = {f: np.asarray(getattr(store, f)) for f in (
            "blocks", "block_rows", "block_cols", "first", "last", "valid",
            "row_ptr")}
        out["nnz"] = store.nnz
        return out

    g = tgraph.from_arrays(D.shape[0], {"KNOWS": (arrays(jr.A.store),
                                                  arrays(jr.A.T.store))},
                           device="cpu")
    A = g.relations["KNOWS"].A
    assert A.fmt == "bsr" and A.nvals == jr.A.nvals
    assert int(TA.triangle_count(g, "KNOWS")) == oracle_triangles(D)


@pytest.mark.parametrize("fmt", ["bsr", "ell", "auto"])
@pytest.mark.parametrize("scale", SCALES)
def test_ktruss_matches_jax_and_oracle(scale, fmt):
    jr, tr, D = graphs(scale, fmt)
    for k in (3, 4, 5):
        try:
            J = JA.ktruss(jr, k)
        except Exception as e:            # a handle kind JAX does not take
            with pytest.raises(type(e)):
                TA.ktruss(tr, k)
            continue
        T = TA.ktruss(tr, k)
        assert T.fmt == "bsr" and T.nvals == J.nvals
        coo_equal(J, T)
        want = oracle_truss(D, k)
        assert np.array_equal(T.store.to_dense().numpy().astype(np.int64),
                              want)


def test_ktruss_launches_no_kernel_on_the_cpu():
    _, tr, _ = graphs(6, "bsr")
    before = (bsr_ewise.launches, bsr_spgemm.launches)
    TA.ktruss(tr, 4)
    assert (bsr_ewise.launches, bsr_spgemm.launches) == before


def _sym(edges, n):
    D = np.zeros((n, n), np.float32)
    for i, j in edges:
        D[i, j] = D[j, i] = 1.0
    return D


GOLDENS = [  # (name, edges, n, k, surviving directed edges)
    ("K4_3truss", [(i, j) for i in range(4) for j in range(i + 1, 4)], 4,
     3, 12),
    ("K4_4truss", [(i, j) for i in range(4) for j in range(i + 1, 4)], 4,
     4, 12),
    ("K4_5truss", [(i, j) for i in range(4) for j in range(i + 1, 4)], 4,
     5, 0),
    ("C5_3truss", [(i, (i + 1) % 5) for i in range(5)], 5, 3, 0),
    ("Petersen_3truss", [(i, (i + 1) % 5) for i in range(5)]
     + [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
     + [(i, 5 + i) for i in range(5)], 10, 3, 0),
    ("K33_3truss", [(i, 3 + j) for i in range(3) for j in range(3)], 6, 3, 0),
]


@pytest.mark.parametrize("name,edges,n,k,want", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_ktruss_goldens(name, edges, n, k, want):
    from repro.core.bsr import BSR as JBSR
    D = _sym(edges, n)
    J = JA.ktruss(jgrb.GBMatrix(JBSR.from_dense(D, block=4)), k)
    T = TA.ktruss(tgrb.GBMatrix(TBSR.from_dense(torch.from_numpy(D),
                                                block=4)), k)
    assert T.nvals == J.nvals == want, name
    coo_equal(J, T)


def test_ktruss_drops_self_loops_and_k2_returns_input():
    s, d, n = undirected(6)
    loops = np.arange(0, n, 3)
    tg = TBuilder(n).add_edges("KNOWS", np.concatenate([s, loops]),
                               np.concatenate([d, loops])).build(
                                   fmt="bsr", block=32, device="cpu")
    jg = JBuilder(n).add_edges("KNOWS", np.concatenate([s, loops]),
                               np.concatenate([d, loops])).build(
                                   fmt="bsr", block=32)
    coo_equal(JA.ktruss(jg, 3, rel="KNOWS"), TA.ktruss(tg, 3, rel="KNOWS"))
    A = tg.relations["KNOWS"].A
    assert TA.ktruss(A, 2) is A


def oracle_scores(D, kind, counts):
    deg = D.sum(axis=1).astype(np.float64)
    if kind == "jaccard":
        den = deg[:, None] + deg[None, :] - counts
    elif kind == "cosine":
        den = np.sqrt(deg[:, None] * deg[None, :])
    else:
        den = np.minimum(deg[:, None], deg[None, :])
    return np.where(counts > 0, counts / np.where(counts > 0, den, 1), 0.0)


@pytest.mark.parametrize("fmt", ["bsr", "ell", "auto"])
@pytest.mark.parametrize("kind", ["jaccard", "cosine", "overlap"])
def test_similarity_matrix_matches_jax_and_oracle(kind, fmt):
    jr, tr, D = graphs(7, fmt)
    J = JA.similarity_matrix(jr, kind)
    T = TA.similarity_matrix(tr, kind)
    assert T.fmt == "bsr" and T.nvals == J.nvals
    (jr_, jc, jv), (r, c, v) = J.store.to_coo(), T.store.to_coo()
    assert np.array_equal(jr_, r) and np.array_equal(jc, c)
    np.testing.assert_allclose(v, jv, rtol=2e-7, atol=0)
    want = oracle_scores(D, kind, (D @ D) * D)
    np.testing.assert_allclose(T.store.to_dense().numpy(), want, rtol=2e-7,
                               atol=0)


@pytest.mark.parametrize("fmt", ["bsr", "ell", "auto"])
def test_similarity_matches_jax_and_oracle(fmt):
    jr, tr, D = graphs(8, fmt)
    n = D.shape[0]
    sources = np.random.default_rng(8).choice(n, 24, replace=False)
    deg = degrees(tr)
    assert np.array_equal(deg.numpy(), D.sum(axis=1).astype(np.float32))
    for kind in ("jaccard", "cosine", "overlap"):
        want = np.asarray(JA.similarity(jr, sources, kind))
        got = TA.similarity(tr, sources, kind)
        assert got.shape == (n, len(sources)) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)
        counts = D @ D[:, sources]
        full = oracle_scores(D, kind, D @ D)[:, sources]
        np.testing.assert_allclose(got.numpy(), np.where(counts > 0, full,
                                                         0.0),
                                   rtol=2e-7, atol=0)


def test_similarity_agrees_with_the_matrix_on_stored_pairs():
    _, tr, D = graphs(7, "bsr")
    sources = np.arange(0, D.shape[0], 5)
    cols = TA.similarity(tr, sources, "jaccard").numpy()
    mat = TA.similarity_matrix(tr, "jaccard").store.to_dense().numpy()
    stored = mat[:, sources] != 0
    np.testing.assert_allclose(cols[stored], mat[:, sources][stored],
                               rtol=2e-7, atol=0)


def test_analytics_raise_like_jax():
    jr, tr, _ = graphs(6, "bsr")
    for call in (lambda m: m.similarity_matrix(jr if m is JA else tr, "dice"),
                 lambda m: m.similarity(jr if m is JA else tr, [0], "dice")):
        with pytest.raises(ValueError):
            call(JA)
        with pytest.raises(ValueError, match="unknown similarity kind"):
            call(TA)
    rect_j = jgrb.extract(jr.A, range(60), None)
    rect_t = tgrb.extract(tr.A, range(60), None)
    for fn in ("ktruss", "similarity_matrix"):
        args = (3,) if fn == "ktruss" else ()
        with pytest.raises(ValueError):
            getattr(JA, fn)(rect_j, *args)
        with pytest.raises(ValueError, match="square"):
            getattr(TA, fn)(rect_t, *args)
    # a dense handle: both packages take it (an empty graph here)
    D = torch.zeros((8, 8))
    assert int(TA.triangle_count(D)) == 0
    assert TA.ktruss(D, 3).nvals == TA.similarity_matrix(D).nvals == 0
    assert int(JA.triangle_count(jgrb.GBMatrix(jnp.zeros((8, 8))))) == 0
    # a storage kind the port does not hold still raises
    with pytest.raises(NotImplementedError, match="not ported"):
        TA.triangle_count(torch.zeros(8))


# -- the remaining algorithms: traversal, sssp, pagerank, wcc, centrality,
# label propagation. The named graphs and R-MAT s6-s7 of
# tests/test_algo_suite.py on BSR, ELL and BitELL, each built by the JAX
# package's GraphBuilder and by the port's, and adopted from the JAX
# build's storage arrays (``graph.from_arrays``): the port runs on both.
# Every cell holds the port against scipy / numpy oracles; the R-MAT cells
# also against the JAX package (its hop loops compile per shape, seconds a
# cell, so the named graphs meet it only in tests/test_algo_suite.py).
# Levels, k-hop counts, SSSP distances (integer weights), WCC and label
# propagation labels and closeness are bit-identical to the JAX package;
# pagerank within atol 1e-5, betweenness within 1e-4 (their float32 sums
# are order-sensitive), as the JAX suite holds them.
ZOO = ("K4", "C5", "petersen", "K33", "rmat6", "rmat7")
ALGO_FMTS = ("bsr", "ell", "bitadj")
JAX_PARITY = ("rmat7",)


def _pairs_both(pairs):
    return (np.asarray([a for a, b in pairs] + [b for a, b in pairs]),
            np.asarray([b for a, b in pairs] + [a for a, b in pairs]))


def zoo_edges(name):
    """(n, src, dst): the named graphs undirected, R-MAT directed with
    self-loops dropped (tests/test_algo_suite.py's zoo)."""
    if name == "K4":
        return 4, *_pairs_both([(i, j) for i in range(4)
                                for j in range(i + 1, 4)])
    if name == "C5":
        return 5, *_pairs_both([(i, (i + 1) % 5) for i in range(5)])
    if name == "petersen":
        return 10, *_pairs_both([(i, (i + 1) % 5) for i in range(5)]
                                + [(i, i + 5) for i in range(5)]
                                + [(5 + i, 5 + (i + 2) % 5)
                                   for i in range(5)])
    if name == "K33":
        return 6, *_pairs_both([(i, 3 + j) for i in range(3)
                                for j in range(3)])
    scale = int(name[len("rmat"):])
    src, dst, n = jdatagen.rmat_edges(scale, edge_factor=4, seed=scale)
    keep = src != dst
    return n, src[keep], dst[keep]


def store_arrays(store) -> dict:
    """A JAX storage handle's arrays, as ``graph.from_arrays`` takes them."""
    if hasattr(store, "tiles"):
        return {"tiles": np.asarray(store.tiles),
                "cols": np.asarray(store.cols)}
    if hasattr(store, "blocks"):
        out = {f: np.asarray(getattr(store, f)) for f in (
            "blocks", "block_rows", "block_cols", "first", "last", "valid",
            "row_ptr")}
        if store.emask is not None:
            out["emask"] = np.asarray(store.emask)
        out["nnz"] = store.nnz
        return out
    return {f: np.asarray(getattr(store, f))
            for f in ("indices", "mask", "values")}


_cells = {}


def cell(name, fmt, weighted=False):
    """(JAX handle, [port handle built by its GraphBuilder, port handle
    adopted from the JAX arrays], scipy CSR of the stored entries),
    cached. Weighted cells carry integer weights 0-3 (zeros included);
    BitELL stores none."""
    key = (name, fmt, weighted)
    if key not in _cells:
        n, src, dst = zoo_edges(name)
        w = (np.random.default_rng(n).integers(0, 4, size=len(src))
             .astype(np.float32) if weighted else None)
        block = min(32, n)
        jg = JBuilder(n).add_edges("R", src, dst, w).build(fmt=fmt,
                                                           block=block)
        tg = TBuilder(n).add_edges("R", src, dst, w).build(
            fmt=fmt, block=block, device="cpu")
        jA = jg.relations["R"].A
        adopted = tgraph.from_arrays(
            n, {"R": (store_arrays(jA.store), store_arrays(jA.T.store))},
            device="cpu")
        # duplicates combine as GraphBuilder combines them: the first
        _, first = np.unique(src * n + dst, return_index=True)
        vals = np.ones(len(first)) if w is None else w[first]
        W = sp.csr_matrix((vals, (src[first], dst[first])), shape=(n, n))
        _cells[key] = (jA, [tg.relations["R"].A,
                            adopted.relations["R"].A], W)
    return _cells[key]


def sample_sources(n):
    return list(range(n)) if n <= 16 else list(range(0, n, max(1, n // 24)))


def oracle_levels(W, sources):
    """(n, F) hop levels by scipy's unweighted shortest paths."""
    return csgraph.shortest_path(W, unweighted=True,
                                 indices=list(sources)).T


def oracle_pagerank(W, alpha=0.85, iters=50):
    """float64 power iteration with the same dangling rule."""
    n = W.shape[0]
    deg = np.asarray(W.sum(axis=1)).ravel()
    dangling = deg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.maximum(deg, 1e-30))
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = (1 - alpha) / n + alpha * (W.T @ (r * inv) + r[dangling].sum()
                                       / n)
    return r


def oracle_wcc(W):
    _, comp = csgraph.connected_components(W, directed=True,
                                           connection="weak")
    first = np.full(comp.max() + 1, W.shape[0])
    np.minimum.at(first, comp, np.arange(W.shape[0]))
    return first[comp]


def oracle_brandes(W, sources):
    """Per-source BFS path counts, reversed dependency sums (directed,
    unit edges, endpoints excluded)."""
    n = W.shape[0]
    adj = [W.indices[W.indptr[v]:W.indptr[v + 1]] for v in range(n)]
    bc = np.zeros(n)
    for s in sources:
        sigma = np.zeros(n)
        sigma[s] = 1.0
        dist = np.full(n, -1)
        dist[s] = 0
        order, q = [], deque([s])
        while q:
            v = q.popleft()
            order.append(v)
            for u in adj[v]:
                if dist[u] < 0:
                    dist[u] = dist[v] + 1
                    q.append(u)
                if dist[u] == dist[v] + 1:
                    sigma[u] += sigma[v]
        delta = np.zeros(n)
        for v in reversed(order):
            for u in adj[v]:
                if dist[u] == dist[v] + 1:
                    delta[v] += sigma[v] / sigma[u] * (1.0 + delta[u])
            if v != s:
                bc[v] += delta[v]
    return bc


def oracle_closeness(W, sources):
    lv = oracle_levels(W, sources)
    n = W.shape[0]
    fin = np.isfinite(lv)
    r = fin.sum(axis=0)
    tot = np.where(fin, lv, 0.0).sum(axis=0)
    return np.where(tot > 0, (r - 1.0) ** 2 / ((n - 1) * np.where(
        tot > 0, tot, 1.0)), 0.0)


def oracle_labelprop(W, max_iter=50):
    """Synchronous CDLP: votes over out- and in-edges (a mutual edge votes
    twice) plus the vertex's own, the smallest of the top labels."""
    n = W.shape[0]
    C = W.tocoo()
    tgt = np.concatenate([C.row, C.col, np.arange(n)])
    voter = np.concatenate([C.col, C.row, np.arange(n)])
    labels = np.arange(n)
    for _ in range(max_iter):
        key, cnt = np.unique(tgt * n + labels[voter], return_counts=True)
        v, lab = key // n, key % n
        # each vertex's first row after the sort: its top count's smallest
        # label (every vertex votes for itself, so each has a row)
        order = np.lexsort((lab, -cnt, v))
        _, first = np.unique(v[order], return_index=True)
        new = lab[order][first]
        if np.array_equal(new, labels):
            break
        labels = new
    return labels.astype(np.int32)


@pytest.mark.parametrize("fmt", ALGO_FMTS)
@pytest.mark.parametrize("name", ZOO)
def test_traversal_matches_jax_and_oracle(name, fmt):
    jA, ports, W = cell(name, fmt)
    src = sample_sources(W.shape[0])
    want = oracle_levels(W, src).astype(np.float32)
    hop1 = np.where(want <= 1, want, np.inf)[:, :3]
    if name in JAX_PARITY:
        assert np.array_equal(np.asarray(JA.bfs_levels(jA, src)), want)
        assert np.array_equal(np.asarray(JA.khop_counts(jA, src, 2)),
                              ((want >= 1) & (want <= 2)).sum(axis=0))
        assert np.array_equal(
            np.asarray(JA.bfs_levels(jA, src[:3], max_iter=1)), hop1)
    for T in ports:
        got = TA.bfs_levels(T, src)
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(),
                                                             want)
        k = TA.khop_counts(T, src, 2)
        assert k.dtype == torch.int32 and np.array_equal(
            k.numpy(), ((want >= 1) & (want <= 2)).sum(axis=0))
        assert np.array_equal(TA.bfs_levels(T, src[:3], max_iter=1).numpy(),
                              hop1)


@pytest.mark.parametrize("fmt", ALGO_FMTS)
@pytest.mark.parametrize("name", ZOO)
def test_sssp_matches_jax_and_oracle(name, fmt):
    jA, ports, W = cell(name, fmt, weighted=fmt != "bitadj")
    src = sample_sources(W.shape[0])[:8]
    want = csgraph.dijkstra(W, indices=src).T.astype(np.float32)
    if name in JAX_PARITY:
        assert np.array_equal(np.asarray(JA.sssp(jA, jnp.asarray(src))),
                              want)
    for T in ports:
        got = TA.sssp(T, src)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", ALGO_FMTS)
@pytest.mark.parametrize("name", ZOO)
def test_pagerank_wcc_labelprop_match_jax_and_oracle(name, fmt):
    jA, ports, W = cell(name, fmt)
    pr, comp, lp = oracle_pagerank(W), oracle_wcc(W), oracle_labelprop(W)
    jp = None
    if name in JAX_PARITY:
        jp = np.asarray(JA.pagerank(jA))
        np.testing.assert_allclose(jp, pr, atol=1e-5)
        assert np.array_equal(np.asarray(JA.wcc(jA)), comp)
        assert np.array_equal(np.asarray(JA.label_propagation(jA)), lp)
    for T in ports:
        got = TA.pagerank(T)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), pr, atol=1e-5, rtol=0)
        if jp is not None:
            np.testing.assert_allclose(got.numpy(), jp, atol=1e-5, rtol=0)
        w = TA.wcc(T)
        assert w.dtype == torch.int32 and np.array_equal(w.numpy(), comp)
        lab = TA.label_propagation(T)
        assert lab.dtype == torch.int32 and np.array_equal(lab.numpy(), lp)


@pytest.mark.parametrize("fmt", ALGO_FMTS)
@pytest.mark.parametrize("name", ZOO)
def test_centrality_matches_jax_and_oracle(name, fmt):
    jA, ports, W = cell(name, fmt)
    src = sample_sources(W.shape[0])
    bc, cl = oracle_brandes(W, src), oracle_closeness(W, src)
    jc = jparts = None
    if name in JAX_PARITY:
        np.testing.assert_allclose(np.asarray(JA.betweenness(jA, sources=src)),
                                   bc, atol=1e-4, rtol=1e-4)
        jc = np.asarray(JA.closeness(jA, sources=src))
        np.testing.assert_allclose(jc, cl, atol=1e-6)
        jparts = np.asarray(JA.brandes_parts(jA, src[:5]))
    for T in ports:
        b = TA.betweenness(T, sources=src, batch=8)
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), bc, atol=1e-4, rtol=1e-4)
        c = TA.closeness(T, sources=src, batch=8)
        assert c.dtype == torch.float32
        np.testing.assert_allclose(c.numpy(), cl, atol=1e-6)
        parts = TA.brandes_parts(T, src[:5])
        np.testing.assert_allclose(parts.numpy().sum(axis=1),
                                   oracle_brandes(W, src[:5]), atol=1e-4,
                                   rtol=1e-4)
        if jc is not None:
            assert np.array_equal(c.numpy(), jc)
            np.testing.assert_allclose(parts.numpy(), jparts, atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("fmt", ALGO_FMTS)
def test_zero_edge_goldens(fmt):
    """An edgeless graph: every algorithm answers from first principles,
    as the JAX package's short-circuits do."""
    n = 7
    e = np.zeros(0, dtype=np.int64)
    if fmt == "bsr":
        jh = jgrb.GBMatrix(JBSR.from_coo(e, e, np.zeros(0, np.float32),
                                         (n, n), block=7))
        th = TBSR.from_coo(e, e, None, (n, n), block=7, device="cpu")
    elif fmt == "ell":
        jh = jgrb.GBMatrix(JELL.from_coo(e, e, np.zeros(0, np.float32),
                                         (n, n)))
        th = TELL.from_coo(e, e, None, (n, n), device="cpu")
    else:
        jh = jgrb.GBMatrix(JBitELL.from_coo(e, e, None, (n, n)))
        th = TBitELL.from_coo(e, e, None, (n, n), device="cpu")
    lv = np.full((n, 1), np.inf, dtype=np.float32)
    lv[3, 0] = 0.0
    goldens = [
        (TA.wcc(th), np.arange(n), JA.wcc(jh)),
        (TA.bfs_levels(th, [3]), lv, JA.bfs_levels(jh, [3])),
        (TA.khop_counts(th, [0, 3], 2), np.zeros(2),
         JA.khop_counts(jh, [0, 3], 2)),
        (TA.betweenness(th), np.zeros(n), JA.betweenness(jh)),
        (TA.closeness(th), np.zeros(n), JA.closeness(jh)),
        (TA.label_propagation(th), np.arange(n), JA.label_propagation(jh)),
        (TA.sssp(th, [2])[:, 0], np.where(np.arange(n) == 2, 0.0, np.inf),
         JA.sssp(jh, jnp.asarray([2]))[:, 0]),
        (TA.pagerank(th), np.full(n, 1.0 / n), JA.pagerank(jh)),
    ]
    for got, want, jax_out in goldens:
        assert got.dtype == torch.from_numpy(np.asarray(jax_out)).dtype
        assert np.array_equal(got.numpy(), np.asarray(jax_out))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert TA.brandes_parts(th, []).shape == (n, 0)


def _zero_weight_chain(fmt):
    """0 --(0.0)--> 1 --(1.0)--> 2: the first hop is free but real."""
    r, c = np.array([0, 1]), np.array([1, 2])
    v = np.array([0.0, 1.0], np.float32)
    if fmt == "bsr":
        return (jgrb.GBMatrix.from_coo(r, c, v, (3, 3), fmt="bsr", block=2),
                TBSR.from_coo(r, c, v, (3, 3), block=2, device="cpu"))
    return (jgrb.GBMatrix.from_coo(r, c, v, (3, 3), fmt="ell"),
            TELL.from_coo(r, c, v, (3, 3), device="cpu"))


@pytest.mark.parametrize("fmt", ["bsr", "ell"])
def test_sssp_zero_weight_golden(fmt):
    jh, th = _zero_weight_chain(fmt)
    if fmt == "bsr":
        assert th.emask is not None
    got = TA.sssp(th, [0])[:, 0].numpy()
    assert np.array_equal(got, [0.0, 0.0, 1.0])
    assert np.array_equal(got, np.asarray(JA.sssp(jh, jnp.asarray([0])))[:, 0])
    for srname in ("min_plus", "max_plus"):
        x = np.array([[0.0], [10.0], [20.0]], np.float32)
        want = np.asarray(jgrb.mxm(jh, jnp.asarray(x), JS.get(srname),
                                   jgrb.TRANSPOSE_A))
        got = tgrb.mxm(th, torch.from_numpy(x), S.get(srname),
                       tgrb.TRANSPOSE_A).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("fmt", ALGO_FMTS)
def test_mxv_vxm_match_jax(fmt, monkeypatch):
    """A width-1 product is ``mxm`` at F = 1; on BSR it reaches
    ``kernels.ops.bsr_mxm`` (the entry kernel's plain version here)."""
    from repro_torch.kernels import ops as tkops
    jA, (T, _), W = cell("rmat6", fmt)
    n = W.shape[0]
    x = np.random.default_rng(3).integers(0, 4, size=n).astype(np.float32)
    calls = []
    real = tkops.bsr_mxm

    def counted(A, X, sr, **kw):
        calls.append(tuple(X.shape))
        return real(A, X, sr, **kw)

    monkeypatch.setattr(tkops, "bsr_mxm", counted)
    for srname in ("plus_times", "min_plus", "or_and"):
        sr_t, sr_j = S.get(srname), JS.get(srname)
        for t_fn, j_fn, d_t, d_j in (
                (tgrb.mxv, jgrb.mxv, tgrb.NULL, jgrb.NULL),
                (tgrb.mxv, jgrb.mxv, tgrb.TRANSPOSE_A, jgrb.TRANSPOSE_A)):
            got = t_fn(T, torch.from_numpy(x), sr_t, d_t)
            assert got.shape == (n,)
            assert np.array_equal(got.numpy(), np.asarray(
                j_fn(jA, jnp.asarray(x), sr_j, d_j)))
        got = tgrb.vxm(torch.from_numpy(x), T, sr_t)
        assert np.array_equal(got.numpy(), np.asarray(
            jgrb.vxm(jnp.asarray(x), jA, sr_j)))
    assert (fmt == "bsr") == bool(calls)
    assert all(shape == (n, 1) for shape in calls)


def test_reduce_or_columns_matches_jax():
    rng = np.random.default_rng(5)
    for n, f in ((1, 1), (70, 33), (300, 64), (5, 100)):
        x = (rng.random((n, f)) < 0.3).astype(np.float32)
        tw = tbitmap.pack(torch.from_numpy(x))
        got = tbitmap.reduce_or_columns(tw, f)
        want = np.asarray(jbitmap.reduce_or_columns(
            jbitmap.pack(jnp.asarray(x)), f))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(),
                                                             want)
        assert np.array_equal(got.numpy(), x.sum(axis=0))


def test_algorithms_export_the_jax_all():
    assert sorted(TA.__all__) == sorted(JA.__all__)
    assert all(callable(getattr(TA, name)) for name in TA.__all__)


@pytest.mark.parametrize("chunk_words", [32, 1 << 24])
def test_bitell_stored_reductions_in_chunks_match_jax(chunk_words,
                                                      monkeypatch):
    """BitELL's stored-entry reductions (WCC's isolated-vertex test) count
    a chunk of panels at a time; any chunking gives the JAX package's
    counts."""
    from repro_torch.core import bitadj as tbitadj
    monkeypatch.setattr(tbitadj, "_CHUNK_WORDS", chunk_words)
    jA, (T, _), _ = cell("rmat7", "bitadj")
    for monoid_t, monoid_j in ((S.PLUS, JS.PLUS), (S.OR, JS.OR)):
        for axis in (None, 0, 1):
            got = tgrb.reduce(T, monoid_t, axis=axis)
            want = np.asarray(jgrb.reduce(jA, monoid_j, axis=axis))
            assert np.array_equal(got.numpy(), want), (monoid_t.name, axis)

"""PyTorch port, the GraphChallenge analytics: triangle counting, k-truss
and neighbourhood similarity, held against the JAX package and a numpy
oracle on undirected Graph500 R-MAT graphs (scales 6-8) and named goldens.

Both packages build the same graph from the same edges. Triangle counts,
truss patterns and supports are integers: bit-identical. Similarity scores
are float32 quotients of the same integers: rtol 2e-7 (bit-identical is
expected). The JAX side runs its own dispatch (XLA on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algorithms as JA
from repro.core import grb as jgrb
from repro.graph import datagen as jdatagen
from repro.graph.graph import GraphBuilder as JBuilder
from repro_torch import algorithms as TA
from repro_torch.algorithms.similarity import degrees
from repro_torch.core import grb as tgrb
from repro_torch.core.bsr import BSR as TBSR
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
    # a dense handle: the JAX package takes it; the port has no dense
    # storage handles yet
    D = torch.zeros((8, 8))
    for call in (lambda: TA.ktruss(D, 3), lambda: TA.triangle_count(D),
                 lambda: TA.similarity_matrix(D)):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()
    assert int(JA.triangle_count(jgrb.GBMatrix(jnp.zeros((8, 8))))) == 0

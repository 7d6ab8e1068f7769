"""The plain references against brute force on small R-MAT graphs, and the
bfloat16 rounding the control uses."""
import itertools

import numpy as np
import pytest

from bench import data
from bench.reference import graph, khop, pagerank, precision, triangles


def _rmat(scale, directed, seed=0):
    cfg = {"generator": {"kind": "rmat", "edge_factor": 8, "seed": seed,
                         "a": 0.57, "b": 0.19, "c": 0.19},
           "scale": scale, "directed": directed, "storage": {}}
    e = data.make_graph(cfg, np.random.default_rng(seed + 1))
    return e, graph.simple_csr(e.src, e.dst, e.n)


def _bfs_count(adj, s, hops):
    dist = {s: 0}
    frontier = [s]
    for h in range(1, hops + 1):
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v not in dist:
                    dist[v] = h
                    nxt.append(v)
        frontier = nxt
    return sum(1 for v, d in dist.items() if 1 <= d <= hops)


@pytest.mark.parametrize("scale,hops", [(6, 1), (6, 2), (7, 3), (7, 6)])
def test_khop_counts_match_bfs(scale, hops):
    e, A = _rmat(scale, True, seed=scale)
    adj = [[] for _ in range(e.n)]
    for s, d in zip(e.src, e.dst):
        adj[s].append(d)
    starts = np.unique(e.src)[:40]
    got = khop.khop_counts(A, starts, hops, block=16)
    assert list(got) == [_bfs_count(adj, int(s), hops) for s in starts]


@pytest.mark.parametrize("scale", [5, 6, 7])
def test_triangle_count_matches_brute_force(scale):
    e, A = _rmat(scale, False, seed=scale)
    D = A.toarray() > 0
    np.fill_diagonal(D, False)
    want = sum(1 for i, j, k in itertools.combinations(range(e.n), 3)
               if D[i, j] and D[j, k] and D[i, k])
    assert triangles.triangle_count(A, rows=7) == want


@pytest.mark.parametrize("scale", [5, 7])
def test_pagerank_matches_dense_power_iteration(scale):
    e, A = _rmat(scale, True, seed=scale)
    D = A.toarray()
    n = e.n
    out = D.sum(axis=1)
    r = np.full(n, 1.0 / n)
    for _ in range(30):
        y = np.zeros(n)
        for u in range(n):
            if out[u]:
                y += D[u] * r[u] / out[u]
        r = 0.15 / n + 0.85 * (y + r[out == 0].sum() / n)
    got = pagerank.pagerank(A, 0.85, 30)
    np.testing.assert_allclose(got, r, rtol=1e-12, atol=1e-15)
    assert abs(got.sum() - 1.0) < 1e-12


def test_bfloat16_rounds_to_eight_significant_bits():
    x = np.array([1.0, 255.0, 256.0, 257.0, 258.0, 259.0, 1000.0, -3.0])
    got = precision.bfloat16(x)
    assert list(got) == [1.0, 255.0, 256.0, 256.0, 258.0, 260.0, 1000.0,
                         -3.0]
    assert precision.exact(x) is x

"""PyTorch port, the masked dot-product SpGEMM and the entry-held BSR handle
on the CPU (no JAX): the dot route (``core.bsr.spgemm_dot``, its plain
version here) against the tile route (``core.bsr.spgemm``) in the four
SpGEMM modes, the triangle count on both routes against a plain dense
torch count (``torch_plain_reference``), ``grb.reduce`` on entry-held
handles, the route rule (``core.grb.dot_route_ok``) and the build's
refusal of an unknown storage kind.

Inputs are the Graph Challenge's undirected Graph500 R-MAT (loops dropped,
both directions, ids permuted) at scales 8-12, and an empty mask, a
single-row matrix and a hub row. Weights are multiples of 0.5 in [-1, 2],
so every sum is exact and the routes agree bit for bit in every mode. The
CUDA kernel itself is tested on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import algorithms as TA
from repro_torch.core import bsr as tbsr
from repro_torch.core import grb as tgrb
from repro_torch.core import semiring as TS
from repro_torch.core.bsr import BSR
from repro_torch.graph import datagen, graph as tgraph
from repro_torch.graph.graph import GraphBuilder
from torch_plain_reference import triangle_count_dense

ARRAYS = ("block_rows", "block_cols", "first", "last", "valid", "row_ptr")
SR_NAMES = ["plus_times", "or_and", "plus_pair", "plus_first"]
WEIGHTS = [-1.0, 0.5, 1.0, 1.5, 2.0]


def challenge_edges(scale, seed=0):
    """(src, dst, n): the undirected R-MAT edge list, both directions,
    repeats kept (GraphBuilder merges them), ids permuted."""
    src, dst, n = datagen.rmat_edges(scale, 16, seed=seed)
    keep = src != dst
    perm = np.random.default_rng(scale + seed).permutation(n)
    return (perm[np.concatenate([src[keep], dst[keep]])],
            perm[np.concatenate([dst[keep], src[keep]])], n)


def _entries(case):
    """(rows, cols, values, mask rows, mask cols, n, block)."""
    rng = np.random.default_rng(7)
    if isinstance(case, tuple):
        scale, block = case
        s, d, n = challenge_edges(scale)
        key = np.unique(s * n + d)
        r, c = key // n, key % n
        return r, c, rng.choice(WEIGHTS, len(r)), r, c, n, block
    n = 600
    if case == "empty_mask":
        r, c = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
        z = np.zeros(0, np.int64)
        return r, c, rng.choice(WEIGHTS, len(r)), z, z, n, 128
    if case == "single_row":
        r = np.full(200, 9)
        c = rng.permutation(n)[:200]
        return r, c, rng.choice(WEIGHTS, 200), r, c, n, 32
    # hub_row: row 0 reaches every column, far past a unit's 128 elements
    r = np.concatenate([np.zeros(n, np.int64), rng.integers(0, n, 4000)])
    c = np.concatenate([rng.permutation(n), rng.integers(0, n, 4000)])
    mr = np.concatenate([np.zeros(300, np.int64), rng.integers(0, n, 2000)])
    mc = rng.integers(0, n, len(mr))
    return r, c, rng.choice(WEIGHTS, len(r)), mr, mc, n, 128


@pytest.mark.parametrize("srname", SR_NAMES)
@pytest.mark.parametrize("case", [(8, 128), (10, 32), (11, 128),
                                  "empty_mask", "single_row", "hub_row"])
def test_dot_route_equals_the_tile_route(case, srname):
    """``C<M> = A (x) A^T``'s handle on the dot route equals the tile
    route's: tile list, nnz and tiles (built from the held entries) bit
    for bit; the dot route builds no tile on the way."""
    r, c, v, mr, mc, n, block = _entries(case)
    sr = TS.get(srname)
    A = BSR.from_coo(r, c, v, (n, n), block=block, device="cpu")
    At = A.transpose()
    M = BSR.from_coo(mr, mc, None, (n, n), block=block, device="cpu")
    t0, d0 = tbsr.tile_builds(), tbsr.dot_entries
    got = tbsr.spgemm_dot(A, At, sr, M, Bt=A)
    assert tbsr.tile_builds() == t0 and not got.holds_tiles
    assert tbsr.dot_entries - d0 == M.row_csr().entries
    want = tbsr.spgemm(A, At, sr, mask=M)
    assert got.nnz == want.nnz
    for f in ARRAYS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.blocks.view(torch.int32),
                       want.blocks.view(torch.int32))


@pytest.mark.parametrize("route,scale", [("dot", 8), ("dot", 10),
                                         ("dot", 12), ("tile", 8),
                                         ("tile", 10)])
def test_triangle_count_equals_the_plain_torch_count(route, scale,
                                                     monkeypatch):
    """``triangle_count`` on an entry-held BSR graph, forced onto each
    route, equals the dense plain-torch count; the dot route builds no
    tile."""
    monkeypatch.setattr(tgrb, "DOT_MAX_FILL", 1.01 if route == "dot" else 0.0)
    s, d, n = challenge_edges(scale)
    g = GraphBuilder(n).add_edges("KNOWS", s, d).build(fmt="bsr",
                                                       device="cpu")
    t0, d0 = tbsr.tile_builds(), tbsr.dot_entries
    got = int(TA.triangle_count(g.relation("KNOWS").A))
    assert got == triangle_count_dense(s, d, n) > 0
    took_dot = tbsr.dot_entries > d0
    assert took_dot == (route == "dot")
    if took_dot:
        assert tbsr.tile_builds() == t0


@pytest.mark.parametrize("monoid", ["plus", "or"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reduce_of_an_entry_held_handle_builds_no_tile(monoid, axis):
    """``grb.reduce`` (plus, or; whole, by column, by row) of an entry-held
    handle sums its entries in float64, builds no tile, and equals the
    reduce of the same handle once its tiles are built."""
    r, c, v, _, _, n, block = _entries((9, 32))
    A = BSR.from_coo(r, c, v, (n, n), block=block, device="cpu")
    C = tbsr.spgemm_dot(A, A, TS.PLUS_TIMES, A)      # a computed one too
    for X in (A, C):
        mono = getattr(TS, monoid.upper())
        t0 = tbsr.tile_builds()
        got = tgrb.reduce(tgrb.GBMatrix(X), mono, axis=axis,
                          dtype=torch.float64)
        assert tbsr.tile_builds() == t0 and not X.holds_tiles
        X.blocks
        want = tgrb.reduce(tgrb.GBMatrix(X), mono, axis=axis,
                           dtype=torch.float64)
        assert torch.equal(got, want)


def test_route_rule_picks_the_routes_it_documents():
    """Under a structural, not complemented, mask, operands under
    ``DOT_MAX_FILL`` with finite read values take the dot route; no mask,
    a complemented mask, a fill at or over the limit, or a non-finite
    value a valued mode reads keep the tile route. ``grb.mxm`` follows
    the rule."""
    s, d, n = challenge_edges(11)
    key = np.unique(s * n + d)
    r, c = key // n, key % n
    sparse = BSR.from_coo(r, c, None, (n, n), block=128, device="cpu")
    assert tbsr.stored_fill(sparse) < tgrb.DOT_MAX_FILL
    full = BSR.from_coo(*np.nonzero(np.ones((40, 40))), None, (40, 40),
                        block=32, device="cpu")
    assert tbsr.stored_fill(full) >= tgrb.DOT_MAX_FILL
    v = np.ones(len(r))
    v[0] = np.inf
    inf = BSR.from_coo(r, c, v, (n, n), block=128, device="cpu")
    ok = tgrb.dot_route_ok
    P, T, F = TS.PLUS_PAIR, TS.PLUS_TIMES, TS.PLUS_FIRST
    assert ok(sparse, sparse, P, sparse, False)
    assert ok(sparse, sparse, T, sparse, False)
    assert not ok(sparse, sparse, P, None, False)
    assert not ok(sparse, sparse, P, sparse, True)
    assert not ok(full, full, P, full, False)
    assert ok(inf, sparse, P, sparse, False)       # pair reads no value
    assert not ok(inf, sparse, T, sparse, False)
    assert not ok(inf, sparse, F, sparse, False)
    assert ok(sparse, inf, F, sparse, False)       # first reads A's only
    assert not ok(sparse, inf, T, sparse, False)
    for A, M, comp, dot in ((sparse, sparse, False, True),
                            (sparse, sparse, True, False),
                            (full, full, False, False)):
        d0, p0 = tbsr.dot_entries, tbsr.plan_tasks
        tgrb.mxm(tgrb.GBMatrix(A), tgrb.GBMatrix(A), P,
                 tgrb.Descriptor(mask=tgrb.GBMatrix(M), complement=comp))
        assert (tbsr.dot_entries > d0) == dot
        assert (tbsr.plan_tasks > p0) == (not dot)


@pytest.mark.parametrize("fmt", ["csr", "coo", "BSR", "sharded"])
def test_unknown_storage_fmt_is_refused_at_once(fmt):
    """A build names its storage kind; one it does not make raises
    ValueError naming the kinds it makes, before any storage is built
    (``auto`` and ``None`` let ``core.ops.auto_format`` pick)."""
    b = GraphBuilder(4).add_edges("R", [0, 1], [1, 2])
    with pytest.raises(ValueError, match="bsr, ell, bitadj"):
        b.build(fmt=fmt, device="cpu")
    with pytest.raises(ValueError, match=repr(fmt)):
        tgraph._make(np.array([0]), np.array([1]), np.ones(1, np.float32),
                     4, fmt, 128, torch.device("cpu"))
    for ok in ("auto", None):
        assert tgraph._make(np.array([0]), np.array([1]),
                            np.ones(1, np.float32), 4, ok, 128,
                            torch.device("cpu")) is not None

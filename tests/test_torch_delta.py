"""PyTorch port, delta storage (``repro_torch.core.delta`` and the delta
dispatch of ``repro_torch.core.grb``), held against the JAX package.

Both packages wrap the same frozen base (dense, BSR or ELL, built from one
numpy matrix) and apply the same CREATE / DELETE op stream. The
DeltaMatrix state (pending sets, nnz, ``to_coo``, the patch's arrays and
scatter rows, the compacted base) is equal array for array; the ``grb``
grid on delta handles is bit for bit for or_and / min_plus / plus_pair,
reductions and the element-wise family, and within 1e-5 for plus_times
(summation order). The five algorithms on a delta handle equal their run
on the rebuilt matrix bit for bit (pagerank within 1e-5), and the JAX
package's on the same handle. The JAX side runs on the CPU through its
own dispatch (BSR through XLA); the port with ``device="cpu"``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algorithms as JA
from repro.core import grb as jgrb, semiring as JS
from repro.core.delta import DeltaMatrix as JDelta
from repro.core.delta import needs_compaction as j_needs
from repro.graph.datagen import rmat_edges
from repro_torch import algorithms as TA
from repro_torch.core import delta as tdelta
from repro_torch.core import grb as tgrb, semiring as TS
from repro_torch.core.delta import DeltaMatrix as TDelta
from repro_torch.graph import graph as tgraph

FMTS = ["dense", "bsr", "ell"]
BLOCK = 32


def dense_of(name: str) -> np.ndarray:
    """The named graphs of the JAX delta suite, as 0/1 float32 matrices."""
    if name == "K4":
        return np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32)
    if name == "C5":
        D = np.zeros((5, 5), np.float32)
        D[np.arange(5), (np.arange(5) + 1) % 5] = 1.0
        return D
    if name == "Petersen":
        outer = [(i, (i + 1) % 5) for i in range(5)]
        spokes = [(i, i + 5) for i in range(5)]
        inner = [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
        D = np.zeros((10, 10), np.float32)
        for a, b in outer + spokes + inner:
            D[a, b] = D[b, a] = 1.0
        return D
    scale = int(name.split("_s")[1])
    src, dst, n = rmat_edges(scale, edge_factor=8, seed=scale)
    keep = src != dst
    D = np.zeros((n, n), np.float32)
    D[src[keep], dst[keep]] = 1.0
    return D


def stream(D: np.ndarray, seed: int = 0, frac: float = 0.15):
    """A seeded op stream: ~frac * nnz deletions of stored entries, each
    followed by one insertion of a pair absent at that point."""
    rng = np.random.default_rng(seed)
    n = D.shape[0]
    W = D.copy()
    er, ec = np.nonzero(D)
    k = max(2, int(frac * len(er)))
    ops = []
    for i in rng.choice(len(er), size=min(k, len(er)), replace=False):
        ops.append(("del", int(er[i]), int(ec[i]), 0.0))
        W[er[i], ec[i]] = 0.0
        while True:
            a, b = rng.integers(0, n, size=2)
            if a != b and W[a, b] == 0:
                break
        ops.append(("add", int(a), int(b), 1.0))
        W[a, b] = 1.0
    return ops


def apply_dense(D: np.ndarray, ops) -> np.ndarray:
    out = D.copy()
    for kind, i, j, w in ops:
        out[i, j] = w if kind == "add" else 0.0
    return out


def j_base(D, fmt):
    return jgrb.GBMatrix.from_dense(D, fmt=fmt, block=BLOCK).store


def t_base(D, fmt):
    return tgrb.GBMatrix.from_dense(D, fmt=fmt, block=BLOCK,
                                    device="cpu").store


def handles(D, ops, fmt):
    """(JAX, port) delta handles over a frozen ``fmt`` base of D with
    ``ops`` pending and the transpose twin kept with swapped ops, as
    ``engine.MutableGraph`` serves them."""
    swapped = [(k, j, i, w) for k, i, j, w in ops]
    out = []
    for G, base, Delta in ((jgrb, j_base, JDelta), (tgrb, t_base, TDelta)):
        h = G.GBMatrix(Delta.wrap(base(D, fmt)).apply_ops(ops), name="A")
        h.link_transpose(G.GBMatrix(Delta.wrap(base(D.T, fmt)).apply_ops(
            swapped), name="A^T"))
        out.append(h)
    return out


def oracles(E, fmt):
    """(JAX, port) handles built fresh from the effective matrix E."""
    j = jgrb.GBMatrix.from_dense(E, fmt=fmt, block=BLOCK)
    j.link_transpose(jgrb.GBMatrix.from_dense(E.T, fmt=fmt, block=BLOCK))
    t = tgrb.GBMatrix.from_dense(E, fmt=fmt, block=BLOCK, device="cpu")
    t.link_transpose(tgrb.GBMatrix.from_dense(E.T, fmt=fmt, block=BLOCK,
                                              device="cpu"))
    return j, t


def host(x):
    if isinstance(x, tgrb.GBMatrix):
        return x.to_dense().numpy()
    if isinstance(x, jgrb.GBMatrix):
        return np.asarray(x.to_dense())
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def same_state(jd, td):
    for f in ("plus_r", "plus_c", "plus_v", "minus_r", "minus_c"):
        a, b = getattr(jd, f), getattr(td, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert td.shape == jd.shape and td.nnz == jd.nnz
    assert td.pending == jd.pending and td.fmt == jd.fmt


def same_store(js, ts):
    """Storage arrays equal (dense, ELL or BSR)."""
    if isinstance(ts, torch.Tensor):
        assert np.array_equal(np.asarray(js), ts.numpy())
        return
    names = (("indices", "mask", "values") if hasattr(ts, "indices") else
             ("blocks", "block_rows", "block_cols", "first", "last", "valid",
              "row_ptr"))
    for f in names:
        assert np.array_equal(np.asarray(getattr(js, f)),
                              getattr(ts, f).numpy()), f
    assert js.nnz == ts.nnz and tuple(js.shape) == tuple(ts.shape)


# -- DeltaMatrix unit behaviour ------------------------------------------------
@pytest.mark.parametrize("fmt", FMTS)
def test_wrap_and_effective_algebra(fmt):
    D = dense_of("Petersen")
    jd, td = JDelta.wrap(j_base(D, fmt)), TDelta.wrap(t_base(D, fmt))
    assert td.nnz == jd.nnz == int((D != 0).sum()) and td.pending == 0
    ops = [("del", 0, 1, 0.0), ("add", 0, 3, 2.0), ("add", 1, 1, 1.0)]
    jd2, td2 = jd.apply_ops(ops), td.apply_ops(ops)
    same_state(jd2, td2)
    E = apply_dense(D, ops)
    assert np.array_equal(td2.to_dense().numpy(), E)
    assert np.array_equal(td.to_dense().numpy(), D)     # functional
    assert td2.index is td.index                       # the base's, shared


@pytest.mark.parametrize("fmt", FMTS)
def test_invariants_zero_add_readd_missing_delete(fmt):
    D = dense_of("C5")
    jd, td = JDelta.wrap(j_base(D, fmt)), TDelta.wrap(t_base(D, fmt))
    for ops in ([("add", 0, 1, 0.0)],                    # add of 0 deletes
                [("del", 3, 3, 0.0)],                    # absent: no-op
                [("del", 0, 1, 0.0), ("add", 0, 1, 5.0)],  # later wins
                [("add", 2, 0, 4.0), ("del", 2, 0, 0.0)],  # plus dropped
                [("del", 0, 1, 0.0), ("add", 0, 1, 0.0)]):
        jd2, td2 = jd.apply_ops(ops), td.apply_ops(ops)
        same_state(jd2, td2)
        assert np.array_equal(td2.to_dense().numpy(),
                              np.asarray(jd2.to_dense()))
        assert len(np.intersect1d(td2.plus_r * 5 + td2.plus_c,
                                  td2.minus_r * 5 + td2.minus_c)) == 0
    assert td.apply_ops([("add", 0, 1, 0.0)]).nnz == td.nnz - 1


@pytest.mark.parametrize("fmt", FMTS)
def test_growth_and_bounds(fmt):
    D = dense_of("K4")
    jd, td = JDelta.wrap(j_base(D, fmt)), TDelta.wrap(t_base(D, fmt))
    ops = [("add", 6, 2, 1.0), ("add", 1, 5, 3.0)]
    jb, tb = jd.apply_ops(ops, grow_to=(7, 7)), td.apply_ops(ops,
                                                             grow_to=(7, 7))
    same_state(jb, tb)
    assert tb.to_dense()[6, 2] == 1.0 and tb.nnz == td.nnz + 2
    for bad in (lambda d: d.apply_ops([("add", 9, 0, 1.0)]),
                lambda d: d.apply_ops([("del", 0, -1, 0.0)])):
        with pytest.raises(ValueError):
            bad(jd)
        with pytest.raises(ValueError, match="out of bounds"):
            bad(td)
    with pytest.raises(ValueError, match="never shrink"):
        tb.resize((4, 4))
    with pytest.raises(ValueError, match="never shrink"):
        TDelta.wrap(t_base(D, fmt), (3, 3))
    # a grown handle's products pad the base's rows with the identity
    B = np.random.default_rng(0).random((7, 5)).astype(np.float32)
    for jsr, tsr in ((JS.MIN_PLUS, TS.MIN_PLUS), (JS.OR_AND, TS.OR_AND)):
        want = np.asarray(jgrb.mxm(jgrb.GBMatrix(jb), jnp.asarray(B), jsr))
        got = tgrb.mxm(tgrb.GBMatrix(tb), torch.from_numpy(B), tsr).numpy()
        assert np.array_equal(got, want), tsr.name


@pytest.mark.parametrize("fmt", FMTS)
def test_to_coo_transpose_compact(fmt):
    D = dense_of("rmat_s6")
    ops = stream(D, seed=1)
    jd = JDelta.wrap(j_base(D, fmt)).apply_ops(ops)
    td = TDelta.wrap(t_base(D, fmt)).apply_ops(ops)
    same_state(jd, td)
    for a, b in zip(jd.to_coo(), td.to_coo()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    E = apply_dense(D, ops)
    assert np.array_equal(td.transpose().to_dense().numpy(), E.T)
    same_state(jd.transpose(), td.transpose())
    jf, tf = jd.compact(), td.compact()
    assert tf.pending == 0 and tf.nnz == jf.nnz == td.nnz
    assert tf.fmt == fmt
    same_store(jf.base, tf.base)


@pytest.mark.parametrize("fmt", FMTS)
def test_folds_are_not_kept_on_the_handle(fmt):
    """``materialize`` folds anew at each call, equal to the JAX fold, and
    the handle keeps no fold after the routes that take one (the
    element-wise family, triangles, k-truss): a served view would hold a
    second copy of its relation for as long as it is served."""
    import gc
    import weakref
    D = dense_of("rmat_s6")
    ops = stream(D, seed=5)
    jh, th = handles(D, ops, fmt)
    td = th.store
    first, second = td.materialize(), td.materialize()
    assert first is not second
    same_store(jh.store.materialize(), first)
    gone = weakref.ref(first)
    del first, second
    gc.collect()
    assert gone() is None
    tgrb.ewise_add(th, th, TS.PLUS)
    TA.triangle_count(th)
    TA.ktruss(th, 3)
    held = [k for k, v in vars(td).items()
            if isinstance(v, (torch.Tensor, tgrb.BSR, tgrb.ELL))
            and v is not td.base]
    assert held == []


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("gname", ["Petersen", "rmat_s6"])
def test_patch_arrays_and_scatter_rows(gname, fmt):
    D = dense_of(gname)
    ops = stream(D, seed=4)
    jd = JDelta.wrap(j_base(D, fmt)).apply_ops(ops)
    td = TDelta.wrap(t_base(D, fmt)).apply_ops(ops)
    (jp, jrows), (tp, trows) = jd.patch(), td.patch()
    same_store(jp, tp)
    assert np.array_equal(np.asarray(jrows), trows.numpy())
    assert trows.dtype == torch.int32
    t = td.touched
    assert t == len(td.touched_rows())
    assert (trows[t:] == D.shape[0]).all() and (trows[:t] < D.shape[0]).all()
    assert tp.device == trows.device == td.device
    # no pending delta: no patch
    assert TDelta.wrap(t_base(D, fmt)).patch() == (None, None)


@pytest.mark.parametrize("fmt", FMTS)
def test_compaction_policy_threshold(fmt):
    D = dense_of("Petersen")
    jd, td = JDelta.wrap(j_base(D, fmt)), TDelta.wrap(t_base(D, fmt))
    assert not tdelta.needs_compaction(td)
    assert tdelta.AUTO_DELTA_COMPACT == 0.05
    k = int(tdelta.AUTO_DELTA_COMPACT * td.base_nnz) + 1
    for m in (1, k, 2 * k):
        ops = [("add", i % 10, (i * 7 + 3) % 10, 1.0) for i in range(m)]
        jd2, td2 = jd.apply_ops(ops), td.apply_ops(ops)
        assert tdelta.needs_compaction(td2) == j_needs(jd2), m
        assert not tdelta.needs_compaction(td2.compact())


@pytest.mark.parametrize("fmt", FMTS)
def test_one_host_copy_per_base_not_per_write(fmt):
    """The base's entry index crosses to the host once, whatever the
    number of write batches and composed views over it."""
    D = dense_of("rmat_s6")
    dm = TDelta.wrap(t_base(D, fmt))
    before = tgrb.host_transfers()
    for i, op in enumerate(stream(D, seed=9)):
        dm = dm.apply_ops([op], grow_to=(64 + i // 50, 64 + i // 50))
        dm.patch()
        assert dm.nnz >= 0
    assert tgrb.host_transfers() - before == 1


def test_bitell_base_wraps_as_ell():
    D = dense_of("rmat_s6")
    b = tgrb.GBMatrix.from_dense(D, fmt="bitadj", device="cpu").store
    dm = TDelta.wrap(b)
    assert dm.fmt == "ell" and dm.nnz == int((D != 0).sum())
    assert np.array_equal(dm.to_dense().numpy(), D)
    with pytest.raises(TypeError, match="DeltaMatrix base"):
        TDelta.wrap(np.zeros((3, 3), np.float32))


# -- the grb grid on delta handles ----------------------------------------------
SRS = ["or_and", "min_plus", "plus_pair", "plus_times"]


def _mxm_same(got, want, srname):
    if srname == "plus_times":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert np.array_equal(got, want), srname


@pytest.fixture(scope="module")
def grid():
    """Per fmt: (JAX delta, port delta, JAX oracle, port oracle, E, B)."""
    D = dense_of("rmat_s6")
    ops = stream(D, seed=2)
    E = apply_dense(D, ops)
    B = np.random.default_rng(3).random((D.shape[0], 9)).astype(np.float32)
    out = {}
    for fmt in FMTS:
        jh, th = handles(D, ops, fmt)
        jo, to = oracles(E, fmt)
        out[fmt] = (jh, th, jo, to, E, B)
    return out


@pytest.mark.parametrize("srname", SRS)
@pytest.mark.parametrize("fmt", FMTS)
def test_delta_mxm_matches_jax_and_rebuild(grid, fmt, srname):
    jh, th, jo, to, E, B = grid[fmt]
    assert th.fmt == "delta" and th.nvals == jh.nvals == int((E != 0).sum())
    jsr, tsr = JS.get(srname), TS.get(srname)
    Bj, Bt = jnp.asarray(B), torch.from_numpy(B)
    for d_j, d_t in ((jgrb.NULL, tgrb.NULL),
                     (jgrb.TRANSPOSE_A, tgrb.TRANSPOSE_A)):
        got = tgrb.mxm(th, Bt, tsr, d_t).numpy()
        _mxm_same(got, np.asarray(jgrb.mxm(jh, Bj, jsr, d_j)), srname)
        _mxm_same(got, tgrb.mxm(to, Bt, tsr, d_t).numpy(), srname)


@pytest.mark.parametrize("fmt", FMTS)
def test_delta_masked_accum_mxv_vxm(grid, fmt):
    jh, th, jo, to, E, B = grid[fmt]
    rng = np.random.default_rng(5)
    M = (rng.random(B.shape) < 0.5).astype(np.float32)
    Bj, Bt = jnp.asarray(B), torch.from_numpy(B)
    for comp in (False, True):
        dj = jgrb.Descriptor(mask=jnp.asarray(M), accum=JS.PLUS,
                             complement=comp)
        dt = tgrb.Descriptor(mask=torch.from_numpy(M), accum=TS.PLUS,
                             complement=comp)
        got = tgrb.mxm(th, Bt, TS.OR_AND, dt, out=Bt).numpy()
        assert np.array_equal(got, np.asarray(
            jgrb.mxm(jh, Bj, JS.OR_AND, dj, out=Bj)))
        # a pure masked write
        dt = tgrb.Descriptor(mask=torch.from_numpy(M), complement=comp)
        dj = jgrb.Descriptor(mask=jnp.asarray(M), complement=comp)
        assert np.array_equal(tgrb.mxm(th, Bt, TS.MIN_PLUS, dt).numpy(),
                              np.asarray(jgrb.mxm(jh, Bj, JS.MIN_PLUS, dj)))
    x = rng.random(E.shape[0]).astype(np.float32)
    for fn in ("mxv", "vxm"):
        args_t = (th, torch.from_numpy(x)) if fn == "mxv" else \
            (torch.from_numpy(x), th)
        args_j = (jh, jnp.asarray(x)) if fn == "mxv" else (jnp.asarray(x), jh)
        got = getattr(tgrb, fn)(*args_t, TS.PLUS_TIMES).numpy()
        np.testing.assert_allclose(
            got, np.asarray(getattr(jgrb, fn)(*args_j, JS.PLUS_TIMES)),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("monoid", ["plus", "or", "min", "max"])
@pytest.mark.parametrize("fmt", FMTS)
def test_delta_reduce_matches_jax(grid, fmt, monoid):
    jh, th, jo, to, E, B = grid[fmt]
    jm = {"plus": JS.PLUS, "or": JS.OR, "min": JS.MIN, "max": JS.MAX}[monoid]
    tm = {"plus": TS.PLUS, "or": TS.OR, "min": TS.MIN, "max": TS.MAX}[monoid]
    for ax in (None, 0, 1):
        got = tgrb.reduce(th, tm, axis=ax).numpy()
        assert np.array_equal(got, np.asarray(jgrb.reduce(jh, jm, axis=ax))), \
            ax
        assert np.array_equal(got, tgrb.reduce(to, tm, axis=ax).numpy()), ax
    # a bare DeltaMatrix reduces too (axis 0 then takes the materialization)
    assert np.array_equal(tgrb.reduce(th.store, tm, axis=0).numpy(),
                          tgrb.reduce(to, tm, axis=0).numpy())


@pytest.mark.parametrize("fmt", FMTS)
def test_delta_ewise_extract_assign_match_jax(grid, fmt):
    jh, th, jo, to, E, B = grid[fmt]
    jo_ = jgrb.GBMatrix.from_dense(E * 0.5, fmt=fmt, block=BLOCK)
    to_ = tgrb.GBMatrix.from_dense(E * 0.5, fmt=fmt, block=BLOCK,
                                   device="cpu")
    if fmt == "dense":
        # the dense family takes raw arrays / tensors
        jo_, to_ = jo_.store, to_.store
    cases = [
        (lambda G, S, h, o: G.ewise_add(h, o, S.PLUS)),
        (lambda G, S, h, o: G.ewise_mult(h, o, S.MIN)),
        (lambda G, S, h, o: G.extract(h, rows=np.arange(8),
                                      cols=np.arange(8))),
        (lambda G, S, h, o: G.extract(h, rows=[3, 1, 40], cols=None)),
        (lambda G, S, h, o: G.assign(h, G.extract(h, rows=np.arange(4),
                                                  cols=np.arange(4)),
                                     rows=np.arange(10, 14),
                                     cols=np.arange(20, 24))),
    ]
    if fmt == "dense":
        # raw dense operands meet only dense partners
        cases = cases[2:4]
    for case in cases:
        got = host(case(tgrb, TS, th, to_))
        assert np.array_equal(got, host(case(jgrb, JS, jh, jo_)))
        assert np.array_equal(got, host(case(tgrb, TS, to, to_)))
    sel = TS.ewise("gt", 0.5)
    got = host(tgrb.select(sel, th))
    assert np.array_equal(got, host(jgrb.select(lambda v: v > 0.5, jh)))
    assert np.array_equal(got, host(tgrb.select(sel, to)))


@pytest.mark.parametrize("fmt", FMTS)
def test_delta_mask_matches_jax(grid, fmt):
    """A delta handle as a descriptor mask (the triangles shape), and as a
    mask of a dense-frontier product."""
    jh, th, jo, to, E, B = grid[fmt]
    got = host(tgrb.mxm(th, th, TS.PLUS_PAIR, tgrb.Descriptor(mask=th)))
    want = host(jgrb.mxm(jh, jh, JS.PLUS_PAIR, jgrb.Descriptor(mask=jh)))
    assert np.array_equal(got, want)
    Bt = torch.from_numpy(np.ascontiguousarray(E.T))    # an (n, n) frontier
    got = tgrb.mxm(to, Bt, TS.PLUS_PAIR,
                   tgrb.Descriptor(mask=th, complement=True)).numpy()
    want = tgrb.mxm(to, Bt, TS.PLUS_PAIR,
                    tgrb.Descriptor(mask=torch.from_numpy(E),
                                    complement=True)).numpy()
    assert np.array_equal(got, want)


def test_delta_words_detour_equals_compacted(grid):
    jh, th, jo, to, E, B = grid["ell"]
    words = torch.from_numpy(np.random.default_rng(6).integers(
        -2 ** 31, 2 ** 31 - 1, size=(E.shape[0], 2), dtype=np.int64).astype(
            np.int32))
    assert not tgrb.words_route_ok(th, 64)
    for t in (False, True):
        assert torch.equal(tgrb.mxm_words(th, words, transpose_a=t),
                           tgrb.mxm_words(to, words, transpose_a=t))


# -- the five algorithms on delta handles ---------------------------------------
GRAPHS = ["K4", "C5", "Petersen", "rmat_s6"]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("gname", GRAPHS)
def test_algorithms_delta_vs_rebuild(gname, fmt):
    D = dense_of(gname)
    ops = stream(D, seed=sum(map(ord, gname)))
    E = apply_dense(D, ops)
    _, th = handles(D, ops, fmt)
    _, to = oracles(E, fmt)
    seeds = np.arange(min(8, D.shape[0]))
    assert torch.equal(TA.bfs_levels(th, seeds), TA.bfs_levels(to, seeds))
    assert torch.equal(TA.sssp(th, seeds), TA.sssp(to, seeds))
    assert torch.equal(TA.wcc(th), TA.wcc(to))
    assert int(TA.triangle_count(th)) == int(TA.triangle_count(to))
    np.testing.assert_allclose(TA.pagerank(th, iters=20).numpy(),
                               TA.pagerank(to, iters=20).numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("gname", ["Petersen", "rmat_s6"])
def test_algorithms_on_delta_match_jax(gname, fmt):
    D = dense_of(gname)
    ops = stream(D, seed=sum(map(ord, gname)))
    jh, th = handles(D, ops, fmt)
    seeds = np.arange(8)
    assert np.array_equal(TA.bfs_levels(th, seeds).numpy(),
                          np.asarray(JA.bfs_levels(jh, seeds)))
    assert np.array_equal(TA.sssp(th, seeds).numpy(),
                          np.asarray(JA.sssp(jh, seeds)))
    assert np.array_equal(TA.wcc(th).numpy(), np.asarray(JA.wcc(jh)))
    assert int(TA.triangle_count(th)) == int(JA.triangle_count(jh))
    np.testing.assert_allclose(TA.pagerank(th, iters=20).numpy(),
                               np.asarray(JA.pagerank(jh, iters=20)),
                               atol=1e-5, rtol=0)


def test_ktruss_and_similarity_on_delta():
    D = dense_of("Petersen")
    ops = [("del", 0, 1, 0.0), ("del", 1, 0, 0.0), ("add", 0, 2, 1.0),
           ("add", 2, 0, 1.0)]
    E = apply_dense(D, ops)
    for fmt in ("bsr", "ell"):
        _, th = handles(D, ops, fmt)
        _, to = oracles(E, fmt)
        assert np.array_equal(host(TA.ktruss(th, 3)), host(TA.ktruss(to, 3)))
        assert np.array_equal(host(TA.similarity_matrix(th)),
                              host(TA.similarity_matrix(to)))


# -- adopting a JAX delta handle's arrays (graph.from_arrays) -------------------
def _arrays(jstore):
    if isinstance(jstore, JDelta):
        out = _arrays(jstore.base)
        if not isinstance(out, dict):
            out = {"dense": out}
        out.update({f: np.asarray(getattr(jstore, f)) for f in (
            "plus_r", "plus_c", "plus_v", "minus_r", "minus_c")})
        out["base_shape"] = tuple(jstore.base.shape)
        return out
    if hasattr(jstore, "indices"):
        return {f: np.asarray(getattr(jstore, f))
                for f in ("indices", "mask", "values")}
    if hasattr(jstore, "blocks"):
        out = {f: np.asarray(getattr(jstore, f)) for f in (
            "blocks", "block_rows", "block_cols", "first", "last", "valid",
            "row_ptr")}
        out["nnz"] = jstore.nnz
        return out
    return np.asarray(jstore)


@pytest.mark.parametrize("fmt", FMTS)
def test_from_arrays_adopts_a_jax_delta_relation(fmt):
    D = dense_of("rmat_s6")
    ops = stream(D, seed=7) + [("add", 70, 3, 1.0)]
    n = 72                                        # grown past the base
    jh = jgrb.GBMatrix(JDelta.wrap(j_base(D, fmt)).apply_ops(
        ops, grow_to=(n, n)))
    jt = jgrb.GBMatrix(JDelta.wrap(j_base(D.T, fmt)).apply_ops(
        [(k, j, i, w) for k, i, j, w in ops], grow_to=(n, n)))
    g = tgraph.from_arrays(n, {"R": (_arrays(jh.store), _arrays(jt.store))},
                           device="cpu")
    th = g.relations["R"].A
    assert th.fmt == "delta" and th.store.fmt == fmt
    same_state(jh.store, th.store)
    B = np.random.default_rng(8).random((n, 5)).astype(np.float32)
    for d_j, d_t in ((jgrb.NULL, tgrb.NULL),
                     (jgrb.TRANSPOSE_A, tgrb.TRANSPOSE_A)):
        jh.link_transpose(jt)
        assert np.array_equal(
            tgrb.mxm(th, torch.from_numpy(B), TS.MIN_PLUS, d_t).numpy(),
            np.asarray(jgrb.mxm(jh, jnp.asarray(B), JS.MIN_PLUS, d_j)))

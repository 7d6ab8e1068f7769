"""PyTorch port, dense handles: ``GBMatrix`` over a 2-D tensor, the dense
routes of ``grb`` (semiring products, the packed or_and product,
reductions), the dense branches of the algorithms, ``fmt="dense"`` graph
builds, and the legacy ``core.ops`` / ``kernels.ref`` surface, held
against the JAX package on the CPU.

Both packages hold the same numpy matrix. Or_and / min_plus / max_plus /
plus_pair / plus_first products, packed words, or / min / max reductions,
component labels and truss patterns are bit for bit; plus_times and plus
sums within 1e-5 (summation order); similarity scores within 2e-7
relative (float32 quotients of equal integers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algorithms as JA
from repro.core import bitmap as jbitmap
from repro.core import grb as jgrb, ops as jops, semiring as JS
from repro.graph.datagen import rmat_edges
from repro.kernels import ref as jref
from repro_torch import algorithms as TA
from repro_torch.core import bitmap as tbitmap
from repro_torch.core import grb as tgrb, ops as tops, semiring as TS
from repro_torch.core.bsr import BSR as TBSR
from repro_torch.graph import graph as tgraph
from repro_torch.graph.graph import GraphBuilder
from repro_torch.kernels import ref as tref

SEMIRINGS = ["plus_times", "or_and", "plus_pair", "min_plus", "max_plus",
             "plus_first"]


def rmat_dense(scale, undirected=False, weighted=False):
    src, dst, n = rmat_edges(scale, edge_factor=8, seed=scale)
    keep = src != dst
    s, d = src[keep], dst[keep]
    if undirected:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
    D = np.zeros((n, n), np.float32)
    D[s, d] = 1.0
    if weighted:
        w = np.random.default_rng(scale).integers(1, 4, size=D.shape)
        D = D * w.astype(np.float32)
    return D


def pair(D):
    j = jgrb.GBMatrix(jnp.asarray(D))
    t = tgrb.GBMatrix.from_dense(D, device="cpu")
    return j, t


def host(x):
    if isinstance(x, tgrb.GBMatrix):
        return x.to_dense().numpy()
    if isinstance(x, jgrb.GBMatrix):
        return np.asarray(x.to_dense())
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


# -- the handle -----------------------------------------------------------------
def test_dense_handle_surface():
    D = rmat_dense(6, weighted=True)
    jh, th = pair(D)
    assert th.fmt == "dense" and th.shape == (64, 64)
    assert th.nvals == jh.nvals == int((D != 0).sum())
    assert th.device == torch.device("cpu")        # forwarded to the store
    assert th.T.fmt == "dense" and th.T.T is th
    assert np.array_equal(th.T.to_dense().numpy(), D.T)
    assert th.T.store.is_contiguous()
    r, c = np.nonzero(D)
    for fmt in ("dense", "bsr", "ell"):
        a = tgrb.GBMatrix.from_coo(r, c, D[r, c], D.shape, fmt=fmt,
                                   device="cpu")
        b = jgrb.GBMatrix.from_coo(r, c, D[r, c], D.shape, fmt=fmt)
        assert a.fmt == b.fmt == fmt
        assert np.array_equal(host(a), np.asarray(b.to_dense()))
        c_ = tgrb.GBMatrix.from_dense(torch.from_numpy(D), fmt=fmt)
        assert c_.fmt == fmt and np.array_equal(host(c_), D)
    ones = tgrb.GBMatrix.from_coo([0, 1], [1, 0], None, (2, 2), fmt="dense",
                                  device="cpu")
    assert ones.to_dense().tolist() == [[0.0, 1.0], [1.0, 0.0]]
    with pytest.raises(NotImplementedError, match="not ported"):
        tgrb.GBMatrix(torch.zeros(4))
    with pytest.raises(AttributeError):
        th._missing


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_dense_mxm_matches_jax(srname):
    D = rmat_dense(6, weighted=True)
    jh, th = pair(D)
    rng = np.random.default_rng(1)
    B = rng.integers(0, 3, size=(64, 40)).astype(np.float32)
    M = (rng.random(B.shape) < 0.5).astype(np.float32)
    jsr, tsr = JS.get(srname), TS.get(srname)
    cases = [
        (jgrb.NULL, tgrb.NULL, None),
        (jgrb.TRANSPOSE_A, tgrb.TRANSPOSE_A, None),
        (jgrb.Descriptor(mask=jnp.asarray(M)),
         tgrb.Descriptor(mask=torch.from_numpy(M)), None),
        (jgrb.Descriptor(mask=jnp.asarray(M), complement=True,
                         accum=JS.MIN),
         tgrb.Descriptor(mask=torch.from_numpy(M), complement=True,
                         accum=TS.MIN), B),
    ]
    for dj, dt, out in cases:
        want = np.asarray(jgrb.mxm(jh, jnp.asarray(B), jsr, dj,
                                   out=None if out is None
                                   else jnp.asarray(out)))
        got = tgrb.mxm(th, torch.from_numpy(B), tsr, dt,
                       out=None if out is None
                       else torch.from_numpy(out)).numpy()
        if srname == "plus_times":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            assert np.array_equal(got, want)
    # a dense handle as B, and as a mask
    got = tgrb.mxm(th, th, tsr, tgrb.Descriptor(mask=th))
    want = jgrb.mxm(jh, jh, jsr, jgrb.Descriptor(mask=jh))
    np.testing.assert_allclose(host(got), host(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("F", [1, 8, 40, 64])
def test_dense_packed_route_and_words_match_jax(F):
    D = rmat_dense(6)
    jh, th = pair(D)
    B = (np.random.default_rng(F).random((64, F)) < 0.1).astype(np.float32)
    got = tgrb.mxm(th, torch.from_numpy(B), TS.OR_AND).numpy()
    assert np.array_equal(got, np.asarray(jgrb.mxm(jh, jnp.asarray(B),
                                                   JS.OR_AND)))
    assert tgrb.words_route_ok(th, F) == jgrb.words_route_ok(jh, F)
    Bw = jbitmap.pack(jnp.asarray(B))
    Tw = tbitmap.pack(torch.from_numpy(B))
    assert np.array_equal(np.asarray(Bw).view(np.int32), Tw.numpy())
    for t in (False, True):
        want = np.asarray(jgrb.mxm_words(jh, Bw, transpose_a=t))
        got = tgrb.mxm_words(th, Tw, transpose_a=t).numpy()
        assert np.array_equal(got.view(np.uint32), want)


def test_dense_mxm_packed_chunks():
    D = rmat_dense(7)
    words = torch.from_numpy(np.random.default_rng(2).integers(
        -2 ** 31, 2 ** 31 - 1, size=(D.shape[0], 3), dtype=np.int64).astype(
            np.int32))
    A = torch.from_numpy(D)
    whole = tops.dense_mxm_packed(A, words, k_chunk=D.shape[0])
    want = np.asarray(jops.dense_mxm_packed(
        jnp.asarray(D), jnp.asarray(words.numpy().view(np.uint32))))
    assert np.array_equal(whole.numpy().view(np.uint32), want)
    calls = tbitmap.pack_calls()
    for k in (1, 7, 32):
        assert torch.equal(tops.dense_mxm_packed(A, words, k_chunk=k), whole)
    assert tbitmap.pack_calls() == calls       # no policy pack counted


@pytest.mark.parametrize("monoid", ["plus", "or", "min", "max"])
def test_dense_reduce_matches_jax(monoid):
    D = rmat_dense(6, weighted=True) - 0.5 * rmat_dense(6)
    jh, th = pair(D)
    for ax in (None, 0, 1):
        got = tgrb.reduce(th, TS.__dict__[monoid.upper()], axis=ax).numpy()
        want = np.asarray(jgrb.reduce(jh, JS.__dict__[monoid.upper()],
                                      axis=ax))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        if monoid != "plus":
            assert np.array_equal(got, want)


# -- the algorithms' dense branches ---------------------------------------------
@pytest.mark.parametrize("scale", [6, 7])
def test_wcc_on_dense_matches_jax(scale):
    D = rmat_dense(scale)
    D[:, 5] = 0.0                                # an isolated vertex or two
    D[5, :] = 0.0
    jh, th = pair(D)
    got = TA.wcc(th)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(JA.wcc(jh)))
    e = tgrb.GBMatrix.from_dense(D, fmt="ell", device="cpu")
    assert torch.equal(got, TA.wcc(e))


@pytest.mark.parametrize("kind", ["jaccard", "cosine", "overlap"])
def test_similarity_matrix_on_dense_matches_jax(kind):
    D = rmat_dense(6, undirected=True)
    jh, th = pair(D)
    got = TA.similarity_matrix(th, kind)
    assert got.fmt == "dense"
    np.testing.assert_allclose(host(got), host(JA.similarity_matrix(jh, kind)),
                               rtol=2e-7, atol=0)
    b = TA.similarity_matrix(tgrb.GBMatrix.from_dense(D, fmt="bsr",
                                                      device="cpu"), kind)
    np.testing.assert_allclose(host(got), host(b), rtol=2e-7, atol=0)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_ktruss_and_triangles_on_dense_match_jax(k):
    D = rmat_dense(6, undirected=True)
    np.fill_diagonal(D, 1.0)                      # self-loops are dropped
    jh, th = pair(D)
    T = TA.ktruss(th, k)
    assert T.fmt == "dense"
    assert np.array_equal(host(T), host(JA.ktruss(jh, k)))
    b = TA.ktruss(tgrb.GBMatrix.from_dense(D, fmt="bsr", device="cpu"), k)
    assert np.array_equal(host(T), host(b))
    np.fill_diagonal(D, 0.0)
    jh, th = pair(D)
    assert int(TA.triangle_count(th)) == int(JA.triangle_count(jh))


# -- graphs with dense relations -------------------------------------------------
def test_dense_graph_build_and_adopted_arrays():
    D = rmat_dense(6, weighted=True)
    r, c = np.nonzero(D)
    g = GraphBuilder(64).add_edges("R", r, c, D[r, c]).build(fmt="dense",
                                                            device="cpu")
    A = g.relations["R"].A
    assert A.fmt == "dense" and A.T.fmt == "dense"
    assert np.array_equal(A.to_dense().numpy(), D)
    assert np.array_equal(A.T.to_dense().numpy(), D.T)
    assert g.adj.A.fmt == "dense" and g.adj.nnz == len(r)
    g2 = tgraph.from_arrays(64, {"R": (D, D.T.copy())}, device="cpu")
    assert g2.relations["R"].A.fmt == "dense"
    seeds = np.arange(4)
    assert torch.equal(TA.sssp(g2.relations["R"], seeds),
                       TA.sssp(g.relations["R"], seeds))
    want = np.asarray(JA.sssp(jgrb.GBMatrix(jnp.asarray(D)), seeds))
    assert np.array_equal(TA.sssp(g.relations["R"], seeds).numpy(), want)


# -- the legacy op surface and the densify oracle -------------------------------
def test_legacy_ops_surface_matches_jax():
    D = rmat_dense(6, weighted=True)
    rng = np.random.default_rng(4)
    X = rng.random((64, 5)).astype(np.float32)
    x = rng.random(64).astype(np.float32)
    m = (rng.random(64) < 0.5).astype(np.float32)
    A = torch.from_numpy(D)
    e = tgrb.GBMatrix.from_dense(D, fmt="ell", device="cpu").store
    for store in (A, e):
        got = tops.mxm(store, torch.from_numpy(X), TS.MIN_PLUS).numpy()
        assert np.array_equal(got, np.asarray(jops.mxm(
            jnp.asarray(D), jnp.asarray(X), JS.MIN_PLUS)))
        got = tops.mxv(store, torch.from_numpy(x), TS.PLUS_TIMES,
                       mask=torch.from_numpy(m), complement=True).numpy()
        want = np.asarray(jops.mxv(jnp.asarray(D), jnp.asarray(x),
                                   JS.PLUS_TIMES, mask=jnp.asarray(m),
                                   complement=True))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        got = tops.vxm(torch.from_numpy(x), store, TS.PLUS_TIMES).numpy()
        want = np.asarray(jops.vxm(jnp.asarray(x), jnp.asarray(D),
                                   JS.PLUS_TIMES))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    res = torch.from_numpy(X)
    old = torch.from_numpy(X[::-1].copy())
    M = torch.from_numpy((X > 0.5).astype(np.float32))
    got = tops.apply_mask(res, M, True, TS.PLUS, old, 0.0).numpy()
    want = np.asarray(jops.apply_mask(jnp.asarray(X), jnp.asarray(M.numpy()),
                                      True, JS.PLUS,
                                      jnp.asarray(old.numpy()), 0.0))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("srname", ["plus_times", "min_plus", "or_and"])
def test_bsr_mxm_ref_matches_jax(srname):
    from repro.core.bsr import BSR as JBSR
    D = rmat_dense(6, weighted=True)
    r, c = np.nonzero(D)
    X = np.random.default_rng(5).integers(0, 4, (64, 6)).astype(np.float32)
    M = (X > 1).astype(np.float32)
    jb = JBSR.from_coo(r, c, D[r, c], D.shape, block=16)
    tb = TBSR.from_coo(r, c, D[r, c], D.shape, block=16, device="cpu")
    for mask in (None, M):
        want = np.asarray(jref.bsr_mxm_ref(
            jb, jnp.asarray(X), JS.get(srname),
            mask=None if mask is None else jnp.asarray(mask)))
        got = tref.bsr_mxm_ref(tb, torch.from_numpy(X), TS.get(srname),
                               mask=None if mask is None
                               else torch.from_numpy(mask)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("f", [1, 8, 31, 32, 33, 512])
def test_payload_accounting_matches_jax(f):
    for packed in (False, True):
        assert tbitmap.payload_bytes(100, f, packed) == \
            jbitmap.payload_bytes(100, f, packed)
    assert tbitmap.payload_reduction(f) == jbitmap.payload_reduction(f)

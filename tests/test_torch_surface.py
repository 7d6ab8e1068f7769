"""PyTorch port, the rest of the grb surface: ``semiring.ANY_PAIR``,
``grb.desc``, ``grb.packed_frontiers``, ``mxm`` with a sparse B other
than BSR x BSR, ``ELL.from_dense``, ``BitELL.from_ell`` / ``from_dense``
/ ``to_dense`` / ``payload_bytes`` and the BSR counters
``densify_calls`` / ``host_numeric_calls``, on the CPU.

Every product is held bit for bit against the JAX package on the same
inputs (0/1 frontiers and small integer weights keep every sum exact in
float32), on dense, ELL, BSR, BitELL and delta handles. The route a call
takes shows in ``core.bitmap.pack_calls()`` (the packed route packs its
frontier at the call boundary; CPU tensors take the kernels' plain
versions, which count no launch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsr as jbsr
from repro.core import grb as jgrb
from repro.core import semiring as JS
from repro.core.bitadj import BitELL as JBitELL
from repro.core.delta import DeltaMatrix as JDelta
from repro.core.ell import ELL as JELL
from repro.graph.datagen import rmat_edges
from repro_torch.algorithms import ktruss
from repro_torch.core import bitmap as tbitmap
from repro_torch.core import bsr as tbsr
from repro_torch.core import grb as tgrb
from repro_torch.core import semiring as S
from repro_torch.core.bitadj import BitELL as TBitELL
from repro_torch.core.delta import DeltaMatrix as TDelta
from repro_torch.core.ell import ELL as TELL
from repro_torch.distr.mesh import Mesh

CPU = torch.device("cpu")
F = 40                  # past the packing floor, not a multiple of 32
BLOCK = 32
FMTS = ("dense", "ell", "bsr", "bitadj", "delta")
GRAPHS = ("k4", "c5", "petersen", "rmat_s6", "rmat_s7")


def _undirected(n, edges):
    D = np.zeros((n, n), np.float32)
    for a, b in edges:
        D[a, b] = D[b, a] = 1.0
    return D


def dense_of(name: str) -> np.ndarray:
    """The JAX bitmap / BitELL suites' graph zoo, and the 3-cycle."""
    if name == "c3":
        D = np.zeros((3, 3), np.float32)
        D[[0, 1, 2], [1, 2, 0]] = 1.0
        return D
    if name == "k4":
        return 1.0 - np.eye(4, dtype=np.float32)
    if name == "c5":
        return _undirected(5, [(i, (i + 1) % 5) for i in range(5)])
    if name == "petersen":
        return _undirected(10, [(i, (i + 1) % 5) for i in range(5)]
                           + [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
                           + [(i, 5 + i) for i in range(5)])
    scale = int(name.split("_s")[1])
    src, dst, n = rmat_edges(scale, edge_factor=8, seed=scale)
    D = np.zeros((n, n), np.float32)
    D[src, dst] = 1.0
    return D


def frontier(n, f, seed, p=0.2):
    return (np.random.default_rng(seed).random((n, f)) < p).astype(
        np.float32)


def delta_ops(D, seed=0):
    """Two deletions of stored entries and two insertions of absent
    pairs."""
    rng = np.random.default_rng(seed)
    er, ec = np.nonzero(D)
    dels = rng.choice(len(er), size=min(2, len(er)), replace=False)
    ops = [("del", int(er[i]), int(ec[i]), 0.0) for i in dels]
    zr, zc = np.nonzero(D == 0)
    for i in rng.choice(len(zr), size=min(2, len(zr)), replace=False):
        ops.append(("add", int(zr[i]), int(zc[i]), 1.0))
    return ops


def handles(D, fmt):
    """(JAX, port) handles of D stored as ``fmt`` (delta: an ELL base with
    pending writes), each with its stored transpose linked."""
    out = []
    for G, Delta, dev in ((jgrb, JDelta, {}), (tgrb, TDelta,
                                               {"device": "cpu"})):
        def make(M):
            if fmt != "delta":
                return G.GBMatrix.from_dense(M, fmt=fmt, block=BLOCK, **dev)
            base = G.GBMatrix.from_dense(M, fmt="ell", **dev).store
            ops = delta_ops(D)
            if M is not D:
                ops = [(k, j, i, w) for k, i, j, w in ops]
            return G.GBMatrix(Delta.wrap(base).apply_ops(ops))
        h = make(D)
        h.link_transpose(make(D.T.copy()))
        out.append(h)
    return out


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if hasattr(x, "to_dense"):
        return host(x.to_dense())
    return np.asarray(x)


def packed_calls(fn):
    """(fn(), frontier packs the call made)."""
    c0 = tbitmap.pack_calls()
    out = fn()
    return out, tbitmap.pack_calls() - c0


# -- any_pair -----------------------------------------------------------------
def test_semiring_table_matches_jax():
    assert set(S.SEMIRINGS) == set(JS.SEMIRINGS)
    for name, sr in S.SEMIRINGS.items():
        assert sr.mode == JS.SEMIRINGS[name].mode, name
        assert sr.identity == JS.SEMIRINGS[name].identity, name
    assert S.get("any_pair") is S.ANY_PAIR
    assert S.ANY_PAIR.mode == S.OR_AND.mode == "dot_indicator"


@pytest.mark.parametrize("fmt", FMTS)
def test_any_pair_on_the_three_cycle(fmt):
    """The fault's own input: A a 3-cycle, X = I(3); any_pair answers the
    or_and product, which is A's pattern."""
    D = dense_of("c3")
    jh, th = handles(D, fmt)
    X = np.eye(3, dtype=np.float32)
    want = host(jgrb.mxm(jh, jnp.asarray(X), JS.ANY_PAIR))
    got = host(tgrb.mxm(th, torch.from_numpy(X), S.ANY_PAIR))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, host(tgrb.mxm(th, torch.from_numpy(X), S.OR_AND)))
    if fmt != "delta":
        np.testing.assert_array_equal(got, D)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("fmt", FMTS)
def test_any_pair_takes_or_and_routes(fmt, mode):
    """any_pair rides every route or_and rides: the word route on dense,
    ELL and delta-over-ELL unless packing is off, on BitELL whatever the
    mode, never on BSR (its indicator tile product); bit for bit with the
    JAX package and with or_and."""
    D = dense_of("rmat_s6")
    jh, th = handles(D, fmt)
    X = frontier(D.shape[0], F, seed=9)
    with jgrb.packed_frontiers(mode):
        want = host(jgrb.mxm(jh, jnp.asarray(X), JS.ANY_PAIR))
    with tgrb.packed_frontiers(mode):
        got, packs = packed_calls(
            lambda: tgrb.mxm(th, torch.from_numpy(X), S.ANY_PAIR))
        ref, ref_packs = packed_calls(
            lambda: tgrb.mxm(th, torch.from_numpy(X), S.OR_AND))
    np.testing.assert_array_equal(host(got), want)
    np.testing.assert_array_equal(host(got), host(ref))
    words = fmt == "bitadj" or (fmt != "bsr" and mode != "off")
    assert (packs > 0) == words and (ref_packs > 0) == words, (packs,
                                                              ref_packs)


def test_any_pair_on_a_mesh_takes_the_packed_lowering():
    """ShardedELL and ShardedBitELL: any_pair through the packed mesh
    lowering (one word all-gather), equal to or_and and to the unsharded
    JAX product."""
    D = dense_of("rmat_s6")
    X = frontier(D.shape[0], F, seed=4)
    mesh = Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2),
                ("data", "model"))
    want = host(jgrb.mxm(jgrb.GBMatrix.from_dense(D, fmt="ell"),
                         jnp.asarray(X), JS.ANY_PAIR))
    for fmt in ("ell", "bitadj"):
        sh = tgrb.distribute(tgrb.GBMatrix.from_dense(D, fmt=fmt,
                                                      device="cpu"), mesh)
        got, packs = packed_calls(
            lambda: tgrb.mxm(sh, torch.from_numpy(X), S.ANY_PAIR))
        assert packs > 0, fmt
        np.testing.assert_array_equal(host(got), want, err_msg=fmt)
        np.testing.assert_array_equal(
            host(got), host(tgrb.mxm(sh, torch.from_numpy(X), S.OR_AND)))


# -- packed_frontiers ---------------------------------------------------------
def test_packed_frontiers_width_floor_overrides_and_bad_mode():
    D = dense_of("rmat_s6")
    h = tgrb.GBMatrix.from_dense(D, fmt="ell", device="cpu")
    wide = torch.from_numpy(frontier(D.shape[0], tgrb.AUTO_PACK_MIN_WIDTH, 1))
    narrow = wide[:, :tgrb.AUTO_PACK_MIN_WIDTH - 1]
    assert packed_calls(lambda: tgrb.mxm(h, narrow, S.OR_AND))[1] == 0
    assert packed_calls(lambda: tgrb.mxm(h, wide, S.OR_AND))[1] > 0
    with tgrb.packed_frontiers("off"):
        assert packed_calls(lambda: tgrb.mxm(h, wide, S.OR_AND))[1] == 0
        assert not tgrb.words_route_ok(h, 64)
    with tgrb.packed_frontiers("on"):
        y, packs = packed_calls(lambda: tgrb.mxv(h, wide[:, 0], S.OR_AND))
        assert packs > 0 and tgrb.words_route_ok(h, 1)
    np.testing.assert_array_equal(host(y), host(tgrb.mxv(h, wide[:, 0],
                                                         S.OR_AND)))
    # BitELL keeps its word route in every mode
    hb = tgrb.GBMatrix.from_dense(D, fmt="bitadj", device="cpu")
    with tgrb.packed_frontiers("off"):
        assert tgrb.words_route_ok(hb, 1)
        assert packed_calls(lambda: tgrb.mxm(hb, narrow, S.OR_AND))[1] > 0
    errors = []
    for grb_ in (jgrb, tgrb):
        with pytest.raises(ValueError) as e:
            with grb_.packed_frontiers("sideways"):
                pass
        errors.append(str(e.value))
        assert grb_._PACK_MODE == "auto"
    assert errors[0] == errors[1]
    # the mode comes back after an exception inside the block
    with pytest.raises(RuntimeError):
        with tgrb.packed_frontiers("off"):
            raise RuntimeError("inside")
    assert tgrb._PACK_MODE == "auto"


# -- grb.desc -----------------------------------------------------------------
def descriptor_grid(n, f, seed, jax_side):
    """The JAX bitmap suite's descriptor grid, spelled through desc."""
    G = jgrb if jax_side else tgrb
    conv = jnp.asarray if jax_side else torch.from_numpy
    M = conv(frontier(n, f, seed + 100, p=0.5))
    out = conv(frontier(n, f, seed + 200, p=0.3))
    Sr = JS if jax_side else S
    return [
        ("null", G.desc(), None),
        ("mask", G.desc(mask=M), None),
        ("mask_comp", G.desc(mask=M, complement=True), None),
        ("transpose", G.desc(transpose_a=True), None),
        ("mask_T", G.desc(mask=M, complement=True, transpose_a=True), None),
        ("accum_out", G.desc(mask=M, accum=Sr.OR), out),
        ("replace", G.desc(mask=M, replace=True), out),
    ]


def test_desc_builds_the_descriptor():
    M = torch.ones((3, 2))
    d = tgrb.desc(mask=M, complement=True, accum=S.PLUS, replace=True,
                  transpose_a=True)
    assert isinstance(d, tgrb.Descriptor)
    assert (d.mask is M and d.complement and d.accum is S.PLUS
            and d.replace and d.transpose_a)
    null = tgrb.desc()
    assert (null.mask is None and null.accum is None and not null.complement
            and not null.replace and not null.transpose_a)


@pytest.mark.parametrize("sr", ["any_pair", "plus_times"])
@pytest.mark.parametrize("fmt", ["dense", "ell", "bsr", "bitadj"])
def test_desc_grid_matches_jax(fmt, sr):
    D = dense_of("petersen")
    n = D.shape[0]
    jh, th = handles(D, fmt)
    X = frontier(n, F, seed=7)
    jgrid = descriptor_grid(n, F, 3, True)
    tgrid = descriptor_grid(n, F, 3, False)
    for (name, jd, jout), (_, td, tout) in zip(jgrid, tgrid):
        want = host(jgrb.mxm(jh, jnp.asarray(X), JS.get(sr), jd, out=jout))
        got = host(tgrb.mxm(th, torch.from_numpy(X), S.get(sr), td,
                            out=tout))
        np.testing.assert_array_equal(got, want, err_msg=f"{fmt} {name}")


# -- mxm with a sparse B ------------------------------------------------------
SPARSE_PAIRS = [(a, b) for a in ("dense", "ell", "bsr", "bitadj", "delta")
                for b in ("ell", "bsr", "bitadj", "delta")
                if (a, b) != ("bsr", "bsr")]


@pytest.mark.parametrize("a_fmt,b_fmt", SPARSE_PAIRS)
def test_sparse_b_densifies_as_in_jax(a_fmt, b_fmt):
    """A sparse B that is not the BSR x BSR SpGEMM case multiplies as its
    dense form, as the JAX package does, under every semiring mode."""
    D = dense_of("petersen")
    B = D * (1 + np.arange(D.shape[1]) % 3)[None, :].astype(np.float32)
    ja, ta = handles(D, a_fmt)
    jb, tb = handles(B if b_fmt in ("ell", "bsr") else D, b_fmt)
    for name in ("plus_times", "or_and", "any_pair", "min_plus"):
        want = host(jgrb.mxm(ja, jb, JS.get(name)))
        got = tgrb.mxm(ta, tb, S.get(name))
        assert isinstance(got, torch.Tensor), name
        np.testing.assert_array_equal(host(got), want,
                                      err_msg=f"{a_fmt} x {b_fmt} {name}")


def test_bsr_times_bsr_stays_spgemm():
    D = dense_of("petersen")
    _, ta = handles(D, "bsr")
    got = tgrb.mxm(ta, ta, S.PLUS_PAIR)
    assert isinstance(got, tgrb.GBMatrix) and got.fmt == "bsr"
    np.testing.assert_array_equal(host(got), D @ D)


# -- storage constructors -----------------------------------------------------
def u32(t) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("name", GRAPHS)
def test_storage_constructors_match_jax(name):
    """``ELL.from_dense`` and BitELL's ``from_dense`` / ``from_ell`` hold
    the JAX package's arrays; ``to_dense`` and ``payload_bytes`` agree.
    Results lie on the input's device (a CPU tensor stays on the CPU)."""
    D = dense_of(name)
    W = D * (1 + np.arange(D.shape[0]) % 3)[:, None].astype(np.float32)
    je, te = JELL.from_dense(W), TELL.from_dense(torch.from_numpy(W))
    assert te.device == CPU and te.nnz == je.nnz
    for a in ("indices", "mask", "values"):
        np.testing.assert_array_equal(getattr(te, a).numpy(),
                                      np.asarray(getattr(je, a)), err_msg=a)
    np.testing.assert_array_equal(host(te.to_dense()), W)
    te8 = TELL.from_dense(W, pad_deg_to=1, device="cpu")
    assert te8.max_deg == JELL.from_dense(W, pad_deg_to=1).max_deg
    jb, tb = JBitELL.from_dense(D), TBitELL.from_dense(torch.from_numpy(D))
    assert tb.device == CPU and tb.nnz == jb.nnz == int((D != 0).sum())
    np.testing.assert_array_equal(u32(tb.tiles), np.asarray(jb.tiles))
    np.testing.assert_array_equal(tb.cols.numpy(), np.asarray(jb.cols))
    assert tb.payload_bytes == jb.payload_bytes
    np.testing.assert_array_equal(host(tb.to_dense()), D)
    np.testing.assert_array_equal(host(tb.transpose().to_dense()), D.T)
    jf, tf = JBitELL.from_ell(je), TBitELL.from_ell(te)
    assert tf.device == te.device and tf.nnz == jf.nnz
    np.testing.assert_array_equal(u32(tf.tiles), np.asarray(jf.tiles))
    np.testing.assert_array_equal(tf.cols.numpy(), np.asarray(jf.cols))
    np.testing.assert_array_equal(host(tf.to_dense()), (W != 0) * 1.0)


def test_numpy_input_defaults_to_the_card():
    """A numpy matrix with no device goes to "cuda", the port's default,
    which raises on a host without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    for ctor in (TELL.from_dense, TBitELL.from_dense):
        with pytest.raises((RuntimeError, AssertionError)):
            ctor(dense_of("k4"))


def _sym(edges, n):
    D = np.zeros((n, n), np.float32)
    for a, b in edges:
        D[a, b] = D[b, a] = 1.0
    return D


def test_ktruss_ell_input_reblocks_sparsely():
    """tests/test_ktruss.py's case: an ELL from ``ELL.from_dense`` peels
    without a densification, counted as the JAX package counts it."""
    D = _sym([(i, j) for i in range(4) for j in range(i + 1, 4)], 4)
    E = TELL.from_dense(D, device="cpu")
    before = tbsr.densify_calls()
    T = ktruss(tgrb.GBMatrix(E), 4)
    assert tbsr.densify_calls() == before
    assert T.nvals == 12 and T.fmt == "bsr"


def test_bsr_counters_count_where_jax_counts():
    D = dense_of("petersen")
    jb = jgrb.GBMatrix.from_dense(D, fmt="bsr", block=4).store
    tb = tgrb.GBMatrix.from_dense(D, fmt="bsr", block=4, device="cpu").store
    counts = []
    for mod, b in ((jbsr, jb), (tbsr, tb)):
        d0, h0 = mod.densify_calls(), mod.host_numeric_calls()
        b.to_dense()
        tiles = np.ones((1, 4, 4), np.float32)
        if mod is jbsr:
            mod.BSR.from_blocks([0], [1], tiles, D.shape, 4)
        else:
            mod.BSR.from_blocks([0], [1], tiles, D.shape, 4, device="cpu")
            mod.BSR.from_blocks_device([0], [1], torch.from_numpy(tiles),
                                       D.shape, 4)
        counts.append((mod.densify_calls() - d0,
                       mod.host_numeric_calls() - h0))
    assert counts[0] == counts[1] == (1, 1)


def test_assign_places_a_dense_region_through_from_dense():
    """``grb.assign`` of a dense region onto a sharded handle re-homes it
    through ``ELL.from_dense``: equal to the same region given as ELL and
    to the JAX package's unsharded assign."""
    D = dense_of("rmat_s6")
    n = D.shape[0]
    J = [2, 5, 11, 40]
    sub = np.where(np.random.default_rng(5).random((n, len(J))) < 0.2,
                   5.0, 0.0).astype(np.float32)
    mesh = Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2),
                ("data", "model"))
    sh = tgrb.distribute(tgrb.GBMatrix.from_dense(D, fmt="ell",
                                                  device="cpu"), mesh)
    got = tgrb.assign(sh, torch.from_numpy(sub), None, J)
    via_ell = tgrb.assign(sh, tgrb.GBMatrix(TELL.from_dense(sub,
                                                            device="cpu")),
                          None, J)
    want = jgrb.assign(jgrb.GBMatrix.from_dense(D, fmt="ell"),
                       jnp.asarray(sub), None, J)
    np.testing.assert_array_equal(host(got), host(via_ell))
    np.testing.assert_array_equal(host(got), host(want))


@pytest.mark.parametrize("chunk", [7, 1 << 26])
def test_from_arrays_counts_bitell_bits_in_chunks(chunk, monkeypatch):
    """``graph.from_arrays`` counts an adopted BitELL's set bits a chunk of
    words at a time (a whole-tensor popcount ran the card out of memory on
    a scale-18 handle); the count equals the build's distinct edges at
    any chunk size."""
    from repro_torch.graph import graph as tgraph
    from repro_torch.graph.datagen import rmat_graph
    monkeypatch.setattr(tgraph, "COUNT_WORDS", chunk)
    g = rmat_graph(8, fmt="bitadj", device="cpu")

    def arrays(M):
        return tuple({"tiles": s_.tiles.numpy(), "cols": s_.cols.numpy()}
                     for s_ in (M.store, M.T.store))

    got = tgraph.from_arrays(g.n, {"KNOWS": arrays(g.relations["KNOWS"].A)},
                             adj=arrays(g.adj.A), device="cpu")
    for rel in ("KNOWS",):
        a, b = g.relations[rel], got.relations[rel]
        assert a.nnz == b.nnz == b.A.store.nnz == b.A.T.store.nnz
        assert torch.equal(a.A.store.tiles, b.A.store.tiles)
    assert got.adj.nnz == g.adj.nnz

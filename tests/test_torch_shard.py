"""PyTorch port, the mesh: ``distr.mesh.Mesh``, ``core.shard.ShardedELL``,
``core.bitadj.ShardedBitELL``, the ``distr.graph2d`` lowerings and
``mesh=`` serving, on the CPU.

The port's meshes here are ``Mesh``es over ``torch.device("cpu")``
positions in this process. Two kinds of comparison:

* Against the JAX mesh. One module-scoped fixture runs the JAX package in
  a subprocess with 16 forced host devices (its meshes need as many
  devices as positions; this process keeps its single-device jax) on
  inputs made here from fixed seeds, and writes its sharded outputs to an
  ``.npz``: the padded ShardedELL / ShardedBitELL arrays, ``mxm`` and
  ``mxm_words`` in both directions on ``mesh222`` and ``mesh421`` (and
  the unpacked transposed body on a 16-way "data" axis), nibble words,
  ``reduce`` on every axis, ``ewise_add`` / ``ewise_mult`` and their
  descriptor blend, ``extract`` columns, ``assign`` columns, k-hop and
  BFS, SSSP and PageRank. The port's same calls must give the same bits;
  PageRank and the float ``plus_times`` transposed sums (a psum_scatter
  of float partials, summed in another order) are held to rtol = atol =
  1e-5, the JAX suite's own tolerance (tests/test_sharded_grb.py).
  Weights and frontier values are small integers, so every other sum is
  exact in float32.
* In process: the port's sharded results against the JAX package's
  unsharded ones and the port's unsharded ones, the TypeErrors and
  ValueErrors of ``distribute`` and of mixed operands, the per-mesh cache
  and re-homing, the 16-position unpacked body, ``host_transfers()``
  across sharded hop loops, and the executor, the server and the
  database over a mesh.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algorithms as JA
from repro.core import grb as jgrb
from repro.core import semiring as JS
from repro.query.executor import execute as jexecute
from repro_torch import algorithms as TA
from repro_torch.core import bitmap as tbitmap
from repro_torch.core import grb as tgrb
from repro_torch.core import semiring as S
from repro_torch.core import shard as tshard
from repro_torch.core.bitadj import BitELL as TBitELL
from repro_torch.core.ell import ELL as TELL
from repro_torch.distr import graph2d, mesh as M
from repro_torch.distr.mesh import Mesh
from repro_torch.engine.database import Database
from repro_torch.engine.server import QueryServer
from repro_torch.graph.datagen import rmat_edges, rmat_graph
from repro_torch.graph.graph import GraphBuilder
from repro_torch.query.executor import ExecutionContext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N = 201                 # rows pad on both meshes; 7 panels pad too
FS = (3, 40)            # frontier widths: the float and the packed route
SEMIRINGS = ("or_and", "plus_times", "min_plus", "max_plus")
MONOIDS = ("plus", "or", "min", "max")
AXES = (None, 0, 1)
J = [2, 5, 11, 64, 200]


def cpu_mesh(shape, names):
    return Mesh(np.array([CPU] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


MESHES = {"mesh222": ((2, 2, 2), ("pod", "data", "model")),
          "mesh421": ((4, 2, 1), ("data", "pod", "model")),
          "mesh16": ((16, 1, 1), ("data", "pod", "model"))}


def tmesh(name):
    return cpu_mesh(*MESHES[name])


def u32(t) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def host(x):
    if hasattr(x, "to_dense") and not isinstance(x, torch.Tensor):
        x = x.to_dense()
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _coo(n, seed, scale=8):
    """R-MAT edges cut to n vertices, duplicates dropped, weights 1-3."""
    src, dst, _ = rmat_edges(scale, 8, seed)
    keep = (src < n) & (dst < n)
    key = np.unique(src[keep] * n + dst[keep])
    r, c = key // n, key % n
    w = (1 + (r * 7 + c * 3) % 3).astype(np.float32)
    return r, c, w


def inputs():
    rng = np.random.default_rng(20)
    r, c, w = _coo(N, 1)
    rb, cb, wb = _coo(N, 2)
    return dict(
        r=r, c=c, w=w, rb=rb, cb=cb, wb=wb,
        X=np.where(rng.random((N, 40)) < 0.3,
                   rng.integers(1, 3, (N, 40)), 0).astype(np.float32),
        Xb=(rng.random((N, 64)) < 0.05).astype(np.float32),
        seeds=np.array([0, 3, 17, 40, 100, 7, 9, 11, 150, 200]),
        mask=((np.arange(N)[:, None] + np.arange(N)[None, :]) % 3 != 0)
        .astype(np.float32),
        sub=np.where(rng.random((N, len(J))) < 0.2, 5.0, 0.0)
        .astype(np.float32),
        nib=(rng.random((10, 37)) < 0.4).astype(np.float32))


# -- the JAX mesh, in a subprocess ------------------------------------------
_JAX_MESH = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=16 "
                           + os.environ.get("XLA_FLAGS", ""))
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import algorithms as alg
from repro.core import bitmap, grb, semiring as S
from repro.core.bitadj import BitELL
from repro.core.ell import ELL

I = dict(np.load(sys.argv[1]))
J = [int(j) for j in I["J"]]
n = int(I["n"])
out = {}
def put(k, v):
    out[k] = np.asarray(v)

def handle(r, c, w, linked):
    h = grb.GBMatrix(ELL.from_coo(r, c, w, (n, n)))
    if linked:
        h.link_transpose(grb.GBMatrix(ELL.from_coo(c, r, w, (n, n))))
    return h

devs = jax.devices()
meshes = {"mesh222": Mesh(np.array(devs[:8]).reshape(2, 2, 2),
                          ("pod", "data", "model")),
          "mesh421": Mesh(np.array(devs[:8]).reshape(4, 2, 1),
                          ("data", "pod", "model")),
          "mesh16": Mesh(np.array(devs[:16]).reshape(16, 1, 1),
                         ("data", "pod", "model"))}
srs = {s.name: s for s in (S.OR_AND, S.PLUS_TIMES, S.MIN_PLUS, S.MAX_PLUS)}
mons = {"plus": S.PLUS, "or": S.OR, "min": S.MIN, "max": S.MAX}
X, Xb, seeds = jnp.asarray(I["X"]), jnp.asarray(I["Xb"]), I["seeds"]
Xw = bitmap.pack(Xb)
put("nibbles", bitmap.pack_nibbles(jnp.asarray(I["nib"])))
hb = grb.GBMatrix(BitELL.from_coo(I["r"], I["c"], None, (n, n)))
for mname, mesh in meshes.items():
    p = mname + "/"
    shu = grb.distribute(handle(I["r"], I["c"], I["w"], False), mesh)
    if mname == "mesh16":
        put(p + "words_T", grb.mxm_words(shu, Xw, transpose_a=True))
        put(p + "mxm/or_and/40/T", grb.mxm(shu, X, S.OR_AND,
                                           grb.TRANSPOSE_A))
        continue
    for a in ("indices", "mask", "values"):
        put(p + "ell_" + a, getattr(shu.store, a))
    sb = grb.distribute(hb, mesh)
    put(p + "bit_tiles", sb.store.tiles)
    put(p + "bit_cols", sb.store.cols)
    put(p + "bit_tiles_T", sb.T.store.tiles)
    for name, sr in srs.items():
        for f in (3, 40):
            x = X[:, :f] if name != "or_and" else (X[:, :f] > 0) * 1.0
            put(p + f"mxm/{name}/{f}/row", grb.mxm(shu, x, sr))
            put(p + f"mxm/{name}/{f}/T", grb.mxm(shu, x, sr, grb.TRANSPOSE_A))
    put(p + "words_row", grb.mxm_words(shu, Xw))
    put(p + "words_T", grb.mxm_words(shu, Xw, transpose_a=True))
    put(p + "bit_words_row", grb.mxm_words(sb, Xw))
    put(p + "bit_words_T", grb.mxm_words(sb, Xw, transpose_a=True))
    for mn, mon in mons.items():
        for ax in (None, 0, 1):
            put(p + f"reduce/{mn}/{ax}", grb.reduce(shu, mon, axis=ax))
            put(p + f"bit_reduce/{mn}/{ax}", grb.reduce(sb, mon, axis=ax))
    shB = grb.distribute(handle(I["rb"], I["cb"], I["wb"], False), mesh)
    for op in ("add", "mult"):
        got = (grb.ewise_add(shu, shB, S.PLUS) if op == "add" else
               grb.ewise_mult(shu, shB, lambda a, b: a * b))
        for a in ("indices", "mask", "values"):
            put(p + f"ewise_{op}_{a}", getattr(got.store, a))
    d = grb.Descriptor(mask=jnp.asarray(I["mask"]), accum=S.PLUS)
    put(p + "ewise_blend", grb.ewise_add(shu, shB, S.PLUS, d,
                                         out=shB).to_dense())
    ex = grb.extract(shu, None, J)
    for a in ("indices", "mask", "values"):
        put(p + f"extract_{a}", getattr(ex.store, a))
    sub = grb.GBMatrix.from_dense(I["sub"], fmt="ell")
    put(p + "assign", grb.assign(shu, sub, None, J).to_dense())
    sh = grb.distribute(handle(I["r"], I["c"], I["w"], True), mesh)
    put(p + "khop", alg.khop_counts(sh, seeds, k=3))
    put(p + "bfs", alg.bfs_levels(sh, seeds))
    put(p + "bit_khop", alg.khop_counts(sb, seeds, k=3))
    put(p + "sssp", alg.sssp(sh, seeds, max_iter=n))
    put(p + "pagerank", alg.pagerank(sh, iters=30))
np.savez(sys.argv[2], **out)
print("JAX_MESH_OK")
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_mesh")
    src, dst = d / "in.npz", d / "out.npz"
    np.savez(src, n=N, J=np.array(J), **inputs())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_MESH, str(src), str(dst)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0 and "JAX_MESH_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(dst))


def t_handle(r, c, w, linked):
    h = tgrb.GBMatrix(TELL.from_coo(r, c, w, (N, N), device="cpu"))
    if linked:
        h.link_transpose(tgrb.GBMatrix(TELL.from_coo(c, r, w, (N, N),
                                                     device="cpu")))
    return h


@pytest.fixture(scope="module")
def port():
    """The port's handles on the inputs the JAX side read."""
    I = inputs()
    hb = tgrb.GBMatrix(TBitELL.from_coo(I["r"], I["c"], None, (N, N),
                                        device="cpu"))
    return I, hb


def _frontier(I, name, f):
    x = torch.from_numpy(I["X"][:, :f])
    return (x > 0).to(torch.float32) if name == "or_and" else x


def _close(name, how):
    return name == "plus_times" and how == "T"


# -- storage ------------------------------------------------------------------
@pytest.mark.parametrize("mname", ["mesh222", "mesh421"])
def test_sharded_storage_matches_jax(mname, jax_mesh, port):
    I, hb = port
    mesh = tmesh(mname)
    shu = tgrb.distribute(t_handle(I["r"], I["c"], I["w"], False), mesh)
    assert shu.fmt == "sharded" and shu._T is None
    for a in ("indices", "mask", "values"):
        want = jax_mesh[f"{mname}/ell_{a}"]
        got = getattr(shu.store, a).numpy()
        assert got.shape == want.shape and np.array_equal(got, want), a
    assert shu.store.n_pad == jax_mesh[f"{mname}/ell_mask"].shape[0] > N
    sb = tgrb.distribute(hb, mesh)
    assert sb.fmt == sb.T.fmt == "bitshard"
    assert np.array_equal(u32(sb.store.tiles), jax_mesh[f"{mname}/bit_tiles"])
    assert np.array_equal(sb.store.cols.numpy(), jax_mesh[f"{mname}/bit_cols"])
    assert np.array_equal(u32(sb.T.store.tiles),
                          jax_mesh[f"{mname}/bit_tiles_T"])
    # padding panels are all-sentinel, padded rows all mask-false
    assert (sb.store.cols[-1] == sb.store.n_ctiles).all()
    assert not shu.store.mask[N:].any()


def test_nibble_words_match_jax(jax_mesh, port):
    I, _ = port
    got = tbitmap.pack_nibbles(torch.from_numpy(I["nib"]))
    assert np.array_equal(u32(got), jax_mesh["nibbles"])
    back = tbitmap.unpack_nibbles(got, I["nib"].shape[1])
    assert np.array_equal(back.numpy(), I["nib"] != 0)
    # summed nibble words saturate back to the OR of the parts
    parts = (np.random.default_rng(3).random(
        (tbitmap.NIBBLE_MAX_SHARDS, 6, 24)) < 0.3)
    tot = sum(tbitmap.pack_nibbles(torch.from_numpy(p)).to(torch.int64)
              & 0xFFFFFFFF for p in parts)
    assert np.array_equal(tbitmap.unpack_nibbles(tot, 24).numpy(),
                          parts.any(axis=0))


# -- products -----------------------------------------------------------------
@pytest.mark.parametrize("how", ["row", "T"])
@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("mname", ["mesh222", "mesh421"])
def test_mxm_matches_jax_mesh(mname, name, f, how, jax_mesh, port):
    I, _ = port
    sh = tgrb.distribute(t_handle(I["r"], I["c"], I["w"], False),
                         tmesh(mname))
    d = tgrb.TRANSPOSE_A if how == "T" else tgrb.NULL
    got = tgrb.mxm(sh, _frontier(I, name, f), S.SEMIRINGS[name], d).numpy()
    want = jax_mesh[f"{mname}/mxm/{name}/{f}/{how}"]
    if _close(name, how):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("key", ["words_row", "words_T", "bit_words_row",
                                 "bit_words_T"])
@pytest.mark.parametrize("mname", ["mesh222", "mesh421"])
def test_mxm_words_match_jax_mesh(mname, key, jax_mesh, port):
    I, hb = port
    mesh = tmesh(mname)
    A = (tgrb.distribute(hb, mesh) if key.startswith("bit") else
         tgrb.distribute(t_handle(I["r"], I["c"], I["w"], False), mesh))
    xw = tbitmap.pack(torch.from_numpy(I["Xb"]))
    got = tgrb.mxm_words(A, xw, transpose_a=key.endswith("_T"))
    assert np.array_equal(u32(got), jax_mesh[f"{mname}/{key}"])


def test_unpacked_body_at_16_positions(jax_mesh, port):
    """Past NIBBLE_MAX_SHARDS row shards the transposed packed product
    psum_scatters float partials: same bits as the JAX package's."""
    I, _ = port
    mesh = tmesh("mesh16")
    assert mesh.shape["data"] > tbitmap.NIBBLE_MAX_SHARDS
    sh = tgrb.distribute(t_handle(I["r"], I["c"], I["w"], False), mesh)
    xw = tbitmap.pack(torch.from_numpy(I["Xb"]))
    got = tgrb.mxm_words(sh, xw, transpose_a=True)
    assert np.array_equal(u32(got), jax_mesh["mesh16/words_T"])
    x = _frontier(I, "or_and", 40)
    assert np.array_equal(tgrb.mxm(sh, x, S.OR_AND, tgrb.TRANSPOSE_A).numpy(),
                          jax_mesh["mesh16/mxm/or_and/40/T"])


@pytest.mark.parametrize("dsz", [15, 16])
def test_nibble_limit_both_sides(dsz):
    """15 row shards take the nibble body, 16 the float one; both give the
    transposed product's bits (the port's unsharded mxm_words)."""
    rng = np.random.default_rng(dsz)
    n, F = 95, 64
    r, c = rng.integers(0, n, 600), rng.integers(0, n, 600)
    key = np.unique(r * n + c)
    e = TELL.from_coo(key // n, key % n, None, (n, n), device="cpu")
    mesh = cpu_mesh((dsz, 1, 1), ("data", "pod", "model"))
    s = tshard.ShardedELL.from_ell(e, mesh)
    xw = tbitmap.pack(torch.from_numpy((rng.random((n, F)) < 0.2)
                                       .astype(np.float32)))
    want = tgrb.mxm_words(tgrb.GBMatrix(e.transpose()), xw)
    assert torch.equal(tshard.mxm_words(s, xw, transposed=True), want)


# -- reductions ---------------------------------------------------------------
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("mon", MONOIDS)
@pytest.mark.parametrize("mname", ["mesh222", "mesh421"])
def test_reduce_matches_jax_mesh(mname, mon, axis, jax_mesh, port):
    I, hb = port
    mesh = tmesh(mname)
    sh = tgrb.distribute(t_handle(I["r"], I["c"], I["w"], False), mesh)
    sb = tgrb.distribute(hb, mesh)
    for A, key in ((sh, "reduce"), (sb, "bit_reduce")):
        got = tgrb.reduce(A, getattr(S, mon.upper()), axis=axis)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(),
                              jax_mesh[f"{mname}/{key}/{mon}/{axis}"]), key


# -- the element-wise family ----------------------------------------------------
@pytest.mark.parametrize("mname", ["mesh222", "mesh421"])
def test_ewise_extract_assign_match_jax_mesh(mname, jax_mesh, port):
    I, _ = port
    mesh = tmesh(mname)
    sh = tgrb.distribute(t_handle(I["r"], I["c"], I["w"], False), mesh)
    shB = tgrb.distribute(t_handle(I["rb"], I["cb"], I["wb"], False), mesh)
    for op in ("add", "mult"):
        got = (tgrb.ewise_add(sh, shB, S.PLUS) if op == "add" else
               tgrb.ewise_mult(sh, shB, lambda a, b: a * b))
        assert got.fmt == "sharded"
        for a in ("indices", "mask", "values"):
            assert np.array_equal(getattr(got.store, a).numpy(),
                                  jax_mesh[f"{mname}/ewise_{op}_{a}"]), a
    d = tgrb.Descriptor(mask=torch.from_numpy(I["mask"]), accum=S.PLUS)
    got = tgrb.ewise_add(sh, shB, S.PLUS, d, out=shB)
    assert np.array_equal(host(got), jax_mesh[f"{mname}/ewise_blend"])
    ex = tgrb.extract(sh, None, J)
    assert ex.fmt == "sharded"
    for a in ("indices", "mask", "values"):
        assert np.array_equal(getattr(ex.store, a).numpy(),
                              jax_mesh[f"{mname}/extract_{a}"]), a
    sub = tgrb.GBMatrix.from_dense(torch.from_numpy(I["sub"]), fmt="ell")
    got = tgrb.assign(sh, sub, None, J)
    assert got.fmt == "sharded"
    assert np.array_equal(host(got), jax_mesh[f"{mname}/assign"])


# -- algorithms ---------------------------------------------------------------
@pytest.mark.parametrize("mname", ["mesh222", "mesh421"])
def test_algorithms_match_jax_mesh(mname, jax_mesh, port):
    I, hb = port
    mesh = tmesh(mname)
    sh = tgrb.distribute(t_handle(I["r"], I["c"], I["w"], True), mesh)
    assert sh._T is not None and sh._T.fmt == "sharded"
    seeds = I["seeds"]
    p = mname + "/"
    assert np.array_equal(TA.khop_counts(sh, seeds, k=3).numpy(),
                          jax_mesh[p + "khop"])
    assert np.array_equal(TA.bfs_levels(sh, seeds).numpy(),
                          jax_mesh[p + "bfs"])
    assert np.array_equal(
        TA.khop_counts(tgrb.distribute(hb, mesh), seeds, k=3).numpy(),
        jax_mesh[p + "bit_khop"])
    assert np.array_equal(TA.sssp(sh, seeds, max_iter=N).numpy(),
                          jax_mesh[p + "sssp"])
    np.testing.assert_allclose(TA.pagerank(sh, iters=30).numpy(),
                               jax_mesh[p + "pagerank"], rtol=1e-5,
                               atol=1e-5)


# -- in process: the port sharded vs the JAX package and the port unsharded ----
GRAPH_FMTS = ("ell", "bitadj")


@pytest.fixture(scope="module")
def rmat():
    """R-MAT s9 in both packages' builds, ELL and BitELL."""
    from repro.graph.datagen import rmat_graph as jrmat
    return {fmt: (rmat_graph(9, edge_factor=8, seed=4, fmt=fmt,
                             device="cpu"),
                  jrmat(9, edge_factor=8, seed=4, fmt=fmt))
            for fmt in GRAPH_FMTS}


@pytest.mark.parametrize("mname", ["mesh222", "mesh421", "mesh16"])
@pytest.mark.parametrize("fmt", GRAPH_FMTS)
def test_traversals_against_both_unsharded(fmt, mname, rmat):
    tg, jg = rmat[fmt]
    A, JA_ = tg.relations["KNOWS"].A, jg.relations["KNOWS"].A
    sh = tgrb.distribute(A, tmesh(mname))
    seeds = np.arange(0, 512, 37)
    before = tgrb.host_transfers()
    kc = TA.khop_counts(sh, seeds, k=3)
    lv = TA.bfs_levels(sh, seeds)
    wl = TA.wcc(sh)
    assert tgrb.host_transfers() == before, \
        "a sharded hop loop gathered to the host"
    for got, t_want, j_want in (
            (kc, TA.khop_counts(A, seeds, k=3),
             JA.khop_counts(JA_, seeds, k=3)),
            (lv, TA.bfs_levels(A, seeds), JA.bfs_levels(JA_, seeds)),
            (wl, TA.wcc(A), JA.wcc(JA_))):
        assert torch.equal(got, t_want)
        assert np.array_equal(got.numpy(), np.asarray(j_want))


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("mname", ["mesh222", "mesh421"])
def test_mxm_unlinked_transpose_against_both(mname, name, rmat):
    """The transposed lowerings (no stored transpose) against the linked
    twin's row form and the JAX package's unsharded product."""
    tg, jg = rmat["ell"]
    A = tg.relations["KNOWS"].A
    rng = np.random.default_rng(5)
    X = np.where(rng.random((tg.n, 24)) < 0.2, rng.integers(1, 3, (tg.n, 24)),
                 0).astype(np.float32)
    if name == "or_and":
        X = (X > 0).astype(np.float32)
    sr = S.SEMIRINGS[name]
    un = tgrb.distribute(tgrb.GBMatrix(A.store), tmesh(mname))
    linked = tgrb.distribute(A, tmesh(mname))
    got = tgrb.mxm(un, torch.from_numpy(X), sr, tgrb.TRANSPOSE_A)
    twin = tgrb.mxm(linked, torch.from_numpy(X), sr, tgrb.TRANSPOSE_A)
    want = np.asarray(jgrb.mxm(jg.relations["KNOWS"].A, jnp.asarray(X),
                               JS.SEMIRINGS[name], jgrb.TRANSPOSE_A))
    if name == "plus_times":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, twin)
        assert np.array_equal(got.numpy(), want)
    # the tropical transposed form keeps the identity where no edge lands
    if sr.mode == "bcast":
        # output row j of A^T (x) X is column j of A
        empty = torch.ones(tg.n, dtype=torch.bool)
        empty[A.store.indices[A.store.mask].long()] = False
        assert empty.any()
        assert bool((got[empty] == sr.identity).all())


@pytest.mark.parametrize("mname", ["mesh222", "mesh421"])
def test_element_wise_against_both(mname):
    """Shard-local merges under every descriptor blend against the port's
    unsharded ELL route and the JAX package's."""
    rng = np.random.default_rng(9)
    n = 37
    Da, Db, Dc = (np.where(rng.random((n, n)) < p, rng.integers(1, 4, (n, n)),
                           0).astype(np.float32) for p in (0.2, 0.25, 0.3))
    mask = ((np.arange(n)[:, None] + np.arange(n)) % 2).astype(np.float32)
    mesh = tmesh(mname)
    te = [tgrb.GBMatrix.from_dense(torch.from_numpy(D), fmt="ell")
          for D in (Da, Db, Dc)]
    je = [jgrb.GBMatrix.from_dense(D, fmt="ell") for D in (Da, Db, Dc)]
    ts = [tgrb.distribute(h, mesh) for h in te]
    blends = [dict(), dict(mask=True), dict(mask=True, complement=True),
              dict(accum=True), dict(mask=True, replace=True),
              dict(accum=True, mask=True, complement=True, replace=True)]
    for b in blends:
        def desc(g, S_, m):
            return g.Descriptor(mask=m if b.get("mask") else None,
                                complement=b.get("complement", False),
                                accum=S_.PLUS if b.get("accum") else None,
                                replace=b.get("replace", False))
        td = desc(tgrb, S, torch.from_numpy(mask))
        jd = desc(jgrb, JS, jnp.asarray(mask))
        for op in ("add", "mult"):
            fn = "ewise_add" if op == "add" else "ewise_mult"
            tm = S.PLUS if op == "add" else (lambda a, b: a * b)
            jm = JS.PLUS if op == "add" else (lambda a, b: a * b)
            got = getattr(tgrb, fn)(ts[0], ts[1], tm, td, out=ts[2])
            assert got.fmt == "sharded"
            t_want = getattr(tgrb, fn)(te[0], te[1], tm, td, out=te[2])
            j_want = getattr(jgrb, fn)(je[0], je[1], jm, jd, out=je[2])
            assert np.array_equal(host(got), host(t_want)), (b, op)
            assert np.array_equal(host(got), np.asarray(j_want.to_dense()))
        for fn, f in (("apply", lambda v: v * 2.0 + 1.0),
                      ("select", lambda v: v > 1.5)):
            got = getattr(tgrb, fn)(f, ts[0], td, out=ts[2])
            assert got.fmt == "sharded"
            assert np.array_equal(
                host(got), host(getattr(tgrb, fn)(f, te[0], td, out=te[2])))
            assert np.array_equal(host(got), np.asarray(
                getattr(jgrb, fn)(f, je[0], jd, out=je[2]).to_dense()))
    # row subsets take the counted gather and come back sharded
    before = tgrb.host_transfers()
    got = tgrb.extract(ts[0], range(0, 10), range(5, 30))
    assert got.fmt == "sharded" and tgrb.host_transfers() > before
    assert np.array_equal(host(got), np.asarray(
        jgrb.extract(je[0], range(0, 10), range(5, 30)).to_dense()))
    sub = tgrb.GBMatrix.from_dense(torch.full((2, 2), 5.0), fmt="ell")
    got = tgrb.assign(ts[0], sub, rows=[0, 1], cols=[0, 1])
    assert got.fmt == "sharded"
    assert np.array_equal(host(got), np.asarray(jgrb.assign(
        je[0], jgrb.GBMatrix.from_dense(np.full((2, 2), 5.0, np.float32),
                                        fmt="ell"),
        rows=[0, 1], cols=[0, 1]).to_dense()))


# -- the contract: errors, caches, re-homing -----------------------------------
def test_distribute_rejects_other_storage_and_bad_meshes():
    D = torch.ones((4, 4)) - torch.eye(4)
    mesh = tmesh("mesh222")
    for h in (tgrb.GBMatrix.from_dense(D, fmt="bsr", block=4),
              tgrb.GBMatrix(D)):
        with pytest.raises(TypeError, match="needs ELL or BitELL row"):
            tgrb.distribute(h, mesh)
    with pytest.raises(ValueError, match="'data' axis"):
        tshard.ShardedELL.from_dense(D, cpu_mesh((8, 1), ("rows", "cols")))
    with pytest.raises(TypeError, match="needs a repro_torch"):
        tshard.ShardedELL.from_dense(D, object())
    with pytest.raises(ValueError, match="axis names"):
        Mesh([CPU, CPU], ("data", "model"))


def test_mixed_operands_raise():
    D = torch.from_numpy(np.where(np.random.default_rng(1).random((9, 9))
                                  < 0.3, 1.0, 0.0).astype(np.float32))
    ell = tgrb.GBMatrix.from_dense(D, fmt="ell")
    sh = tgrb.distribute(ell, tmesh("mesh222"))
    other = tgrb.distribute(ell, tmesh("mesh421"))
    with pytest.raises(TypeError, match=r"dense \(k, F\) frontier"):
        tgrb.mxm(sh, ell, S.OR_AND)
    with pytest.raises(TypeError, match="B is sharded but A is not"):
        tgrb.mxm(ell, sh, S.OR_AND)
    with pytest.raises(TypeError, match="operand kinds must match"):
        tgrb.ewise_add(sh, ell, S.PLUS)
    with pytest.raises(TypeError, match="operand kinds must match"):
        tgrb.ewise_mult(ell, sh, lambda a, b: a * b)
    with pytest.raises(TypeError, match="operand kinds must match"):
        tgrb.ewise_add(sh, D, S.PLUS)
    with pytest.raises(TypeError, match="different meshes"):
        tgrb.ewise_add(sh, other, S.PLUS)
    for call in (lambda: tgrb.ewise_add(ell, ell, S.PLUS, out=sh),
                 lambda: tgrb.apply(lambda v: v + 1.0, ell, out=sh),
                 lambda: tgrb.select(lambda v: v > 0.5, ell, out=sh)):
        with pytest.raises(TypeError, match="out= is sharded"):
            call()
    with pytest.raises(TypeError, match="A is sharded but C is not"):
        tgrb.assign(ell, tgrb.distribute(
            tgrb.GBMatrix.from_dense(torch.ones((2, 2)), fmt="ell"),
            tmesh("mesh222")), rows=[0, 1], cols=[0, 1])
    # a dense handle is a dense frontier
    X = torch.ones((9, 2))
    assert torch.equal(tgrb.mxm(sh, tgrb.GBMatrix(X), S.PLUS_TIMES),
                       tgrb.mxm(ell, X, S.PLUS_TIMES))
    # a hand-wrapped ShardedBitELL has no twin for transpose_a
    from repro_torch.core.bitadj import ShardedBitELL
    b = TBitELL.from_coo(*np.nonzero(D.numpy()), None, (9, 9), device="cpu")
    bare = tgrb.GBMatrix(ShardedBitELL.from_bitell(b, tmesh("mesh222")))
    with pytest.raises(RuntimeError, match="linked transpose twin"):
        tgrb.mxm(bare, X, S.OR_AND, tgrb.TRANSPOSE_A)
    with pytest.raises(RuntimeError, match="linked twin"):
        tgrb.mxm_words(bare, tbitmap.pack(X), transpose_a=True)


def test_distribute_caches_per_mesh_and_rehomes():
    g = rmat_graph(7, edge_factor=8, seed=2, fmt="ell", device="cpu")
    A = g.relations["KNOWS"].A
    m1, m2 = tmesh("mesh222"), tmesh("mesh421")
    a = tgrb.distribute(A, m1)
    assert tgrb.distribute(A, m1) is a and tgrb.distribute(a, m1) is a
    assert tgrb.distribute(A, cpu_mesh(*MESHES["mesh222"])) is a  # equal mesh
    b = tgrb.distribute(A, m2)
    assert b is not a and tgrb.distribute(A, m2) is b
    # each shard's kernel forms were built once, at distribute
    assert all(s._plan is not None and s._csr is not None
               for s in a.store.local)
    before = tgrb.host_transfers()
    re = tgrb.distribute(a, m2)
    assert tgrb.host_transfers() > before          # a counted gather
    assert re.fmt == "sharded" and re.store.mesh == m2
    assert re._T is not None and re._T.store.mesh == m2
    X = torch.from_numpy(np.random.default_rng(0).integers(
        0, 3, (g.n, 5)).astype(np.float32))
    assert torch.equal(tgrb.mxm(re, X, S.PLUS_TIMES, tgrb.TRANSPOSE_A),
                       tgrb.mxm(A, X, S.PLUS_TIMES, tgrb.TRANSPOSE_A))
    gb = rmat_graph(7, edge_factor=8, seed=2, fmt="bitadj", device="cpu")
    sb = tgrb.distribute(gb.relations["KNOWS"].A, m1)
    assert all(s._plan is not None for s in sb.store.local)
    # each shard counts its own stored entries; one shard a block
    for st in (a.store, sb.store):
        shards = {id(x): x for x in st.local}.values()
        assert sum(x.nnz for x in shards) == st.nnz > 0
    rb = tgrb.distribute(sb, m2)
    assert rb.fmt == "bitshard" and rb.store.mesh == m2 and rb._T is not None


def test_replicated_blocks_share_one_tensor():
    """Positions on one device holding the same row block share one
    handle: a block replicated over pod x model is one set of tensors."""
    g = rmat_graph(7, edge_factor=8, seed=2, fmt="ell", device="cpu")
    mesh = tmesh("mesh222")
    s = tgrb.distribute(g.relations["KNOWS"].A, mesh).store
    assert len({id(x) for x in s.local}) == mesh.shape["data"]
    xs = M.shard(mesh, torch.arange(16.0).reshape(4, 4), ("data", None))
    assert len({id(x) for x in xs}) == 2
    gathered = M.all_gather(mesh, xs, "data")
    assert all(torch.equal(x, torch.arange(16.0).reshape(4, 4))
               for x in gathered)
    parts = [torch.full((4,), float(i)) for i in range(mesh.size)]
    red = M.psum_scatter(mesh, parts, "data")
    groups = M._groups(mesh, "data")
    for i, r in enumerate(red):
        k = M.axis_index(mesh, "data")[i]
        want = sum(float(j) for j in groups[i])
        assert torch.equal(r, torch.full((2,), want)) and r.shape == (2,)
        assert k in (0, 1)
    assert graph2d.mxm_2d(mesh, S.OR_AND, packed=True) is \
        graph2d.mxm_2d(mesh, S.OR_AND, packed=True)


def test_ell_shard_inputs_match_jax(rmat):
    from repro.distr import graph2d as jgraph2d
    tg, jg = rmat["ell"]
    for sentinel in (False, True):
        for t, j in ((tg.relations["KNOWS"], jg.relations["KNOWS"]),
                     (tg.relations["KNOWS"].A, jg.relations["KNOWS"].A)):
            got = graph2d.ell_shard_inputs(t, sentinel=sentinel)
            want = jgraph2d.ell_shard_inputs(j, sentinel=sentinel)
            for g_, w_ in zip(got, want):
                assert np.array_equal(g_, np.asarray(w_))
    with pytest.raises(TypeError, match="ELL rows"):
        graph2d.ell_shard_inputs(np.zeros((2, 2)))


# -- the executor, the server and the database over a mesh -------------------
QUERIES = [
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [0, 9, 33] "
    "RETURN a, count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..3]-(b) WHERE id(a) IN [1, 2, 3] "
    "RETURN a, count(DISTINCT b)",
    "MATCH (a)<-[:KNOWS*2..3]-(b) WHERE id(a) IN [4, 5] "
    "RETURN count(DISTINCT b)",
]


@pytest.mark.parametrize("fmt", GRAPH_FMTS)
def test_execution_context_mesh(fmt, rmat):
    tg, jg = rmat[fmt]
    for q in QUERIES:
        local = ExecutionContext(tg).run(q)
        for mname in ("mesh222", "mesh421"):
            sharded = ExecutionContext(tg, mesh=tmesh(mname)).run(q)
            assert sharded.columns == local.columns
            assert sharded.rows == local.rows
        assert [tuple(r) for r in jexecute(jg, q).rows] == local.rows


def test_context_mesh_rejects_bsr_graph():
    g = rmat_graph(6, edge_factor=8, seed=1, fmt="bsr", device="cpu")
    ctx = ExecutionContext(g, mesh=tmesh("mesh222"))
    with pytest.raises(TypeError, match="needs ELL or BitELL row"):
        ctx.matrix("KNOWS")


@pytest.mark.parametrize("fmt", GRAPH_FMTS)
def test_query_server_mesh(fmt, rmat):
    tg, _ = rmat[fmt]
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    seeds = range(0, 512, 7)
    solo = QueryServer(tg)
    ids0 = [solo.submit(tmpl, seeds=[s]) for s in seeds]
    want = solo.flush()
    srv = QueryServer(tg, mesh=tmesh("mesh421"))
    ids = [srv.submit(tmpl, seeds=[s]) for s in seeds]
    out = srv.flush()
    assert [out[i].rows for i in ids] == [want[i].rows for i in ids0]
    assert srv.stats["errors"] == 0 and srv.stats["host_transfers"] == 0
    assert srv.stats["batches"] < len(ids)


def test_database_mesh_freezes_compacted_ell():
    db = Database(device="cpu")
    db.query("g", "CREATE (:Person {id: 0}), (:Person {id: 1}), "
                  "(:Person {id: 2}), (:Person {id: 3}), (:Person {id: 4})")
    db.query("g", "CREATE (0)-[:KNOWS]->(1), (1)-[:KNOWS]->(2), "
                  "(2)-[:KNOWS]->(3), (3)-[:KNOWS]->(4), (4)-[:KNOWS]->(0)")
    mesh = tmesh("mesh222")
    q = ("MATCH (a)-[:KNOWS*1..3]->(b) WHERE id(a) = 0 "
         "RETURN count(DISTINCT b)")
    assert db.query("g", q, mesh=mesh).scalar() == db.query("g", q).scalar() \
        == 3
    ctx = db.context("g", mesh=mesh)
    assert ctx.matrix("KNOWS").fmt == "sharded"
    g_local = db.context("g").graph
    g_mesh = db.context("g", mesh=mesh).graph
    assert db.context("g").graph is g_local
    assert db.context("g", mesh=mesh).graph is g_mesh
    m1 = db.context("g", mesh=mesh).matrix("KNOWS")
    assert db.context("g", mesh=mesh).matrix("KNOWS") is m1
    # a write after the freeze: the next mesh read sees it, compacted
    db.query("g", "DELETE (0)-[:KNOWS]->(1)")
    assert db.query("g", q, mesh=mesh).scalar() == 0
    srv = db.server("g", mesh=mesh)
    qid = srv.submit(q)
    assert srv.flush()[qid].rows == [(0,)]
    db.query("g", "CREATE (0)-[:KNOWS]->(2)")         # 0 -> 2 -> 3 -> 4
    qid = srv.submit(q)
    assert srv.flush()[qid].rows == [(3,)] == db.query("g", q).rows


def test_graph_builder_relation_on_mesh():
    """A GraphBuilder graph's linked ELL transpose is sharded beside its
    relation; the weighted SSSP equals the unsharded run."""
    r, c, w = _coo(150, 5, scale=8)
    g = GraphBuilder(150).add_edges("ROAD", r, c, w).build(fmt="ell",
                                                          device="cpu")
    A = g.relations["ROAD"].A
    sh = tgrb.distribute(A, tmesh("mesh421"))
    assert sh.T.T is sh and sh.T.fmt == "sharded"
    seeds = np.arange(8) * 9
    assert torch.equal(TA.sssp(sh, seeds), TA.sssp(A, seeds))

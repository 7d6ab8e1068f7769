"""PyTorch port, BSR slice: storage, the two BSR kernels' plain versions,
the grb dispatch and the k-hop MATCH on BSR, held against the JAX package.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances:
  * storage arrays, plans, indicator and pair products, counts and query
    rows: bit-identical (integers, or floats that hold small integers);
  * bcast (min_plus / max_plus): bit-identical (each output is one a + x,
    picked by min / max; no sum whose order could differ);
  * dot and dot_first with random weights: rtol = atol = 1e-5, for sums of
    at most a few hundred fp32 products taken in another order.
The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsr as jbsr
from repro.core import grb as jgrb
from repro.core import ops as jops
from repro.core import semiring as JS
from repro.core.bsr import BSR as JBSR
from repro.engine import QueryServer as JServer
from repro.graph import datagen as jdatagen
from repro.kernels import ops as jkops
from repro.query.executor import ExecutionContext as JContext
from repro_torch.core import bsr as tbsr
from repro_torch.core import grb as tgrb
from repro_torch.core import ops as tops
from repro_torch.core import semiring as TS
from repro_torch.core.bsr import BSR as TBSR
from repro_torch.engine import QueryServer as TServer
from repro_torch.graph import datagen as tdatagen
from repro_torch.kernels import bsr_mxm as tbsr_mxm
from repro_torch.kernels import bsr_spgemm as tbsr_spgemm
from repro_torch.kernels import ops as tkops
from repro_torch.query.executor import ExecutionContext as TContext

ARRAYS = ("blocks", "block_rows", "block_cols", "first", "last", "valid",
          "row_ptr")
SR_NAMES = ["plus_times", "or_and", "plus_pair", "plus_first", "min_plus",
            "max_plus"]
EXACT_MODES = ("dot_indicator", "dot_pair", "bcast")


def coo(rng, n, m, nnz, empty_rows=(), zeros=0, weighted=True):
    """Random entries (duplicates kept: the last one holds in both builds),
    optionally with no entry in the given block-rows' rows, and with
    ``zeros`` explicit 0.0 weights."""
    r = rng.integers(0, n, size=nnz)
    c = rng.integers(0, m, size=nnz)
    keep = ~np.isin(r, list(empty_rows))
    r, c = r[keep], c[keep]
    v = (rng.uniform(0.5, 2.0, size=len(r)) if weighted
         else np.ones(len(r)))
    v[:zeros] = 0.0
    return r, c, v


def assert_same(jA: JBSR, tA: TBSR):
    """Bit-identical BSR arrays (and emask, nnz, shape)."""
    assert tuple(tA.shape) == tuple(jA.shape) and tA.block == jA.block
    assert tA.nnz == jA.nnz
    for f in ARRAYS:
        a, b = np.asarray(getattr(jA, f)), getattr(tA, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    if jA.emask is None:
        assert tA.emask is None
    else:
        assert np.array_equal(np.asarray(jA.emask), tA.emask.numpy())


def both(r, c, v, shape, block):
    return (JBSR.from_coo(r, c, v, shape, block=block),
            TBSR.from_coo(r, c, v, shape, block=block, device="cpu"))


# (n, m, nnz, block, empty block-rows' rows, explicit zeros)
BUILDS = [(64, 64, 200, 32, (), 0),
          (130, 70, 300, 32, range(32, 64), 0),
          (100, 260, 900, 64, range(0, 64), 3),
          (256, 256, 2000, 64, range(128, 192), 0),
          (96, 96, 0, 32, (), 0),
          (33, 31, 40, 16, (), 1)]


@pytest.mark.parametrize("n,m,nnz,block,empty,zeros", BUILDS)
def test_from_coo_transpose_to_coo_bit_identical(n, m, nnz, block, empty,
                                                 zeros):
    rng = np.random.default_rng(n * m + nnz)
    r, c, v = coo(rng, n, m, nnz, empty, zeros)
    jA, tA = both(r, c, v, (n, m), block)
    assert_same(jA, tA)
    assert_same(jA.transpose(), tA.transpose())
    for a, b in zip(jA.to_coo(), tA.to_coo()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tA.fill_ratio == jA.fill_ratio
    np.testing.assert_array_equal(np.asarray(jA.to_dense()),
                                  tA.to_dense().numpy())
    d = np.asarray(jA.to_dense())
    assert_same(JBSR.from_dense(d, block=block),
                TBSR.from_dense(torch.from_numpy(d.copy()), block=block))


@pytest.mark.parametrize("prune", [True, False])
def test_from_blocks_device_bit_identical(prune):
    rng = np.random.default_rng(5)
    block, nt = 32, 12
    br = np.arange(nt) % 5
    bc = rng.permutation(nt)
    tiles = np.where(rng.uniform(size=(nt, block, block)) < 0.05,
                     rng.uniform(0.5, 2.0, size=(nt, block, block)),
                     0.0).astype(np.float32)
    tiles[[2, 7]] = 0.0                       # pruned (or kept) empty tiles
    shape = (5 * block - 3, nt * block)
    jA = JBSR.from_blocks_device(br, bc, jnp.asarray(tiles), shape, block,
                                 prune=prune)
    tA = TBSR.from_blocks_device(br, bc, torch.from_numpy(tiles), shape,
                                 block, prune=prune)
    assert_same(jA, tA)
    assert_same(JBSR.from_blocks(br, bc, tiles, shape, block, prune=prune),
                TBSR.from_blocks(br, bc, tiles, shape, block, prune=prune,
                                 device="cpu"))


def test_bsr_union_and_reblock_bit_identical():
    rng = np.random.default_rng(11)
    r1, c1, _ = coo(rng, 150, 150, 400, range(64, 96))
    r2, c2, _ = coo(rng, 150, 150, 300)
    a1, t1 = both(r1, c1, None, (150, 150), 32)
    a2, t2 = both(r2, c2, None, (150, 150), 32)
    assert_same(jbsr.bsr_union(a1, a2), tbsr.bsr_union(t1, t2))
    assert_same(jbsr.reblock(a1, 64), tbsr.reblock(t1, 64))


def _plan_equal(p, q):
    for f in ("a_sel", "b_sel", "c_sel", "first", "last", "valid", "c_rows",
              "c_cols"):
        a, b = getattr(p, f), getattr(q, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (p.mask_sel is None) == (q.mask_sel is None)
    if p.mask_sel is not None:
        assert np.array_equal(p.mask_sel, q.mask_sel)


def _spgemm_operands(seed, mask_mode):
    rng = np.random.default_rng(seed)
    ra, ca, va = coo(rng, 150, 110, 500, range(32, 64))
    rb, cb, vb = coo(rng, 110, 90, 400)
    jA, tA = both(ra, ca, va, (150, 110), 32)
    jB, tB = both(rb, cb, vb, (110, 90), 32)
    jM = tM = None
    if mask_mode != "none":
        rm, cm, _ = coo(rng, 150, 90, 2500, range(96, 128))
        jM, tM = both(rm, cm, None, (150, 90), 32)
    return jA, tA, jB, tB, jM, tM


@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
def test_spgemm_symbolic_plans_identical(mask_mode):
    jA, tA, jB, tB, jM, tM = _spgemm_operands(3, mask_mode)
    comp = mask_mode == "complement"
    _plan_equal(jbsr.spgemm_symbolic(jA, jB, jM, comp),
                tbsr.spgemm_symbolic(tA, tB, tM, comp))


@pytest.mark.parametrize("srname", ["plus_times", "or_and", "plus_pair",
                                    "plus_first"])
@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
def test_spgemm_plain_matches_jax_pallas(srname, mask_mode):
    jA, tA, jB, tB, jM, tM = _spgemm_operands(4, mask_mode)
    comp = mask_mode == "complement"
    want = jkops.bsr_spgemm(jA, jB, JS.get(srname), mask=jM, complement=comp,
                            interpret=True)
    before = tbsr_spgemm.launches
    got = tkops.bsr_spgemm(tA, tB, TS.get(srname), mask=tM, complement=comp)
    assert tbsr_spgemm.launches == before        # CPU: the plain version
    for f in ARRAYS[1:]:
        assert np.array_equal(np.asarray(getattr(want, f)),
                              getattr(got, f).numpy()), f
    assert got.nnz == want.nnz
    wb, gb = np.asarray(want.blocks), got.blocks.numpy()
    if TS.get(srname).mode in EXACT_MODES:
        assert np.array_equal(wb, gb)
    else:
        np.testing.assert_allclose(gb, wb, rtol=1e-5, atol=1e-5)


def _mxm_case(seed, n=200, m=150, f=40, block=32, weighted=True):
    rng = np.random.default_rng(seed)
    r, c, v = coo(rng, n, m, 900, range(64, 96), weighted=weighted)
    jA, tA = both(r, c, v, (n, m), block)
    X = np.where(rng.uniform(size=(m, f)) < 0.35,
                 rng.uniform(0.5, 2.0, size=(m, f)), 0.0).astype(np.float32)
    M = (rng.uniform(size=(n, f)) < 0.5).astype(np.float32)
    return jA, tA, X, M


def _close(got, want, sr):
    if sr.mode in EXACT_MODES:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("srname", SR_NAMES)
@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
def test_bsr_mxm_plain_matches_jax(srname, mask_mode):
    """The port's bsr_mxm on CPU tensors (plain version + mask epilogue)
    against the JAX Pallas kernel in interpret mode and against
    ``bsr_mxm_jnp`` + finalize, at n % b != 0, an empty block-row and a
    ragged F."""
    jA, tA, X, M = _mxm_case(21)
    jsr, tsr = JS.get(srname), TS.get(srname)
    comp = mask_mode == "complement"
    mask = None if mask_mode == "none" else M
    before = tbsr_mxm.launches
    got = tkops.bsr_mxm(tA, torch.from_numpy(X), tsr,
                        mask=None if mask is None else torch.from_numpy(mask),
                        complement=comp).numpy()
    assert tbsr_mxm.launches == before
    kern = jkops.bsr_mxm(jA, jnp.asarray(X), jsr,
                         mask=None if mask is None else jnp.asarray(mask),
                         complement=comp, f_tile=32, interpret=True)
    ref = jgrb.finalize(jgrb.Descriptor(mask=mask, complement=comp),
                        jops.bsr_mxm_jnp(jA, jnp.asarray(X), jsr), None,
                        jsr.identity)
    _close(got, np.asarray(kern), tsr)
    _close(got, np.asarray(ref), tsr)


@pytest.mark.parametrize("srname", ["min_plus", "max_plus"])
def test_bsr_mxm_plain_reads_emask(srname):
    """Explicit zero-weight edges: bcast relaxes through them (the emask),
    as ``bsr_mxm_jnp`` does."""
    rng = np.random.default_rng(8)
    r, c, v = coo(rng, 90, 90, 300, zeros=20)
    jA, tA = both(r, c, v, (90, 90), 32)
    assert tA.emask is not None
    X = rng.uniform(0.0, 3.0, size=(90, 7)).astype(np.float32)
    got = tops.bsr_mxm_plain(tA, torch.from_numpy(X), TS.get(srname))
    want = jops.bsr_mxm_jnp(jA, jnp.asarray(X), JS.get(srname))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bsr_mxm_plain_chunks_agree(monkeypatch):
    """The plain version reduces over chunks of tiles; one tile per chunk
    gives the same values as one chunk (integer-valued data)."""
    jA, tA, X, _ = _mxm_case(9, weighted=False)
    Xi = torch.from_numpy((X > 0).astype(np.float32) * 3)
    for srname in SR_NAMES:
        sr = TS.get(srname)
        whole = tops.bsr_mxm_plain(tA, Xi, sr)
        monkeypatch.setattr(tops, "_CHUNK_ENTRIES", 1)
        one = tops.bsr_mxm_plain(tA, Xi, sr)
        monkeypatch.undo()
        assert torch.equal(whole, one), srname


def test_spgemm_plain_chunks_agree(monkeypatch):
    jA, tA, jB, tB, _, _ = _spgemm_operands(6, "none")
    plan = tbsr.spgemm_symbolic(tA, tB)
    for srname in ("or_and", "plus_pair"):
        sr = TS.get(srname)
        whole = tbsr_spgemm.spgemm_blocks_plain(tA.blocks, tB.blocks, plan, sr)
        monkeypatch.setattr(tbsr_spgemm, "_CHUNK_ENTRIES", 1)
        one = tbsr_spgemm.spgemm_blocks_plain(tA.blocks, tB.blocks, plan, sr)
        monkeypatch.undo()
        assert torch.equal(whole, one), srname


def test_run_pointer_bounds_each_output_tile():
    _, tA, _, tB, _, _ = _spgemm_operands(7, "none")
    plan = tbsr.spgemm_symbolic(tA, tB)
    ptr = tbsr_spgemm.run_pointer(plan)
    assert len(ptr) == plan.nc + 1 and ptr[-1] == int(plan.valid.sum())
    for j in range(plan.nc):
        run = plan.c_sel[ptr[j]:ptr[j + 1]]
        assert (run == j).all() and len(run) > 0


# -- grb ---------------------------------------------------------------------
DESCS = [dict(), dict(mask=True), dict(mask=True, complement=True),
         dict(mask=True, accum=True), dict(mask=True, replace=True),
         dict(transpose_a=True, mask=True, complement=True)]


@pytest.mark.parametrize("srname", ["plus_times", "or_and", "min_plus"])
@pytest.mark.parametrize("desc", DESCS, ids=lambda d: "-".join(d) or "null")
def test_grb_mxm_on_bsr_matches_jax(srname, desc):
    rng = np.random.default_rng(13)
    r, c, v = coo(rng, 150, 150, 800, range(32, 64))
    jA, tA = both(r, c, v, (150, 150), 32)
    jh, th = jgrb.GBMatrix(jA), tgrb.GBMatrix(tA)
    assert th.fmt == "bsr" and th.nvals == jh.nvals
    X = (rng.uniform(size=(150, 24)) < 0.2).astype(np.float32)
    M = (rng.uniform(size=(150, 24)) < 0.5).astype(np.float32)
    out = rng.uniform(0, 2, size=(150, 24)).astype(np.float32)
    jsr, tsr = JS.get(srname), TS.get(srname)
    kw = dict(complement=desc.get("complement", False),
              replace=desc.get("replace", False),
              transpose_a=desc.get("transpose_a", False))
    use_out = desc.get("accum") or desc.get("replace")
    jd = jgrb.Descriptor(mask=jnp.asarray(M) if desc.get("mask") else None,
                         accum=jsr.add if desc.get("accum") else None, **kw)
    td = tgrb.Descriptor(mask=torch.from_numpy(M) if desc.get("mask")
                         else None,
                         accum=tsr.add if desc.get("accum") else None, **kw)
    want = jgrb.mxm(jh, jnp.asarray(X), jsr, jd,
                    out=jnp.asarray(out) if use_out else None)
    got = tgrb.mxm(th, torch.from_numpy(X), tsr, td,
                   out=torch.from_numpy(out) if use_out else None)
    _close(got.numpy(), np.asarray(want), tsr)


def test_grb_bsr_routes_and_words_detour():
    rng = np.random.default_rng(17)
    r, c, _ = coo(rng, 100, 100, 500)
    jA, tA = both(r, c, None, (100, 100), 32)
    th = tgrb.GBMatrix(tA)
    assert not tgrb.words_route_ok(th, 512)
    assert not tgrb._packed_route_ok(th, torch.zeros(100, 64), TS.OR_AND)
    X = (rng.uniform(size=(100, 64)) < 0.1).astype(np.float32)
    from repro.core import bitmap as jbitmap
    from repro_torch.core import bitmap as tbitmap
    want = jgrb.mxm_words(jgrb.GBMatrix(jA), jbitmap.pack(jnp.asarray(X)))
    got = tgrb.mxm_words(th, tbitmap.pack(torch.from_numpy(X)))
    assert np.array_equal(np.asarray(want).view(np.uint32),
                          got.numpy().view(np.uint32))


@pytest.mark.parametrize("srname", ["or_and", "plus_times"])
@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
def test_grb_mxm_bsr_times_bsr_matches_jax(srname, mask_mode):
    jA, tA, jB, tB, jM, tM = _spgemm_operands(2, mask_mode)
    comp = mask_mode == "complement"
    want = jgrb.mxm(jgrb.GBMatrix(jA, name="A"), jgrb.GBMatrix(jB, name="B"),
                    JS.get(srname),
                    jgrb.Descriptor(mask=None if jM is None
                                    else jgrb.GBMatrix(jM), complement=comp))
    got = tgrb.mxm(tgrb.GBMatrix(tA, name="A"), tgrb.GBMatrix(tB, name="B"),
                   TS.get(srname),
                   tgrb.Descriptor(mask=None if tM is None
                                   else tgrb.GBMatrix(tM), complement=comp))
    assert got.fmt == "bsr" and got.name == want.name == "(AxB)"
    for f in ARRAYS[1:]:
        assert np.array_equal(np.asarray(getattr(want.store, f)),
                              getattr(got.store, f).numpy()), f
    _close(got.store.blocks.numpy(), np.asarray(want.store.blocks),
           TS.get(srname))
    with pytest.raises(TypeError, match="sparse B"):
        tgrb.mxm(tgrb.GBMatrix(tA), tgrb.GBMatrix(tB), TS.MIN_PLUS)


def test_dense_oracle_matches_jax():
    rng = np.random.default_rng(23)
    A = np.where(rng.uniform(size=(30, 20)) < 0.3,
                 rng.uniform(-1, 2, size=(30, 20)), 0.0).astype(np.float32)
    B = rng.uniform(-1, 2, size=(20, 9)).astype(np.float32)
    B[rng.uniform(size=B.shape) < 0.4] = 0.0
    for name in SR_NAMES:
        jsr, tsr = JS.get(name), TS.get(name)
        want = JS.dense_mxm(JS.structural_dense(jnp.asarray(A), jsr),
                            jnp.asarray(B), jsr)
        got = TS.dense_mxm(TS.structural_dense(torch.from_numpy(A), tsr),
                           torch.from_numpy(B), tsr)
        _close(got.numpy(), np.asarray(want), tsr)


def test_auto_format_picks_bsr_as_jax():
    rng = np.random.default_rng(29)
    n = 256
    r = rng.integers(0, n, size=6000)
    c = (r // 128) * 128 + rng.integers(0, 128, size=6000)   # diagonal tiles
    v = rng.uniform(0.5, 2.0, size=6000)
    want = jops.auto_format(r, c, v, (n, n))
    got = tops.auto_format(r, c, v, (n, n), device="cpu")
    assert isinstance(want, JBSR) and isinstance(got, TBSR)
    assert_same(want, got)


# -- the slice end to end ---------------------------------------------------
QUERIES = [
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [1, 7, 33] RETURN a, count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..3]->(b) WHERE id(a) = 12 RETURN count(DISTINCT b)",
    "MATCH (a)<-[:KNOWS*1..2]-(b) WHERE id(a) = 14 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..2]-(b) WHERE id(a) IN [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11] RETURN a, count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*2..3]->(b) WHERE id(a) = 40 RETURN count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [0, 3, 3] RETURN count(b)",
    "MATCH (a)-[:KNOWS]->(b) WHERE id(a) IN [2, 3] RETURN a, b LIMIT 10",
    "MATCH (a)-[*1..2]->(b) WHERE id(a) = 9 RETURN count(DISTINCT b)",
]
SOCIAL_EXTRA = [
    "MATCH (a:Person)-[:KNOWS*1..3]->(b:Person) WHERE id(a) = 12 AND b.age > 40 RETURN count(DISTINCT b)",
    "MATCH (a:Person)-[:KNOWS]->(b)-[:VISITS]->(c:City) WHERE id(a) = 9 RETURN count(DISTINCT c)",
    "MATCH (a:Person)-[:KNOWS*1..2]->(b) WHERE id(a) IN [3, 3, 5] RETURN count(b)",
    "MATCH (a:City)<-[:VISITS]-(b) RETURN count(DISTINCT b)",
]

_GRAPHS = {}


def graphs(name):
    if name not in _GRAPHS:
        if name == "social":
            _GRAPHS[name] = (jdatagen.social_graph(fmt="bsr"),
                             tdatagen.social_graph(fmt="bsr", device="cpu"))
        else:
            _GRAPHS[name] = (jdatagen.rmat_graph(8, fmt="bsr", block=32),
                             tdatagen.rmat_graph(8, fmt="bsr", block=32,
                                                 device="cpu"))
    return _GRAPHS[name]


@pytest.mark.parametrize("name", ["social", "rmat8"])
def test_graph_storage_bit_identical(name):
    gj, gt = graphs(name)
    for rel in gj.relations:
        a, b = gj.relations[rel].A, gt.relations[rel].A
        assert b.fmt == "bsr" and b.nvals == a.nvals
        assert_same(a.store, b.store)
        assert_same(a.T.store, b.T.store)
        assert_same(a.store.transpose(), b.store.transpose())


@pytest.mark.parametrize("spgemm_expand", [True, False])
@pytest.mark.parametrize("name", ["social", "rmat8"])
def test_execute_matches_jax(name, spgemm_expand):
    gj, gt = graphs(name)
    jc = JContext(gj, spgemm_expand=spgemm_expand)
    tc = TContext(gt, spgemm_expand=spgemm_expand)
    qs = QUERIES + (SOCIAL_EXTRA if name == "social" else [])
    for q in qs:
        want, got = jc.run(q), tc.run(q)
        assert got.columns == want.columns, q
        assert got.rows == want.rows, q
    assert len(tc._hops) == len(jc._hops)
    assert (len(tc._hops) > 0) == spgemm_expand


def test_hop_matrix_matches_jax_and_is_cached():
    gj, gt = graphs("rmat8")
    jc, tc = JContext(gj), TContext(gt)
    P = tc._hop_matrix("KNOWS", True, 2)
    assert tc._hop_matrix("KNOWS", True, 2) is P
    assert_same(jc._hop_matrix("KNOWS", True, 2).store, P.store)


def test_server_batched_equals_solo_and_jax():
    gj, gt = graphs("rmat8")
    tmpl = ["MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)",
            "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(b)",
            "MATCH (a)-[:KNOWS*2..3]-(b) RETURN count(DISTINCT b)"]
    seeds = list(range(0, 256, 7))
    ts, js = TServer(gt), JServer(gj)
    tq = [ts.submit(tmpl[i % 3], seeds=[s]) for i, s in enumerate(seeds)]
    jq = [js.submit(tmpl[i % 3], seeds=[s]) for i, s in enumerate(seeds)]
    tout, jout = ts.flush(), js.flush()
    assert [tout[q].rows for q in tq] == [jout[q].rows for q in jq]
    assert all(tout[q].error is None for q in tq)
    assert ts.stats["batches"] == js.stats["batches"] < len(seeds)
    ctx = TContext(gt)
    for i, (q, s) in enumerate(zip(tq, seeds)):
        solo = ctx.run(tmpl[i % 3].replace("RETURN",
                                           f"WHERE id(a) = {s} RETURN"))
        assert tout[q].rows == solo.rows


def test_server_reports_bsr_kernel_errors_without_retrying(monkeypatch):
    """A BSR batch whose kernel raises KernelError fails every member with
    it; nothing answers the batch another way."""
    from repro_torch.kernels import KernelError

    def broken(*a, **k):
        raise KernelError("launch failed")

    _, gt = graphs("rmat8")
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    ts = TServer(gt)
    good = [ts.submit(tmpl, seeds=[s]) for s in (1, 2, 3)]
    want = ts.flush()
    for fn in ("bsr_mxm", "bsr_spgemm"):
        monkeypatch.setattr(tkops, fn, broken)
    monkeypatch.setattr(tbsr_spgemm, "spgemm_blocks", broken)
    for spgemm_expand in (True, False):
        ts = TServer(gt)
        ts._ctx = TContext(gt, spgemm_expand=spgemm_expand)
        bad = [ts.submit(tmpl, seeds=[s]) for s in (1, 2, 3)]
        out = ts.flush()
        assert ts.pending == 0
        assert all(out[q].error == "KernelError: launch failed" for q in bad)
        assert ts.stats["errors"] == 3
    monkeypatch.undo()
    ts = TServer(gt)
    again = [ts.submit(tmpl, seeds=[s]) for s in (1, 2, 3)]
    out = ts.flush()
    assert [out[q].rows for q in again] == [want[q].rows for q in good]


def test_server_builds_the_hop_matrix_once_across_batches(monkeypatch):
    """The server keeps one ExecutionContext per graph, so its hop matrix
    (one SpGEMM numeric phase for ``*1..2``) is built by the first batch
    and reused by the rest."""
    _, gt = graphs("rmat8")
    calls = []
    real = tbsr_spgemm.spgemm_blocks

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tbsr_spgemm, "spgemm_blocks", counting)
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    ts = TServer(gt, max_width=64)
    qids = [ts.submit(tmpl, seeds=[s]) for s in range(0, 256, 2)]
    out = ts.flush()
    assert all(out[q].error is None for q in qids)
    assert ts.stats["batches"] == 2 and len(calls) == 1

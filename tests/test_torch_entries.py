"""PyTorch port, the stored-entry forms of the BSR handle and the entry
variants of ``bsr_mxm`` and ``bsr_ewise`` on the CPU, held against the JAX
package.

Inputs are Graph500 R-MAT edges (scales 7-9, tiles of 16, 32 and 128) and
seeded numpy values, through both packages. The JAX side runs its
references (``bsr_mxm_jnp``, the XLA gather of ``map_tiles``) and, once
per kernel, its Pallas kernel in interpret mode, as its own suites do.
On the CPU the fill dispatch picks between the two plain versions, so
these tests run the forms, the glue and the lazily built tiles the card
runs. Tolerances: forms, tile lists, tiles and every ``bsr_ewise`` mode
bit for bit (NaN, +-inf and -0.0 included); ``bsr_mxm``'s 0/1 modes and
bcast bit for bit against the JAX package, and every mode bit for bit
between the two plain versions (weights and frontier values are small
multiples of 0.5, so every sum is exact); dot and dot_first against the
JAX package within rtol = atol = 1e-5, the BSR suites' fp32 tolerance.
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
from repro.graph import datagen as jdatagen
from repro.kernels import ops as jkops
from repro_torch.core import bsr as tbsr
from repro_torch.core import grb as tgrb
from repro_torch.core import ops as tops
from repro_torch.core import semiring as TS
from repro_torch.core.bsr import BSR as TBSR
from repro_torch.kernels import bsr_ewise as tkew
from repro_torch.kernels import bsr_mxm as tkmxm

ARRAYS = ("block_rows", "block_cols", "first", "last", "valid", "row_ptr")
SCALES = [(7, 16), (8, 32), (9, 128)]
SR_NAMES = ["plus_times", "or_and", "plus_pair", "plus_first", "min_plus",
            "max_plus"]
EXACT_MODES = ("dot_indicator", "dot_pair", "bcast")
F = 24


def rmat(scale, block, zeros=False, special=False, seed=0):
    """Both builds of a Graph500 R-MAT adjacency (distinct edges) with
    weights in {-1, 0.5, 1, 1.5, 2}; ``zeros``: every 7th an explicit 0.0
    (the emask); ``special``: NaN, +-inf and 1e-30 / -1e-30 (whose
    products underflow to -0.0) among them, except in block-row 0, which
    holds tile 0: the JAX package reads an absent operand tile as tile 0
    times 0 (``test_jax_reads_an_absent_tile_as_tile_zero_times_zero``)."""
    src, dst, n = jdatagen.rmat_edges(scale, 16, seed=seed)
    key = np.unique(src * n + dst)
    r, c = key // n, key % n
    rng = np.random.default_rng(scale + block + seed)
    choices = [-1.0, 0.5, 1.0, 1.5, 2.0]
    if special:
        choices += [np.nan, np.inf, -np.inf, 1e-30, -1e-30]
    v = rng.choice(choices, size=len(r))
    if special:
        v[r < block] = rng.choice([0.5, 1.0, 2.0], size=int((r < block).sum()))
    if zeros:
        v[::7] = 0.0
    return (JBSR.from_coo(r, c, v, (n, n), block=block),
            TBSR.from_coo(r, c, v, (n, n), block=block, device="cpu"))


def bits(x):
    """The fp32 bit patterns, every NaN as one (XLA and torch pick
    different NaN payloads for inf - inf)."""
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), np.int32(0x7FC00000), x.view(np.int32))


def assert_same_handle(j, t):
    """Tile list, nnz and tiles (bit for bit, -0.0 included) of a port
    handle equal the JAX handle's."""
    assert tuple(t.shape) == tuple(j.shape) and t.nnz == j.nnz
    for f in ARRAYS:
        assert np.array_equal(np.asarray(getattr(j, f)),
                              getattr(t, f).numpy()), f
    assert np.array_equal(bits(j.blocks), bits(t.blocks.numpy()))


# -- the forms ----------------------------------------------------------------
@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("scale,block", SCALES)
def test_forms_equal_the_jax_arrays(scale, block, zeros):
    """``row_csr()`` (stored entries, emask'd zeros kept, ascending column
    order, rows by length) and ``entry_form()`` (nonzeros per tile,
    row-major) of a handle equal what the JAX arrays hold."""
    jA, tA = rmat(scale, block, zeros)
    n = jA.shape[0]
    blocks = np.asarray(jA.blocks)
    valid = np.asarray(jA.valid) != 0
    stored = (blocks != 0) if jA.emask is None else np.asarray(jA.emask)
    assert (jA.emask is not None) == zeros
    t, lr, lc = np.nonzero(stored & valid[:, None, None])
    rows = np.asarray(jA.block_rows)[t].astype(np.int64) * block + lr
    cols = np.asarray(jA.block_cols)[t].astype(np.int64) * block + lc
    order = np.lexsort((cols, rows))
    lengths = np.bincount(rows, minlength=n)
    csr = tA.row_csr()
    assert np.array_equal(csr.indptr.numpy(),
                          np.concatenate([[0], np.cumsum(lengths)]))
    assert np.array_equal(csr.cols.numpy(), cols[order])
    assert np.array_equal(bits(csr.vals.numpy()),
                          bits(blocks[t, lr, lc][order]))
    by = csr.order.numpy()
    assert sorted(by.tolist()) == list(range(n))
    assert (np.diff(lengths[by]) <= 0).all()

    flat = blocks.reshape(len(blocks), -1)
    te, p = np.nonzero(flat)
    E = tA.entry_form()
    assert E.entries == len(p)
    assert np.array_equal(E.base.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(te, minlength=len(blocks)))]))
    assert np.array_equal(E.rows.numpy(), p // block)
    assert np.array_equal(E.cols.numpy(), p % block)
    assert np.array_equal(bits(E.vals.numpy()), bits(flat[te, p]))
    per_row = (blocks != 0).sum(axis=2)
    assert np.array_equal(E.row_ptr.numpy()[:, 1:], np.cumsum(per_row, 1))


def test_payload_form_keeps_the_tiles_negative_zeros():
    """A crop of negative values leaves -0.0s in the tiles: the payload
    form holds them (the element-wise kernel's operand), the entry form
    (SpGEMM's) does not."""
    _, tA = rmat(7, 16)
    C = tbsr.extract_ranges(tA, 0, 100, 0, 90)
    negz = int((C.blocks.view(torch.int32) == -2 ** 31).sum())
    assert negz > 0
    assert C.payload_form().entries == C.entry_form().entries + negz
    assert C.entry_form().entries == int((C.blocks != 0).sum())


# -- bsr_mxm's entry variant ----------------------------------------------------
def _mxm_inputs(jA, seed):
    rng = np.random.default_rng(seed)
    m, n = jA.shape[1], jA.shape[0]
    X = np.where(rng.uniform(size=(m, F)) < 0.3,
                 rng.choice([0.5, 1.0, 1.5, 2.0], size=(m, F)),
                 0.0).astype(np.float32)
    M = (rng.uniform(size=(n, F)) < 0.5).astype(np.float32)
    return X, M


def _close(got, want, sr):
    if sr.mode in EXACT_MODES:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("srname", SR_NAMES)
@pytest.mark.parametrize("scale,block", SCALES)
def test_bsr_mxm_entry_plain_matches_jax_and_tile_plain(scale, block,
                                                        srname):
    """The entry plain version (through the dispatch, which picks it at
    R-MAT fill) against ``bsr_mxm_jnp`` + the mask, and bit for bit
    against the tile plain version, with <M> / <!M> and explicit zeros."""
    jA, tA = rmat(scale, block, zeros=True)
    X, M = _mxm_inputs(jA, scale)
    jsr, tsr = JS.get(srname), TS.get(srname)
    base = jops.bsr_mxm_jnp(jA, jnp.asarray(X), jsr)
    for mask, comp in ((None, False), (M, False), (M, True)):
        tm = None if mask is None else torch.from_numpy(mask)
        got = tkmxm.bsr_mxm(tA, torch.from_numpy(X), tsr, mask=tm,
                            complement=comp)
        assert tkmxm.picked == "entry"
        want = jgrb.finalize(jgrb.Descriptor(mask=mask, complement=comp),
                             base, None, jsr.identity)
        _close(got.numpy(), np.asarray(want), tsr)
        tile = tkmxm.mask_epilogue(tops.bsr_mxm_plain(
            tA, torch.from_numpy(X), tsr), tm, comp, tsr.identity)
        assert np.array_equal(bits(got.numpy()), bits(tile.numpy()))


@pytest.mark.parametrize("srname", ["or_and", "plus_pair", "min_plus"])
def test_bsr_mxm_entry_plain_matches_the_pallas_kernel(srname):
    """Against ``repro.kernels.bsr_mxm`` in interpret mode, <!M> (no
    explicit zeros: the Pallas kernel reads no emask, its reference
    does)."""
    jA, tA = rmat(7, 16)
    X, M = _mxm_inputs(jA, 3)
    jsr, tsr = JS.get(srname), TS.get(srname)
    got = tkmxm.bsr_mxm(tA, torch.from_numpy(X), tsr,
                        mask=torch.from_numpy(M), complement=True)
    assert tkmxm.picked == "entry"
    kern = jkops.bsr_mxm(jA, jnp.asarray(X), jsr, mask=jnp.asarray(M),
                         complement=True, f_tile=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))


# -- bsr_ewise's entry variant ----------------------------------------------------
# name -> (JAX callable, port named op); values include NaN, +-inf and
# tiny ones: times and mul(0) give -0.0 results, minus of equal values
# +0.0 ones
OPS = {
    "plus": (lambda a, b: a + b, TS.ewise("plus")),
    "times": (lambda a, b: a * b, TS.ewise("times")),
    "min": (jnp.minimum, TS.ewise("min")),
    "minus": (lambda a, b: a - b, TS.ewise("minus")),
    "second": (lambda a, b: b, TS.ewise("second")),
    "ainv": (lambda a: -a, TS.ewise("ainv")),
    "mul(0)": (lambda a: a * 0.0, TS.ewise("mul", 0.0)),
    "add(-1)": (lambda a: a + -1.0, TS.ewise("add", -1.0)),
    "ge(1)": (lambda a: a >= 1.0, TS.ewise("ge", 1.0)),
    "ne(1)": (lambda a: a != 1.0, TS.ewise("ne", 1.0)),
}
EWISE_CASES = ([("union", o) for o in ("plus", "times", "min", "minus")]
               + [("intersect", o) for o in ("times", "minus", "second")]
               + [("apply", o) for o in ("ainv", "mul(0)", "add(-1)")]
               + [("select", o) for o in ("ge(1)", "ne(1)")]
               + [("mask", None), ("mask_c", None)])


def _ewise(mode, pkg, A, B, op):
    if mode == "union":
        return pkg.ewise_add(A, B, op)
    if mode == "intersect":
        return pkg.ewise_mult(A, B, op)
    if mode == "apply":
        return pkg.apply_stored(A, op)
    if mode == "select":
        return pkg.select_stored(A, op)
    return pkg.mask_keep(A, B, complement=mode == "mask_c")


@pytest.mark.parametrize("scale,block", SCALES)
@pytest.mark.parametrize("mode,opname", EWISE_CASES)
def test_bsr_ewise_entry_plain_matches_jax(mode, opname, scale, block):
    """Each mode through ``core.bsr`` on the entry plain version, bit for
    bit against the JAX package: tile list, nnz and the lazily built
    tiles, NaN, +-inf, -0.0 results and the JAX crop's -0.0s included;
    and the same handle as the tile route's."""
    jA, tA = rmat(scale, block, special=True)
    jB, tB = rmat(scale, block, special=True, seed=1)
    n = jA.shape[0]
    # a crop leaves -0.0s in the tiles, read as absent by every mode
    jA = jbsr.extract_ranges(jA, 0, n - 3, 0, n - 5)
    tA = tbsr.extract_ranges(tA, 0, n - 3, 0, n - 5)
    jB = jbsr.extract_ranges(jB, 0, n - 3, 0, n - 5)
    tB = tbsr.extract_ranges(tB, 0, n - 3, 0, n - 5)
    jop, top = OPS[opname] if opname else (None, None)
    got = _ewise(mode, tbsr, tA, tB, top)
    assert tkew.picked == "entry" and got._blocks is None
    assert_same_handle(_ewise(mode, jbsr, jA, jB, jop), got)


def test_jax_reads_an_absent_tile_as_tile_zero_times_zero():
    """A known difference of the reference: the JAX ``map_tiles`` gathers
    tile 0 for an absent side and multiplies it by a 0/1 presence flag, so
    an absent tile reads NaN where tile 0 holds an inf or NaN (and -0.0
    where it holds a negative value). The port reads +0.0, the absent ==
    0 of ``_tile_fn``, on both routes: here mask_c keeps A's entries where
    B has no tile, which the JAX package turns to 0."""
    jA, tA = rmat(7, 16)
    n = jA.shape[0]
    r = np.array([0, 1, 100, 101], np.int64)
    c = np.array([0, 1, 100, 101], np.int64)
    v = np.array([np.nan, np.inf, 1.0, 2.0])
    jB = JBSR.from_coo(r[:2], c[:2], v[:2], (n, n), block=16)
    tB = TBSR.from_coo(r[:2], c[:2], v[:2], (n, n), block=16, device="cpu")
    got = tbsr.mask_keep(tA, tB, complement=True)
    want = jbsr.mask_keep(jA, jB, complement=True)
    assert tkew.picked == "entry"
    tile = tkew.map_tiles_plain(tA.blocks, *tbsr.ewise_plan(
        "mask_c", tA, tB)[:1], tB.blocks, tbsr.ewise_plan(
        "mask_c", tA, tB)[1], "mask_c")
    assert got.nnz == int((tile != 0).sum())
    assert want.nnz < got.nnz


def test_ewise_entry_keeps_negative_zero_results():
    """mul(0) of negative values and products that underflow are -0.0 in
    the JAX tiles: the entry output keeps them as entries (not stored, so
    not counted), and its built tiles carry their bits."""
    jA, tA = rmat(8, 32, special=True)
    got = tbsr.apply_stored(tA, TS.ewise("mul", 0.0))
    want = jbsr.apply_stored(jA, lambda a: a * 0.0)
    assert got.payload_form().entries > 0 and got.nnz == want.nnz
    assert (got.payload_form().vals == 0).any()
    assert got.to_coo()[0].size == np.count_nonzero(np.asarray(want.blocks))
    assert_same_handle(want, got)


# -- lazy tiles -------------------------------------------------------------------
@pytest.mark.parametrize("scale,block", SCALES)
def test_select_output_builds_no_tiles_until_read(scale, block):
    """``select_stored`` -> ``nvals`` / ``to_coo`` / the forms build no
    tiles; the tile list equals the JAX list, and the first ``.blocks``
    read builds the JAX tiles once."""
    jA, tA = rmat(scale, block)
    pred = TS.ewise("ge", 1.0)
    t0 = tbsr.tile_builds()
    S_ = tgrb.select(pred, tgrb.GBMatrix(tA))
    W = jbsr.select_stored(jA, lambda a: a >= 1.0)
    assert S_.nvals == W.nnz
    r, c, v = S_.store.to_coo()
    wr, wc, wv = W.to_coo()
    assert np.array_equal(r, wr) and np.array_equal(c, wc)
    assert np.array_equal(v, wv)
    S_.store.entry_form()
    S_.store.row_csr()
    for f in ARRAYS:
        assert np.array_equal(np.asarray(getattr(W, f)),
                              getattr(S_.store, f).numpy()), f
    assert tbsr.tile_builds() == t0
    assert np.array_equal(S_.store.blocks.numpy(), np.asarray(W.blocks))
    S_.store.blocks
    assert tbsr.tile_builds() == t0 + 1


def test_ktruss_round_reads_its_operands_as_entries():
    """k-truss feeds each select's entry output to the next SpGEMM: its
    operands are read as entry forms and its mask as tiles, one tile build
    a round, and the truss equals the JAX package's."""
    from repro import algorithms as JA
    from repro_torch import algorithms as TA
    src, dst, n = jdatagen.rmat_edges(9, 16, seed=2)
    keep = src != dst
    s, d = np.r_[src[keep], dst[keep]], np.r_[dst[keep], src[keep]]
    key = np.unique(s * n + d)
    r, c = key // n, key % n
    jA = JBSR.from_coo(r, c, None, (n, n), block=32)
    tA = TBSR.from_coo(r, c, None, (n, n), block=32, device="cpu")
    t0 = tbsr.tile_builds()
    T = TA.ktruss(tgrb.GBMatrix(tA), 4)
    rounds = tbsr.tile_builds() - t0
    want = JA.ktruss(jgrb.GBMatrix(jA), 4)
    assert 1 <= rounds
    for got_a, want_a in zip(T.store.to_coo(), want.store.to_coo()):
        assert np.array_equal(got_a, want_a)


# -- the fill dispatch --------------------------------------------------------------
def test_entry_max_fill_tables_by_side():
    for table in (tgrb.MXM_ENTRY_MAX_FILL, tgrb.EWISE_ENTRY_MAX_FILL):
        assert tgrb.entry_max_fill(table, 16) == table[16]
        assert tgrb.entry_max_fill(table, 20) == table[32]
        assert tgrb.entry_max_fill(table, 128) == table[128]
        assert tgrb.entry_max_fill(table, 256) == table[128]


@pytest.mark.parametrize("kind", ["mxm", "ewise"])
def test_fill_dispatch_picks_each_side(kind, monkeypatch):
    """R-MAT tiles take the entry variant, full tiles the tile variant;
    both give the JAX package's answer."""
    jS, tS = rmat(7, 32)
    dense = np.ones((64, 64))
    dense[::3, ::2] = 2.0
    jD = JBSR.from_dense(dense, block=32)
    tD = TBSR.from_dense(dense, block=32, device="cpu")
    for jA, tA, want in ((jS, tS, "entry"), (jD, tD, "tile")):
        if kind == "mxm":
            X, _ = _mxm_inputs(jA, 5)
            got = tkmxm.bsr_mxm(tA, torch.from_numpy(X), TS.OR_AND)
            assert tkmxm.picked == want
            ref = jops.bsr_mxm_jnp(jA, jnp.asarray(X), JS.OR_AND)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            got = tbsr.select_stored(tA, TS.ewise("ge", 1.5))
            assert tkew.picked == want
            assert_same_handle(
                jbsr.select_stored(jA, lambda a: a >= 1.5), got)

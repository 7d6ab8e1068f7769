"""PyTorch port, ``bsr_spgemm``'s entry form and dispatch on the CPU.

The entry kernel (``csrc/bsr_spgemm_entry.cu``) runs only on the card and
is held there against the plain version and the tile kernel by
``tests/test_torch_cuda.py``. Here: the entry form it reads round-trips
to the tiles exactly; the fill the dispatch reads is ``BSR.fill_ratio``;
a walk over the entry form in the kernel's own order (bands, row ranges,
the mask's row skip) gives the plain version's tiles; CPU tensors take the
plain version whatever the crossover; and the CPU route of ``grb.mxm`` and
``triangle_count`` still equals the JAX package. Tolerances: the entry
form, fills, 0/1 products and counts are exact; plus_times / plus_first
products of random weights rtol = atol = 1e-5 (fp32 sums of a few hundred
terms taken in another order).
"""
import numpy as np
import pytest
import torch

from repro import algorithms as JA
from repro.core import grb as jgrb
from repro.core import semiring as JS
from repro.graph import datagen as jdatagen
from repro.graph.graph import GraphBuilder as JBuilder
from repro_torch import algorithms as TA
from repro_torch.core import bsr as tbsr
from repro_torch.core import grb as tgrb
from repro_torch.core import semiring as TS
from repro_torch.core.bsr import BSR
from repro_torch.graph.graph import GraphBuilder as TBuilder
from repro_torch.kernels import bsr_spgemm as K

BLOCKS = [16, 32, 64, 128]
MODES_SR = ["plus_times", "or_and", "plus_pair", "plus_first"]


def _operand(block, case, seed=0):
    """A (n x n) BSR on the CPU: ``random`` entries; ``zeros`` with explicit
    0.0 weights; ``empty_tiles`` whose tiles are emptied after the build
    (all-zero valid tiles); ``hub`` with one tile holding a full row and a
    full column (b entries each)."""
    rng = np.random.default_rng(seed + block)
    n = 3 * block + 5
    r = rng.integers(0, n, size=8 * block)
    c = rng.integers(0, n, size=8 * block)
    v = rng.uniform(0.5, 2.0, size=r.size)
    if case == "zeros":
        v[::5] = 0.0
    if case == "hub":
        full = np.arange(block)
        r = np.concatenate([r, np.full(block, 2), full])
        c = np.concatenate([c, full, np.full(block, 7)])
        v = np.concatenate([v, rng.uniform(0.5, 2.0, size=2 * block)])
    A = BSR.from_coo(r, c, v, (n, n), block=block, device="cpu")
    if case == "empty_tiles":
        A.blocks[::3] = 0.0
    return A


def _unpack(E: K.EntryForm, nnzb: int) -> torch.Tensor:
    """Scatter an entry form back into (nnzb, b, b) tiles."""
    b = E.block
    out = torch.zeros((nnzb, b, b), dtype=torch.float32)
    t = torch.repeat_interleave(torch.arange(nnzb), E.base[1:] - E.base[:-1])
    out[t, E.rows.long(), E.cols.long()] = E.vals
    return out


@pytest.mark.parametrize("case", ["random", "zeros", "empty_tiles", "hub"])
@pytest.mark.parametrize("block", BLOCKS)
def test_entry_form_round_trips_to_blocks(block, case):
    A = _operand(block, case)
    E = K.entry_form(A.blocks)
    assert torch.equal(_unpack(E, A.nnzb), A.blocks)
    nz = A.blocks != 0
    assert E.entries == int(nz.sum()) == len(E.vals)
    assert E.rows.dtype == E.cols.dtype == torch.uint8
    assert E.row_ptr.dtype == torch.int32 and E.base.dtype == torch.int64
    # each tile row's entries: that row, columns strictly increasing
    for t in range(A.nnzb):
        for i in range(block):
            lo = int(E.base[t] + E.row_ptr[t, i])
            hi = int(E.base[t] + E.row_ptr[t, i + 1])
            assert (E.rows[lo:hi].long() == i).all()
            cols = E.cols[lo:hi].long()
            assert (cols[1:] > cols[:-1]).all()
    # band bit q is set iff a row of band q (i * 32 // b == q) holds one
    occupied = nz.any(dim=2)
    for t in range(A.nnzb):
        want = 0
        for i in torch.nonzero(occupied[t]).flatten().tolist():
            want |= 1 << (i * K.BANDS // block)
        assert int(E.bands[t]) & 0xFFFFFFFF == want


@pytest.mark.parametrize("block", BLOCKS)
def test_entry_form_of_no_tiles(block):
    E = K.entry_form(torch.zeros((0, block, block)))
    assert E.entries == 0
    assert K.operand_fill(K.entry_counts(torch.zeros((0, block, block)))) \
        == 0.0
    assert tuple(E.row_ptr.shape) == (0, block + 1)
    assert E.base.tolist() == [0]


@pytest.mark.parametrize("scale", [7, 9])
@pytest.mark.parametrize("block", BLOCKS)
def test_dispatch_fill_equals_fill_ratio(block, scale):
    """For a BSR of distinct nonzero entries the fill the dispatch reads
    (one operand, or A x A) is ``BSR.fill_ratio``."""
    src, dst, n = jdatagen.rmat_edges(scale, 16, seed=1)
    key = np.unique(src * n + dst)
    A = BSR.from_coo(key // n, key % n, None, (n, n), block=block,
                     device="cpu")
    counts = K.entry_counts(A.blocks)
    fill = K.operand_fill(counts)
    assert fill == pytest.approx(A.fill_ratio, rel=1e-12, abs=0)
    assert K.entry_form(A.blocks, counts).entries == A.nnz


def test_dispatch_fill_of_two_operands():
    A, B = _operand(32, "random", 1), _operand(32, "hub", 2)
    nz = [X.blocks != 0 for X in (A, B)]
    entries = sum(int(z.sum()) for z in nz)
    tiles = sum(int(z.flatten(1).any(dim=1).sum()) for z in nz)
    got = K.operand_fill(K.entry_counts(A.blocks), K.entry_counts(B.blocks))
    assert got == entries / (tiles * 32 * 32)


def _walk(EA, EB, plan, sr, mask_blocks, complement):
    """The entry kernel's walk in numpy, in its order: per output tile, per
    band of rows, the tasks of the run whose A tile has an entry in the
    band, A's entries of the band in (row, column) order, B's row k."""
    b = EA.block
    ptr = plan.cptr.numpy()
    a_sel, b_sel, valid = (plan.a_sel.numpy(), plan.b_sel.numpy(),
                           plan.valid.numpy())
    out = np.zeros((plan.nc, b, b), np.float32)
    mk = 0 if mask_blocks is None else (2 if complement else 1)
    arows, acols = EA.rows.numpy(), EA.cols.numpy()
    avals, bcols, bvals = EA.vals.numpy(), EB.cols.numpy(), EB.vals.numpy()
    for ct in range(plan.nc):
        acc = np.zeros((b, b), np.float32)
        m = None if mk == 0 else mask_blocks[ct].numpy() != 0
        for q in range(K.BANDS):
            r0 = -(-(q * b) // K.BANDS)
            r1 = -(-((q + 1) * b) // K.BANDS)
            if r1 <= r0 or (mk == 1 and not m[r0:r1].any()):
                continue
            for t in range(ptr[ct], ptr[ct + 1]):
                a, bt = a_sel[t], b_sel[t]
                if not valid[t] or not (int(EA.bands[a]) >> q) & 1:
                    continue
                base = int(EA.base[a])
                for e in range(base + int(EA.row_ptr[a, r0]),
                               base + int(EA.row_ptr[a, r1])):
                    i, k, av = arows[e], acols[e], avals[e]
                    if mk == 1 and not m[i].any():
                        continue
                    f0 = int(EB.base[bt]) + int(EB.row_ptr[bt, k])
                    f1 = int(EB.base[bt]) + int(EB.row_ptr[bt, k + 1])
                    for f in range(f0, f1):
                        j = bcols[f]
                        if mk and m[i, j] != (mk == 1):
                            continue
                        if sr.mode == "dot":
                            acc[i, j] = np.float32(av * bvals[f] + acc[i, j])
                        elif sr.mode == "dot_first":
                            acc[i, j] = np.float32(av + acc[i, j])
                        else:
                            acc[i, j] += np.float32(1.0)
        if sr.mode == "dot_indicator":
            acc = (acc > 0).astype(np.float32)
        if mk:
            acc = np.where(m if mk == 1 else ~m, acc, np.float32(0.0))
        out[ct] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("srname", MODES_SR)
@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
def test_entry_walk_matches_plain(mask_mode, srname):
    """The kernel's order over the entry form (bands, the row skip, B's
    rows) gives the plain version's tiles, padding tasks included."""
    A, B = _operand(32, "hub", 3), _operand(32, "zeros", 4)
    rng = np.random.default_rng(5)
    n = A.shape[0]
    M = BSR.from_coo(rng.integers(0, n, 40 * n), rng.integers(0, n, 40 * n),
                     None, (n, n), block=32, device="cpu")
    mask = None if mask_mode == "none" else M
    comp = mask_mode == "complement"
    plan = tbsr.spgemm_symbolic(A, B, mask, comp, pad_to=64)
    assert (plan.valid == 0).any()
    mb = None if mask is None else plan.mask_tiles(M)
    sr = TS.get(srname)
    got = _walk(K.entry_form(A.blocks), K.entry_form(B.blocks), plan, sr,
                mb, comp)
    want = K.spgemm_blocks_plain(A.blocks, B.blocks, plan, sr, mb, comp)
    if sr.mode in ("dot_indicator", "dot_pair"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("limit", [0.0, 0.08, 1.01])
def test_cpu_tiles_take_the_plain_version(limit, monkeypatch):
    """Whatever the crossover would pick on the card, CPU tiles take the
    plain version and launch nothing."""
    monkeypatch.setattr(K, "entry_max_fill", lambda b: limit)
    A, B = _operand(32, "random", 6), _operand(32, "random", 7)
    plan = tbsr.spgemm_symbolic(A, B)
    before = (K.launches, K.launches_entry, K.launches_tile)
    got = K.spgemm_blocks(A.blocks, B.blocks, plan, TS.PLUS_PAIR)
    assert (K.launches, K.launches_entry, K.launches_tile) == before
    want = K.spgemm_blocks_plain(A.blocks, B.blocks, plan, TS.PLUS_PAIR)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,side", [(1, 16), (16, 16), (17, 32), (32, 32),
                                    (33, 64), (64, 64), (100, 128),
                                    (128, 128)])
def test_entry_max_fill_takes_the_next_measured_side(b, side):
    """A tile side between two measured ones takes the larger side's
    crossover; the crossover falls as tiles grow."""
    assert K.entry_max_fill(b) == K.ENTRY_MAX_FILL[side]
    sides = sorted(K.ENTRY_MAX_FILL)
    assert sides[-1] == K.MAX_BLOCK
    assert all(K.ENTRY_MAX_FILL[x] > K.ENTRY_MAX_FILL[y]
               for x, y in zip(sides, sides[1:]))


def test_kernel_entry_points_reject_cpu_tensors():
    """The two kernels' own entry points never run a plain version: CPU
    tensors raise, launching nothing."""
    A = _operand(32, "random", 8)
    plan = tbsr.spgemm_symbolic(A, A)
    E = K.entry_form(A.blocks)
    before = (K.launches, K.launches_entry, K.launches_tile)
    with pytest.raises(ValueError):
        K.spgemm_entry(E, E, plan, TS.OR_AND)
    with pytest.raises(ValueError):
        K.spgemm_tile(A.blocks, A.blocks, plan, TS.OR_AND)
    assert (K.launches, K.launches_entry, K.launches_tile) == before


def _undirected(scale):
    src, dst, n = jdatagen.rmat_edges(scale, 16, seed=0)
    keep = src != dst
    s, d = src[keep], dst[keep]
    return np.concatenate([s, d]), np.concatenate([d, s]), n


@pytest.mark.parametrize("scale", [8, 9])
def test_triangle_count_on_128_tiles_matches_jax(scale):
    s, d, n = _undirected(scale)
    jg = JBuilder(n).add_edges("KNOWS", s, d).build(fmt="bsr", block=128)
    tg = TBuilder(n).add_edges("KNOWS", s, d).build(fmt="bsr", block=128,
                                                    device="cpu")
    before = K.launches
    got = int(TA.triangle_count(tg, "KNOWS"))
    assert K.launches == before
    assert got == int(JA.triangle_count(jg, "KNOWS"))


@pytest.mark.parametrize("srname", MODES_SR)
@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
def test_grb_mxm_cpu_route_matches_jax(mask_mode, srname):
    """grb.mxm of two BSR handles (the SpGEMM route) with <A> / <!A> on an
    undirected R-MAT scale-8 graph at b = 128, against the JAX package."""
    s, d, n = _undirected(8)
    w = np.random.default_rng(9).integers(1, 4, size=s.size).astype(
        np.float64)
    jg = JBuilder(n).add_edges("KNOWS", s, d, w).build(fmt="bsr", block=128)
    tg = TBuilder(n).add_edges("KNOWS", s, d, w).build(fmt="bsr", block=128,
                                                       device="cpu")
    jA, tA = jg.relations["KNOWS"].A, tg.relations["KNOWS"].A
    comp = mask_mode == "complement"
    jd = (jgrb.NULL if mask_mode == "none"
          else jgrb.Descriptor(mask=jA, complement=comp))
    td = (tgrb.NULL if mask_mode == "none"
          else tgrb.Descriptor(mask=tA, complement=comp))
    J = jgrb.mxm(jA, jA, JS.get(srname), jd)
    T = tgrb.mxm(tA, tA, TS.get(srname), td)
    assert T.fmt == "bsr"
    jr, jc, jv = (np.asarray(x) for x in J.store.to_coo())
    tr, tc, tv = T.store.to_coo()
    assert np.array_equal(jr, tr) and np.array_equal(jc, tc)
    # integer weights: every sum is exact, so the values agree exactly
    assert np.array_equal(np.asarray(jv, np.float32), tv)

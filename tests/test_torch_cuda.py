"""PyTorch port on the card: each hand-written CUDA kernel against its plain
PyTorch version (the masked dot SpGEMM also against the CPU route and the
tile route at the Graph Challenge's scales 14 and 15), the k-hop slice (ELL, BitELL and BSR) on a CUDA graph
against the same slice on the CPU, the analytics (triangles, k-truss,
similarity) and the remaining algorithms (BFS, k-hop, SSSP, PageRank, WCC,
centrality, label propagation) on the card against the CPU,
``CALL algo.*`` through the server on the card, and the mesh: meshes of
4 and 16 positions on one card, the word kernels run on every shard, the
k-hop and PageRank probes of ``distr.graph2d`` and ``any_pair`` on each
storage kind; and the models' serving path: tiny models' prefill and
decode on the card against the CPU (float32, atol 1e-4), in-place cache
writes, and ``launch.serve`` on the card by default; and the training
path: train steps on the card against the CPU, remat on against off, the
bfloat16 checkpoint round trip on card tensors, and ``launch.train`` on
the card by default and raising without one; and the dry-run's counters
on card tensors against the same runs on meta tensors.

Every test here is marked ``cuda`` and skips when no card is present (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so on a machine with a card and without JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Everything compared is integer or boolean: ``torch.equal``, bit for bit,
except the BSR kernels' weighted modes and the float algorithms, PageRank
and betweenness (tolerance stated beside them).
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.core import bitadj, ops
from repro_torch.core import bsr as bsr_mod, ell as ell_mod, semiring as S
from repro_torch.core.bitadj import BitELL
from repro_torch.core.bsr import BSR
from repro_torch.core.ell import ELL
from repro_torch.engine import QueryServer
from repro_torch.graph import datagen
from repro_torch.graph.graph import GraphBuilder
from repro_torch.kernels import (bitadj_mxv, bitmap_mxv, bsr_dot, bsr_ewise,
                                 bsr_mxm, bsr_spgemm)
from repro_torch.query import execute

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _cuda_gate(request):
    """Tests marked `cuda` need a card; decided per test, never at import."""
    if (request.node.get_closest_marker("cuda") is not None
            and not torch.cuda.is_available()):
        pytest.skip("cuda: needs an NVIDIA GPU (the CUDA kernels have no "
                    "CPU mode); run on the card")


def _words(rng, k, w):
    x = rng.integers(0, 2 ** 32, size=(k, w), dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).cuda()


def _coo(rng, n, k, m):
    """Skewed panels: rows of the first panel reach every column tile, the
    others keep to one, so BitELL has sentinel slots; row 0 stays empty."""
    r = rng.integers(1, n, size=m)
    c = rng.integers(0, k, size=m)
    C = -(-k // 32)
    c = np.where(r >= 32, np.minimum((r // 32 % C) * 32 + c % 32, k - 1), c)
    return r, c


CASES = [(45, 70, 1), (45, 70, 16), (64, 64, 1), (100, 33, 16),
         (33, 100, 2), (1000, 999, 16), (64, 64, 300)]


@pytest.mark.parametrize("n,k,w", CASES)
def test_ell_kernel_matches_plain(n, k, w):
    rng = np.random.default_rng(n + w)
    r, c = _coo(rng, n, k, 6 * n)
    A = ELL.from_coo(r, c, None, (n, k), device="cuda")
    xw = _words(rng, k, w)
    before = bitmap_mxv.launches
    got = bitmap_mxv.ell_mxv_packed(A, xw)
    torch.cuda.synchronize()
    assert bitmap_mxv.launches == before + 1
    assert torch.equal(got, ops.ell_mxm_packed(A, xw))


@pytest.mark.parametrize("n,k,w", CASES)
def test_bitadj_kernel_matches_plain(n, k, w):
    rng = np.random.default_rng(n + w)
    r, c = _coo(rng, n, k, 6 * n)
    A = BitELL.from_coo(r, c, None, (n, k), device="cuda")
    xw = _words(rng, k, w)
    before = bitadj_mxv.launches
    got = bitadj_mxv.bitadj_mxv_packed(A, xw)
    torch.cuda.synchronize()
    assert bitadj_mxv.launches > before
    assert torch.equal(got, bitadj.mxm_words(A, xw))


def test_wrappers_reject_mixed_devices():
    rng = np.random.default_rng(0)
    r, c = _coo(rng, 64, 64, 200)
    e = ELL.from_coo(r, c, None, (64, 64), device="cuda")
    b = BitELL.from_coo(r, c, None, (64, 64), device="cuda")
    xw = _words(rng, 64, 2).cpu()
    with pytest.raises(ValueError, match="device"):
        bitmap_mxv.ell_mxv_packed(e, xw)
    with pytest.raises(ValueError, match="device"):
        bitadj_mxv.bitadj_mxv_packed(b, xw)


# (storage, query, whether the word route launches a kernel): ELL packs
# only frontiers at least grb.AUTO_PACK_MIN_WIDTH wide; walk counts
# (count without DISTINCT) take the float route on both kinds
SLICE = [
    ("ell", "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [1, 7, 33] "
            "RETURN a, count(DISTINCT b)", False),
    ("ell", "MATCH (a)-[:KNOWS*1..3]-(b) WHERE id(a) IN "
            "[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11] RETURN a, count(DISTINCT b)",
     True),
    ("ell", "MATCH (a)<-[:KNOWS*2..3]-(b) WHERE id(a) IN [0, 3, 3] "
            "RETURN count(b)", False),
    ("bitadj", "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) = 5 "
               "RETURN count(DISTINCT b)", True),
    ("bitadj", "MATCH (a)-[:KNOWS*2..3]-(b) WHERE id(a) IN [2, 3] "
               "RETURN a, b LIMIT 20", True),
]


@pytest.mark.parametrize("fmt,q,kernel", SLICE)
def test_slice_on_cuda_matches_cpu(fmt, q, kernel):
    gc = datagen.rmat_graph(9, fmt=fmt, device="cuda")
    gh = datagen.rmat_graph(9, fmt=fmt, device="cpu")
    l0 = bitmap_mxv.launches + bitadj_mxv.launches
    assert execute(gc, q).rows == execute(gh, q).rows
    assert (bitmap_mxv.launches + bitadj_mxv.launches > l0) == kernel


@pytest.mark.parametrize("fmt", ["ell", "bitadj"])
def test_server_on_cuda_matches_cpu(fmt):
    gc = datagen.rmat_graph(9, fmt=fmt, device="cuda")
    gh = datagen.rmat_graph(9, fmt=fmt, device="cpu")
    tmpl = ["MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)",
            "MATCH (a)-[:KNOWS*2..3]->(b) RETURN count(DISTINCT b)"]
    results = []
    for g in (gc, gh):
        srv = QueryServer(g)
        qids = [srv.submit(tmpl[s % 2], seeds=[s]) for s in range(0, 512, 3)]
        out = srv.flush()
        assert all(out[q].error is None for q in qids)
        results.append([out[q].rows for q in qids])
    assert results[0] == results[1]


def _shuffle_slots(rng, store):
    """The same structure with the slots of every row (ELL) or panel
    (BitELL) in random order, so padding sits between valid slots."""
    if isinstance(store, ELL):
        order = torch.from_numpy(np.argsort(
            rng.random(tuple(store.indices.shape)), axis=1)).cuda()
        return ELL(store.shape, store.indices.gather(1, order),
                   store.mask.gather(1, order), store.values.gather(1, order),
                   store.nnz)
    order = torch.from_numpy(np.argsort(
        rng.random(tuple(store.cols.shape)), axis=1)).cuda()
    return BitELL(store.shape, store.tiles.gather(
        1, order[:, :, None].expand(-1, -1, 32)).contiguous(),
        store.cols.gather(1, order).contiguous(), store.nnz)


@pytest.mark.parametrize("n,k,w", [(45, 70, 1), (100, 33, 16),
                                   (1000, 999, 16)])
def test_kernels_match_plain_on_unordered_slots(n, k, w):
    rng = np.random.default_rng(n * w)
    r, c = _coo(rng, n, k, 6 * n)
    xw = _words(rng, k, w)
    e = _shuffle_slots(rng, ELL.from_coo(r, c, None, (n, k), device="cuda"))
    b = _shuffle_slots(rng, BitELL.from_coo(r, c, None, (n, k),
                                            device="cuda"))
    got_e = bitmap_mxv.ell_mxv_packed(e, xw)
    got_b = bitadj_mxv.bitadj_mxv_packed(b, xw)
    torch.cuda.synchronize()
    assert torch.equal(got_e, ops.ell_mxm_packed(e, xw))
    assert torch.equal(got_b, bitadj.mxm_words(b, xw))


# -- the edge-balanced word kernels on adversarial shapes ---------------------
# n = 1000 is not a multiple of 32. ELL: rows of exactly 256 ids between
# empty rows put empty rows on item boundaries, then a hub row of 20,000
# ids and random rows. BitELL: panel 0 reaches 4,200 column tiles (a hub
# panel of more than 4K occupied slots), other panels one, and k is not a
# multiple of 32, so the frontier has fewer rows than C*32.
WORD_WIDTHS = [1, 3, 16, 17, 300]


def _adversarial_coo(rng, n, k):
    blocks = [(r, rng.choice(k, 256, replace=False)) for r in (1, 3, 5)]
    blocks.append((6, rng.choice(k, 20_000, replace=False)))
    r = rng.integers(8, n, size=4 * n)
    c = rng.integers(0, k, size=4 * n)
    rows = np.concatenate([np.full(len(ids), row) for row, ids in blocks]
                          + [r])
    cols = np.concatenate([ids for _, ids in blocks] + [c])
    keep = ~np.isin(rows, [500, 501, 999])
    return rows[keep], cols[keep]


@pytest.mark.parametrize("w", WORD_WIDTHS)
def test_ell_items_kernel_on_adversarial_shapes(w):
    rng = np.random.default_rng(w)
    n, k = 1000, 30_001
    r, c = _adversarial_coo(rng, n, k)
    A = ELL.from_coo(r, c, None, (n, k), device="cuda")
    xw = _words(rng, k, w)
    want = ops.ell_mxm_packed(A, xw)
    before = bitmap_mxv.launches
    got = bitmap_mxv.ell_mxv_packed(A, xw)
    torch.cuda.synchronize()
    assert bitmap_mxv.launches == before + 1
    assert torch.equal(got, want)
    csr = A.row_csr()
    starts = csr.row_ptr[:-1][csr.row_ptr.diff() == 0]
    assert bool((starts % A.item_plan().L == 0).any())  # empty on a boundary
    for L in (1, 5, 256, 4096):
        got = bitmap_mxv.ell_mxv_items(csr, ell_mod.item_plan(csr, L), xw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), L


@pytest.mark.parametrize("w", WORD_WIDTHS)
def test_bitadj_items_kernel_on_adversarial_shapes(w):
    rng = np.random.default_rng(100 + w)
    n, k = 1000, 4200 * 32 - 7
    hub_c = np.minimum(np.arange(4200)[:, None] * 32
                       + rng.integers(0, 32, size=(4200, 2)), k - 1).ravel()
    hub_r = rng.integers(0, 32, size=hub_c.shape[0])
    r = rng.integers(32, n, size=4 * n)
    c = (r // 32) * 32 + rng.integers(0, 32, size=4 * n)
    rows, cols = np.concatenate([hub_r, r]), np.concatenate([hub_c, c])
    keep = ~np.isin(rows // 32, [5, 6])             # two empty panels
    A = BitELL.from_coo(rows[keep], cols[keep], None, (n, k), device="cuda")
    plan = A.slot_plan()
    assert plan.hub_slots > 4096 and plan.split_panels >= 1
    for xrows in (k, k - 1000):                     # fewer rows than C*32
        xw = _words(rng, xrows, w)
        want = bitadj.mxm_words(A, xw)
        before = bitadj_mxv.launches
        got = bitadj_mxv.bitadj_mxv_packed(A, xw)
        torch.cuda.synchronize()
        assert bitadj_mxv.launches == before + 1
        assert torch.equal(got, want)
        tiles, cols_ = A.occupied_first()
        for K in (1, 3, 64, 8192):
            plan = bitadj.slot_plan(cols_, n, A.n_ctiles, K)
            got = bitadj_mxv.bitadj_mxv_items(tiles, cols_, plan, xw,
                                              A.shape)
            torch.cuda.synchronize()
            assert torch.equal(got, want), K


def test_word_plans_on_cuda_equal_cpu():
    rng = np.random.default_rng(5)
    r, c = _adversarial_coo(rng, 1000, 30_001)
    for kind in (ELL, BitELL):
        on = kind.from_coo(r, c, None, (1000, 30_001), device="cuda")
        off = kind.from_coo(r, c, None, (1000, 30_001), device="cpu")
        if kind is ELL:
            for a, b in zip(on.row_csr(), off.row_csr()):
                assert torch.equal(a.cpu(), b)
            pa, pb = on.item_plan(), off.item_plan()
            pairs = [(pa.edge_rows, pb.edge_rows), (pa.zero_rows, pb.zero_rows)]
        else:
            pa, pb = on.slot_plan(), off.slot_plan()
            pairs = [(pa.items, pb.items), (pa.zero_rows, pb.zero_rows)]
        for a, b in pairs:
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("fmt", ["ell", "bitadj"])
def test_server_reports_a_kernel_that_cannot_load(fmt, monkeypatch):
    """A kernel that fails to build or load fails its batches: every query
    reports the KernelError and none is answered through another route."""
    from repro_torch.kernels import KernelError, build

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bitmap_mxv, "_bound", None)
    monkeypatch.setattr(bitadj_mxv, "_bound", None)
    g = datagen.rmat_graph(9, fmt=fmt, device="cuda")
    srv = QueryServer(g)
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    qids = [srv.submit(tmpl, seeds=[s]) for s in range(0, 512, 5)]
    out = srv.flush()
    assert srv.pending == 0
    assert all("KernelError" in (out[q].error or "") for q in qids)
    assert srv.stats["errors"] == len(qids)


# -- BSR: kernels bsr_mxm and bsr_spgemm ---------------------------------------
# Indicator, pair and bcast results are compared bit for bit (0/1 counts,
# or one a + x picked by min / max); dot and dot_first with random weights
# allow fp32 reordering only: rtol = atol = 1e-5 for sums of a few hundred
# products. The plain versions run their products with TF32 off.
SEMIRINGS = ["plus_times", "or_and", "plus_pair", "plus_first", "min_plus",
             "max_plus"]


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _bsr_coo(rng, n, m, nnz, empty_rows=(), zeros=0):
    r = rng.integers(0, n, size=nnz)
    c = rng.integers(0, m, size=nnz)
    keep = ~np.isin(r, list(empty_rows))
    r, c = r[keep], c[keep]
    v = rng.uniform(0.5, 2.0, size=len(r))
    v[:zeros] = 0.0
    return r, c, v


def _same(got, want, sr):
    if sr.mode in ("dot_indicator", "dot_pair", "bcast"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (n, m, F, block, rows left empty, explicit zeros): n % b != 0, ragged F,
# empty block-rows, a non-square matrix, 128-tiles
BSR_CASES = [(200, 150, 40, 32, range(64, 96), 0),
             (130, 70, 1, 32, (), 0),
             (300, 260, 130, 64, range(0, 64), 5),
             (520, 400, 100, 128, range(128, 256), 0),
             (33, 31, 7, 16, (), 1)]


@pytest.mark.parametrize("srname", SEMIRINGS)
@pytest.mark.parametrize("n,m,f,block,empty,zeros", BSR_CASES)
def test_bsr_mxm_kernel_matches_plain(n, m, f, block, empty, zeros, srname,
                                      no_tf32):
    rng = np.random.default_rng(n + f)
    r, c, v = _bsr_coo(rng, n, m, 6 * n, empty, zeros)
    A = BSR.from_coo(r, c, v, (n, m), block=block, device="cuda")
    X = torch.from_numpy(np.where(
        rng.uniform(size=(m, f)) < 0.35, rng.uniform(0.5, 2.0, size=(m, f)),
        0.0).astype(np.float32)).cuda()
    M = torch.from_numpy((rng.uniform(size=(n, f)) < 0.5).astype(
        np.float32)).cuda()
    sr = S.get(srname)
    for mask, comp in ((None, False), (M, False), (M, True)):
        before = bsr_mxm.launches
        got = bsr_mxm.bsr_mxm(A, X, sr, mask=mask, complement=comp)
        torch.cuda.synchronize()
        assert bsr_mxm.launches == before + 1
        want = bsr_mxm.mask_epilogue(ops.bsr_mxm_plain(A, X, sr), mask,
                                     comp, sr.identity)
        _same(got, want, sr)


@pytest.mark.parametrize("srname", ["plus_times", "or_and", "plus_pair",
                                    "plus_first"])
@pytest.mark.parametrize("block", [32, 128])
def test_bsr_spgemm_kernel_matches_plain(srname, block, no_tf32):
    rng = np.random.default_rng(block)
    n, k, m = 3 * block + 5, 2 * block + 9, 3 * block - 7
    ra, ca, va = _bsr_coo(rng, n, k, 40 * block, range(block, 2 * block))
    rb, cb, vb = _bsr_coo(rng, k, m, 30 * block)
    rm, cm, _ = _bsr_coo(rng, n, m, 200 * block)
    A = BSR.from_coo(ra, ca, va, (n, k), block=block, device="cuda")
    B = BSR.from_coo(rb, cb, vb, (k, m), block=block, device="cuda")
    Mk = BSR.from_coo(rm, cm, None, (n, m), block=block, device="cuda")
    sr = S.get(srname)
    for mask, comp in ((None, False), (Mk, False), (Mk, True)):
        plan = bsr_mod.spgemm_symbolic(A, B, mask, comp)
        mb = None if mask is None else plan.mask_tiles(mask)
        before = bsr_spgemm.launches
        got = bsr_spgemm.spgemm_blocks(A.blocks, B.blocks, plan, sr,
                                       mask_blocks=mb, complement=comp)
        torch.cuda.synchronize()
        assert bsr_spgemm.launches == before + 1
        want = bsr_spgemm.spgemm_blocks_plain(A.blocks, B.blocks, plan, sr,
                                              mb, comp)
        _same(got, want, sr)


# -- bsr_spgemm's two kernels: entry against plain and against tile ----------
# The entry kernel sums each output element's terms in the tile kernel's
# (task, k) order and only skips terms with a zero factor, so the two agree
# bit for bit in every mode; against the plain version (batched products,
# then index_add) the 0/1 modes agree bit for bit and plus_times /
# plus_first within rtol = atol = 1e-5 (fp32 sums of a few hundred terms
# taken in another order).
SPGEMM_SR = ["plus_times", "or_and", "plus_pair", "plus_first"]


def _spgemm_inputs(block, seed, hub=False, device="cuda"):
    """A (n x k) with an empty band of block-rows, B (k x m), a mask; n, k,
    m ragged. ``hub``: tile (0, 0) of A gets a full row and a full column,
    and B's first row of tiles a full row, so a tile row holds b entries
    and a B row b distinct columns."""
    rng = np.random.default_rng(seed)
    n, k, m = 3 * block + 5, 2 * block + 9, 3 * block - 7
    ra, ca, va = _bsr_coo(rng, n, k, 12 * block, range(block, 2 * block))
    rb, cb, vb = _bsr_coo(rng, k, m, 10 * block)
    if hub:
        full = np.arange(block)
        ra = np.concatenate([ra, np.full(block, 3), full])
        ca = np.concatenate([ca, full, np.full(block, 5)])
        va = np.concatenate([va, rng.uniform(0.5, 2.0, size=2 * block)])
        rb = np.concatenate([rb, np.full(block, 5)])
        cb = np.concatenate([cb, full])
        vb = np.concatenate([vb, rng.uniform(0.5, 2.0, size=block)])
    rm, cm, _ = _bsr_coo(rng, n, m, 60 * block)
    A = BSR.from_coo(ra, ca, va, (n, k), block=block, device=device)
    B = BSR.from_coo(rb, cb, vb, (k, m), block=block, device=device)
    Mk = BSR.from_coo(rm, cm, None, (n, m), block=block, device=device)
    return A, B, Mk


def _mask_tiles(plan, mask):
    return None if mask is None else plan.mask_tiles(mask)


@pytest.mark.parametrize("srname", SPGEMM_SR)
@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
@pytest.mark.parametrize("block,hub", [(16, False), (32, False), (64, True),
                                       (128, True)])
def test_bsr_spgemm_entry_matches_plain_and_tile(block, hub, mask_mode,
                                                 srname, no_tf32):
    A, B, Mk = _spgemm_inputs(block, block + len(srname), hub)
    mask = None if mask_mode == "none" else Mk
    comp = mask_mode == "complement"
    # pad_to=64: the plan ends in padding tasks (valid == 0)
    plan = bsr_mod.spgemm_symbolic(A, B, mask, comp, pad_to=64)
    assert (plan.valid == 0).any()
    mb = _mask_tiles(plan, mask)
    sr = S.get(srname)
    EA, EB = bsr_spgemm.entry_form(A.blocks), bsr_spgemm.entry_form(B.blocks)
    before = (bsr_spgemm.launches, bsr_spgemm.launches_entry)
    got = bsr_spgemm.spgemm_entry(EA, EB, plan, sr, mask_blocks=mb,
                                  complement=comp)
    again = bsr_spgemm.spgemm_entry(EA, EB, plan, sr, mask_blocks=mb,
                                    complement=comp)
    tile = bsr_spgemm.spgemm_tile(A.blocks, B.blocks, plan, sr,
                                  mask_blocks=mb, complement=comp)
    torch.cuda.synchronize()
    assert (bsr_spgemm.launches, bsr_spgemm.launches_entry) == (
        before[0] + 3, before[1] + 2)
    want = bsr_spgemm.spgemm_blocks_plain(A.blocks, B.blocks, plan, sr, mb,
                                          comp)
    _same(got, want, sr)
    assert torch.equal(got, tile)
    assert torch.equal(got, again)


def test_bsr_spgemm_entry_form_on_cuda_equals_cpu():
    A, _, _ = _spgemm_inputs(128, 3, hub=True)
    fc = bsr_spgemm.entry_form(A.blocks)
    fh = bsr_spgemm.entry_form(A.blocks.cpu())
    for f in ("base", "row_ptr", "rows", "cols", "vals", "bands"):
        assert torch.equal(getattr(fc, f).cpu(), getattr(fh, f)), f
    assert fc.entries == fh.entries


# -- the symbolic plan on the card ---------------------------------------------
PLAN_TENSORS = ("a_sel", "b_sel", "valid", "cptr", "c_rows", "c_cols")


def _plan_on(plan, device):
    """``plan`` with its tensors copied to ``device``: the route that plans
    on the host and copies the plan up."""
    moved = {f: getattr(plan, f).to(device) for f in PLAN_TENSORS}
    return dataclasses.replace(
        plan, **moved,
        mask_sel=None if plan.mask_sel is None else plan.mask_sel.to(device))


@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
@pytest.mark.parametrize("block,hub", [(16, False), (32, False), (64, True),
                                       (128, True)])
def test_bsr_spgemm_plan_on_cuda_equals_cpu(block, hub, mask_mode):
    """The plan built on the card is the one built on the host for the same
    handles, tensor for tensor (the CPU plan is held to the JAX package's
    by the CPU tests)."""
    comp = mask_mode == "complement"
    plans = []
    for device in ("cuda", "cpu"):
        A, B, Mk = _spgemm_inputs(block, block + 1, hub, device=device)
        plans.append(bsr_mod.spgemm_symbolic(
            A, B, None if mask_mode == "none" else Mk, comp, pad_to=64))
    got, want = plans
    assert got.tasks == want.tasks > 0 and got.ntasks == want.ntasks
    for f in PLAN_TENSORS + ("mask_sel",):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert g.device.type == "cuda" and g.dtype == w.dtype, f
            assert torch.equal(g.cpu(), w), f


@pytest.mark.parametrize("srname", ["plus_pair", "plus_times"])
@pytest.mark.parametrize("mask_mode", ["none", "mask", "complement"])
def test_bsr_spgemm_on_cuda_equals_the_host_planned_route(mask_mode, srname,
                                                          no_tf32):
    """``core.bsr.spgemm`` on the card (plan and output tile list laid out
    there) gives, bit for bit, the handle of the route that planned on the
    host, copied the plan up and laid the output out from host
    coordinates."""
    A, B, Mk = _spgemm_inputs(128, 7, hub=True)
    hA, hB, hM = _spgemm_inputs(128, 7, hub=True, device="cpu")
    comp = mask_mode == "complement"
    mask, hmask = (None, None) if mask_mode == "none" else (Mk, hM)
    sr = S.get(srname)
    got = bsr_mod.spgemm(A, B, sr, mask, comp)
    plan = _plan_on(bsr_mod.spgemm_symbolic(hA, hB, hmask, comp), "cuda")
    tiles = bsr_spgemm.spgemm_blocks(A, B, plan, sr,
                                     mask_blocks=_mask_tiles(plan, mask),
                                     complement=comp)
    want = BSR.from_blocks_device(plan.c_rows.cpu().numpy(),
                                  plan.c_cols.cpu().numpy(), tiles,
                                  (A.shape[0], B.shape[1]), A.block)
    assert got.nnz == want.nnz > 0
    for f in ("blocks", "block_rows", "block_cols", "first", "last", "valid",
              "row_ptr"):
        assert getattr(got, f).device.type == "cuda", f
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_bsr_spgemm_call_copies_nothing_up():
    """A masked SpGEMM on the card copies nothing to it: no ``h2d`` copy at
    all (none tagged ``plan`` or ``mask_sel``); its plan reads two counts
    through core.xfer, 24 bytes."""
    from repro_torch import tracing
    from repro_torch.core import xfer
    A, B, Mk = _spgemm_inputs(128, 9, hub=True)
    bsr_mod.spgemm(A, B, S.PLUS_PAIR, Mk)        # the entry forms, once
    torch.cuda.synchronize()
    was = tracing.enabled()
    tracing.clear()
    tracing.enable()
    try:
        c0, p0 = xfer.copies(), bsr_mod.plan_host_copies
        for comp in (False, True):
            bsr_mod.spgemm(A, B, S.PLUS_PAIR, Mk, comp)
        torch.cuda.synchronize()
        c1, recs = xfer.copies(), tracing.records()
    finally:
        tracing.clear()
        (tracing.enable if was else tracing.disable)()
    assert not [r for r in recs if r.name == "h2d"
                and r.attrs["tag"] in ("plan", "mask_sel")]
    assert c1["h2d_copies"] == c0["h2d_copies"]
    assert c1["h2d_bytes"] == c0["h2d_bytes"]
    assert bsr_mod.plan_host_copies - p0 == 4
    assert c1["d2h_bytes"] - c0["d2h_bytes"] == 2 * (8 + 16)


@pytest.mark.parametrize("limit,variant", [(0.0, "tile"), (1.01, "entry")])
def test_bsr_spgemm_dispatch_picks_by_fill(limit, variant, monkeypatch):
    """Under the crossover (``entry_max_fill``) the entry kernel runs, at or
    above it the tile kernel; A x A builds one entry form; both give the
    plain answer."""
    monkeypatch.setattr(bsr_spgemm, "entry_max_fill", lambda b: limit)
    A, B, Mk = _spgemm_inputs(32, 11)
    rng = np.random.default_rng(11)
    r, c, v = _bsr_coo(rng, 200, 200, 900, range(64, 96))
    Q = BSR.from_coo(r, c, v, (200, 200), block=32, device="cuda")
    for X, Y, M in ((A, B, Mk), (Q, Q, None)):
        plan = bsr_mod.spgemm_symbolic(X, Y, M)
        mb = _mask_tiles(plan, M)
        e0, t0 = bsr_spgemm.launches_entry, bsr_spgemm.launches_tile
        got = bsr_spgemm.spgemm_blocks(X.blocks, Y.blocks, plan, S.PLUS_PAIR,
                                       mask_blocks=mb)
        torch.cuda.synchronize()
        took = {"entry": bsr_spgemm.launches_entry - e0,
                "tile": bsr_spgemm.launches_tile - t0}
        assert took == {"entry": int(variant == "entry"),
                        "tile": int(variant == "tile")}
        want = bsr_spgemm.spgemm_blocks_plain(X.blocks, Y.blocks, plan,
                                              S.PLUS_PAIR, mb)
        assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["entry", "tile"])
def test_bsr_spgemm_kernel_failure_raises(variant, monkeypatch):
    """A variant that fails to launch or to load raises KernelError; the
    other variant and the plain version are never taken."""
    from repro_torch.kernels import KernelError, build
    A, B, _ = _spgemm_inputs(32, 13)
    plan = bsr_mod.spgemm_symbolic(A, B)
    attr = "_bound_entry" if variant == "entry" else "_bound"
    monkeypatch.setattr(bsr_spgemm, "entry_max_fill",
                        lambda b: 1.01 if variant == "entry" else 0.0)
    before = (bsr_spgemm.launches, bsr_spgemm.launches_entry,
              bsr_spgemm.launches_tile)
    monkeypatch.setattr(bsr_spgemm, attr, lambda *a: 700)  # cudaError 700
    with pytest.raises(KernelError):
        bsr_spgemm.spgemm_blocks(A.blocks, B.blocks, plan, S.OR_AND)

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bsr_spgemm, attr, None)
    with pytest.raises(KernelError):
        bsr_spgemm.spgemm_blocks(A.blocks, B.blocks, plan, S.OR_AND)
    assert (bsr_spgemm.launches, bsr_spgemm.launches_entry,
            bsr_spgemm.launches_tile) == before


# -- the masked dot SpGEMM (csrc/bsr_spgemm_dot.cu) ----------------------------
# Weights are multiples of 0.5 in [-1, 2], so every sum the tests reach is
# exact in float32 and the kernel, its plain version (float64 sums) and the
# tile route agree bit for bit in every mode.
def _challenge(scale, device, weighted=False):
    """The Graph Challenge's undirected Graph500 R-MAT at ``scale`` (loops
    dropped, both directions, duplicates merged, ids permuted), as a BSR
    handle of 128-tiles on ``device`` and its transpose."""
    src, dst, n = datagen.rmat_edges(scale, 16, seed=0)
    keep = src != dst
    perm = np.random.default_rng(scale).permutation(n)
    s = perm[np.concatenate([src[keep], dst[keep]])]
    d = perm[np.concatenate([dst[keep], src[keep]])]
    key = np.unique(s * n + d)
    r, c = key // n, key % n
    v = (np.random.default_rng(scale + 1).choice(
        [-1.0, 0.5, 1.0, 1.5, 2.0], size=len(r)) if weighted else None)
    A = BSR.from_coo(r, c, v, (n, n), block=128, device=device)
    return A, A.transpose()


@pytest.mark.parametrize("scale,srname", [(14, "plus_times"),
                                          (14, "or_and"),
                                          (14, "plus_pair"),
                                          (14, "plus_first"),
                                          (15, "plus_pair")])
def test_bsr_spgemm_dot_on_cuda_equals_the_cpu_route(scale, srname):
    """``core.bsr.spgemm_dot`` on the card (the kernel) gives the handle the
    CPU gives (the plain version), bit for bit: tile list, nnz and the
    held entries; no tile is built on either side."""
    sr = S.get(srname)
    weighted = sr.mode in ("dot", "dot_first")
    out = []
    for device in ("cuda", "cpu"):
        A, At = _challenge(scale, device, weighted)
        b0, k0 = bsr_mod.tile_builds(), bsr_dot.launches
        out.append(bsr_mod.spgemm_dot(A, A, sr, A, Bt=At))
        assert bsr_mod.tile_builds() == b0
        assert bsr_dot.launches == k0 + (device == "cuda")
    got, want = out
    torch.cuda.synchronize()
    assert got.nnz == want.nnz > 0 and not got.holds_tiles
    for f in ("block_rows", "block_cols", "first", "last", "valid",
              "row_ptr"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    g, w = got.row_csr(), want.row_csr()
    assert torch.equal(g.indptr.cpu(), w.indptr)
    assert torch.equal(g.cols.cpu(), w.cols)
    assert torch.equal(g.vals.cpu().view(torch.int32), w.vals.view(torch.int32))


@pytest.mark.parametrize("srname", SPGEMM_SR)
def test_bsr_spgemm_dot_equals_the_tile_route_on_cuda(srname):
    """At scale 14 (the tile route's output stack is 1 GB) the two routes
    on the card give the same handle, tiles built from the dot route's
    entries included."""
    sr = S.get(srname)
    A, At = _challenge(14, "cuda", sr.mode in ("dot", "dot_first"))
    got = bsr_mod.spgemm_dot(A, A, sr, A, Bt=At)
    want = bsr_mod.spgemm(A, A, sr, mask=A)
    torch.cuda.synchronize()
    _same_handle(got, want)


def test_bsr_spgemm_dot_long_lists_empty_rows_and_ties():
    """Hub rows far longer than a unit's 128 walked elements (split over
    units in the 0/1 modes, walked by one warp in the valued ones), rows
    and mask entries with nothing to meet, lists of equal length, and an
    empty mask: every mode equals the plain version on the CPU."""
    rng = np.random.default_rng(5)
    n = 3000
    r = np.concatenate([np.zeros(2500, np.int64), rng.integers(0, n, 6000),
                        np.full(700, 7)])
    c = np.concatenate([rng.permutation(n)[:2500], rng.integers(0, n, 6000),
                        rng.permutation(n)[:700]])
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    v = rng.choice([-1.0, 0.5, 1.0, 1.5, 2.0], size=len(r))
    mr = np.concatenate([np.zeros(300, np.int64), np.full(300, 7),
                         rng.integers(0, n, 3000)])
    mc = rng.integers(0, n, len(mr))
    for srname in SPGEMM_SR:
        sr = S.get(srname)
        out = []
        for device in ("cuda", "cpu"):
            A = BSR.from_coo(r, c, v, (n, n), block=128, device=device)
            M = BSR.from_coo(mr, mc, None, (n, n), block=128, device=device)
            E = BSR.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             None, (n, n), block=128, device=device)
            out.append((bsr_mod.spgemm_dot(A, A.transpose(), sr, M),
                        bsr_mod.spgemm_dot(A, A, sr, E)))
        (got, got_e), (want, want_e) = out
        assert got_e.nnz == want_e.nnz == 0
        assert got.nnz == want.nnz > 0
        g, w = got.row_csr(), want.row_csr()
        assert torch.equal(g.cols.cpu(), w.cols), srname
        assert torch.equal(g.vals.cpu(), w.vals), srname


def test_triangle_call_at_scale_15_equals_scipy_and_builds_no_tile():
    """``CALL algo.triangles`` through the server on the Graph Challenge's
    scale-15 graph on the card (entry-held BSR) gives scipy's count and
    builds no tile."""
    import scipy.sparse as sp
    src, dst, n = datagen.rmat_edges(15, 16, seed=0)
    keep = src != dst
    s = np.concatenate([src[keep], dst[keep]])
    d = np.concatenate([dst[keep], src[keep]])
    g = GraphBuilder(n).add_edges("KNOWS", s, d).build(fmt="bsr",
                                                       device="cuda")
    b0 = bsr_mod.tile_builds()
    srv = QueryServer(g)
    qid = srv.submit("CALL algo.triangles(rel: KNOWS)")
    res = srv.flush()[qid]
    assert res.error is None
    A = sp.csr_matrix((np.ones(len(s)), (s, d)), shape=(n, n))
    A.data[:] = 1.0
    want = int((A @ A).multiply(A).sum()) // 6
    assert int(res.scalar()) == want
    assert bsr_mod.tile_builds() == b0
    assert srv.stats["dot_entries"] == A.nnz


BSR_SLICE = [
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN [1, 7, 33] "
    "RETURN a, count(DISTINCT b)",
    "MATCH (a)-[:KNOWS*1..3]-(b) WHERE id(a) IN [0, 1, 2, 3] "
    "RETURN a, count(DISTINCT b)",
    "MATCH (a)<-[:KNOWS*2..3]-(b) WHERE id(a) IN [0, 3, 3] RETURN count(b)",
    "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) = 5 RETURN a, b LIMIT 20",
]


@pytest.mark.parametrize("spgemm_expand", [True, False])
def test_bsr_slice_on_cuda_matches_cpu(spgemm_expand):
    from repro_torch.query.executor import ExecutionContext
    gc = datagen.rmat_graph(9, fmt="bsr", device="cuda")
    gh = datagen.rmat_graph(9, fmt="bsr", device="cpu")
    cc = ExecutionContext(gc, spgemm_expand=spgemm_expand)
    ch = ExecutionContext(gh, spgemm_expand=spgemm_expand)
    m0, s0 = bsr_mxm.launches, bsr_spgemm.launches
    for q in BSR_SLICE:
        assert cc.run(q).rows == ch.run(q).rows, q
    assert bsr_mxm.launches > m0
    assert (bsr_spgemm.launches > s0) == spgemm_expand


def test_bsr_server_on_cuda_launches_and_matches_cpu():
    gc = datagen.rmat_graph(9, fmt="bsr", device="cuda")
    gh = datagen.rmat_graph(9, fmt="bsr", device="cpu")
    tmpl = ["MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)",
            "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(b)"]
    results = []
    m0, s0 = bsr_mxm.launches, bsr_spgemm.launches
    for g in (gc, gh):
        srv = QueryServer(g)
        qids = [srv.submit(tmpl[s % 2], seeds=[s]) for s in range(0, 512, 3)]
        out = srv.flush()
        assert all(out[q].error is None for q in qids)
        results.append([out[q].rows for q in qids])
    assert results[0] == results[1]
    assert bsr_mxm.launches > m0 and bsr_spgemm.launches > s0


def test_bsr_server_reports_a_kernel_that_cannot_load(monkeypatch):
    """A BSR kernel that fails to build or load fails its batches: every
    query reports the KernelError, none is answered another way."""
    from repro_torch.kernels import KernelError, build

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bsr_mxm, "_bound", None)
    monkeypatch.setattr(bsr_mxm, "_bound_entry", None)
    monkeypatch.setattr(bsr_spgemm, "_bound", None)
    monkeypatch.setattr(bsr_spgemm, "_bound_entry", None)
    g = datagen.rmat_graph(9, fmt="bsr", device="cuda")
    tmpl = ["MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)",
            "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(b)"]
    srv = QueryServer(g)
    qids = [srv.submit(tmpl[s % 2], seeds=[s]) for s in range(0, 512, 5)]
    out = srv.flush()
    assert srv.pending == 0
    assert all("KernelError" in (out[q].error or "") for q in qids)
    assert srv.stats["errors"] == len(qids)


# -- bsr_mxm's two kernels: entry against plain and against tile ------------
# The entry kernel folds each output element's terms in the tile kernel's
# (tile, column) order with the same operations and skips only entries A
# does not store, so the two agree bit for bit in every mode for finite X;
# against the entry plain version (a gather and index_add) the 0/1 modes
# and bcast agree bit for bit and dot / dot_first within the tolerance of
# ``_same``.
@pytest.mark.parametrize("srname", SEMIRINGS)
@pytest.mark.parametrize("n,m,f,block,empty,zeros", BSR_CASES)
def test_bsr_mxm_entry_matches_plain_and_tile(n, m, f, block, empty, zeros,
                                              srname, no_tf32):
    rng = np.random.default_rng(n + f + 1)
    r, c, v = _bsr_coo(rng, n, m, 6 * n, empty, zeros)
    A = BSR.from_coo(r, c, v, (n, m), block=block, device="cuda")
    X = torch.from_numpy(np.where(
        rng.uniform(size=(m, f)) < 0.35, rng.uniform(0.5, 2.0, size=(m, f)),
        0.0).astype(np.float32)).cuda()
    M = torch.from_numpy((rng.uniform(size=(n, f)) < 0.5).astype(
        np.float32)).cuda()
    sr = S.get(srname)
    csr = A.row_csr()
    for mask, comp in ((None, False), (M, False), (M, True)):
        before = (bsr_mxm.launches_entry, bsr_mxm.launches_tile)
        got = bsr_mxm.bsr_mxm_entry(csr, X, sr, mask=mask, complement=comp)
        tile = bsr_mxm.bsr_mxm_tile(A, X, sr, mask=mask, complement=comp)
        torch.cuda.synchronize()
        assert (bsr_mxm.launches_entry, bsr_mxm.launches_tile) == (
            before[0] + 1, before[1] + 1)
        plain = bsr_mxm.mask_epilogue(
            bsr_mxm.bsr_mxm_entry_plain(csr, X, sr), mask, comp, sr.identity)
        _same(got, plain, sr)
        assert torch.equal(got, tile), (srname, mask is not None, comp)


@pytest.mark.parametrize("f", [1, 130, 512])
def test_bsr_mxm_entry_long_rows_match_plain_and_tile(f, no_tf32):
    """Rows past ``LONG_ROW`` (hubs of 300 and 900 entries, one a full
    block-row) take the entry kernel's 32-column slices; the rest its wide
    slices: both equal the tile kernel bit for bit in every mode."""
    rng = np.random.default_rng(25 + f)
    n, m = 600, 900
    r, c, v = _bsr_coo(rng, n, m, 3000, (), 4)
    hub_c = np.r_[rng.choice(m, 300, replace=False), np.arange(m)]
    r = np.r_[r, np.full(300, 7), np.full(m, 450)]
    c = np.r_[c, hub_c]
    v = np.round(np.r_[v, rng.uniform(0.5, 2.0, size=300 + m)] * 2)
    A = BSR.from_coo(r, c, v, (n, m), block=128, device="cuda")
    csr = A.row_csr()
    assert csr.rows_at_least(bsr_mxm.LONG_ROW) == 2
    X = torch.from_numpy(np.where(
        rng.uniform(size=(m, f)) < 0.35, rng.integers(1, 4, size=(m, f)),
        0).astype(np.float32)).cuda()
    M = torch.from_numpy((rng.uniform(size=(n, f)) < 0.5).astype(
        np.float32)).cuda()
    for srname in SEMIRINGS:
        sr = S.get(srname)
        for mask, comp in ((None, False), (M, True)):
            got = bsr_mxm.bsr_mxm_entry(csr, X, sr, mask=mask,
                                        complement=comp)
            tile = bsr_mxm.bsr_mxm_tile(A, X, sr, mask=mask,
                                        complement=comp)
            plain = bsr_mxm.mask_epilogue(bsr_mxm.bsr_mxm_entry_plain(
                csr, X, sr), mask, comp, sr.identity)
            torch.cuda.synchronize()
            assert torch.equal(got, tile), (srname, comp)
            assert torch.equal(got, plain), (srname, comp)


def test_bsr_mxm_row_csr_on_cuda_equals_cpu():
    rng = np.random.default_rng(21)
    r, c, v = _bsr_coo(rng, 300, 260, 1800, range(0, 64), 5)
    for f in ("indptr", "cols", "vals", "order"):
        got = getattr(BSR.from_coo(r, c, v, (300, 260), block=64,
                                   device="cuda").row_csr(), f)
        want = getattr(BSR.from_coo(r, c, v, (300, 260), block=64,
                                    device="cpu").row_csr(), f)
        assert torch.equal(got.cpu(), want), f


@pytest.mark.parametrize("limit,variant", [(0.0, "tile"), (1.01, "entry")])
def test_bsr_mxm_dispatch_picks_by_fill(limit, variant, monkeypatch):
    monkeypatch.setattr(bsr_mxm, "entry_max_fill", lambda b: limit)
    rng = np.random.default_rng(22)
    r, c, v = _bsr_coo(rng, 200, 150, 900, range(64, 96))
    A = BSR.from_coo(r, c, v, (200, 150), block=32, device="cuda")
    X = torch.from_numpy(rng.integers(0, 3, size=(150, 70)).astype(
        np.float32)).cuda()
    e0, t0 = bsr_mxm.launches_entry, bsr_mxm.launches_tile
    got = bsr_mxm.bsr_mxm(A, X, S.PLUS_PAIR)
    torch.cuda.synchronize()
    assert bsr_mxm.picked == variant
    assert (bsr_mxm.launches_entry - e0, bsr_mxm.launches_tile - t0) == (
        int(variant == "entry"), int(variant == "tile"))
    assert torch.equal(got, ops.bsr_mxm_plain(A, X, S.PLUS_PAIR))


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_bsr_mxm_non_finite_frontier_takes_the_tile_kernel(bad, no_tf32):
    """A dot product over an X holding an inf or NaN: the tile kernel
    multiplies A's absent zeros (0 * inf = NaN) as the JAX package does,
    the entry kernel would skip them; the dispatch sends it to the tile
    kernel and says so, and the result equals the plain version, NaN
    positions included. The 0/1 modes stay on the entry kernel."""
    rng = np.random.default_rng(23)
    r, c, v = _bsr_coo(rng, 200, 150, 900, (), 3)
    v = np.round(v * 2)                            # integer weights: exact
    A = BSR.from_coo(r, c, v, (200, 150), block=32, device="cuda")
    Xh = rng.integers(0, 3, size=(150, 40)).astype(np.float32)
    Xh[5, 3] = Xh[77, 0] = bad
    X = torch.from_numpy(Xh).cuda()
    got = bsr_mxm.bsr_mxm(A, X, S.PLUS_TIMES)
    torch.cuda.synchronize()
    assert bsr_mxm.picked == "tile (non-finite)"
    want = ops.bsr_mxm_plain(A, X, S.PLUS_TIMES)
    assert torch.isnan(want).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    bsr_mxm.bsr_mxm(A, X, S.OR_AND)
    assert bsr_mxm.picked == "entry"


@pytest.mark.parametrize("variant", ["entry", "tile"])
def test_bsr_mxm_kernel_failure_raises(variant, monkeypatch):
    """A variant that fails to launch or to load raises KernelError; the
    other variant and the plain version are never taken."""
    from repro_torch.kernels import KernelError, build
    rng = np.random.default_rng(24)
    r, c, v = _bsr_coo(rng, 200, 150, 900)
    A = BSR.from_coo(r, c, v, (200, 150), block=32, device="cuda")
    X = torch.ones((150, 8), device="cuda")
    attr = "_bound_entry" if variant == "entry" else "_bound"
    monkeypatch.setattr(bsr_mxm, "entry_max_fill",
                        lambda b: 1.01 if variant == "entry" else 0.0)
    before = (bsr_mxm.launches, bsr_mxm.launches_entry,
              bsr_mxm.launches_tile)
    monkeypatch.setattr(bsr_mxm, attr, lambda *a: 700)   # cudaError 700
    with pytest.raises(KernelError):
        bsr_mxm.bsr_mxm(A, X, S.OR_AND)

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bsr_mxm, attr, None)
    with pytest.raises(KernelError):
        bsr_mxm.bsr_mxm(A, X, S.OR_AND)
    assert (bsr_mxm.launches, bsr_mxm.launches_entry,
            bsr_mxm.launches_tile) == before


# -- bsr_spgemm on non-finite payloads -----------------------------------------
@pytest.mark.parametrize("bad", [np.inf, np.nan])
@pytest.mark.parametrize("srname", ["plus_times", "plus_first"])
def test_bsr_spgemm_non_finite_payload_takes_the_tile_kernel(bad, srname,
                                                             no_tf32):
    """An inf (or a NaN) in B's tiles next to a stored 0 and an absent
    entry of A's (plus_times), or in A's tiles against B's absent entries
    (plus_first): the tile kernel and the plain version multiply whole
    tiles, so those products are NaN; the entry kernel skips them. The
    dispatch sends the product to the tile kernel and says so. Under
    plus_times the result equals the plain version, NaN positions
    included; under plus_first (where cuBLAS's batched product and the
    tile kernel's fmaf chain meet inf * 0 differently) it equals the
    tile kernel's, which holds the NaNs the entry kernel does not."""
    b = 32
    ra = np.array([0, 0, 1, 2], np.int64)
    ca = np.array([0, 1, 1, 3], np.int64)
    va = np.array([0.0, 2.0, 1.0, 3.0])              # A[0, 0] stored 0
    rb = np.array([0, 1, 1, 3, 5], np.int64)
    cb = np.array([4, 4, 6, 6, 7], np.int64)
    vb = np.array([bad, 1.0, 2.0, 1.0, 1.0])         # B[0, 4] meets A's 0
    if srname == "plus_first":
        va = np.array([0.0, bad, 1.0, 3.0])
        vb = np.array([1.0, 1.0, 2.0, 1.0, 1.0])
    A = BSR.from_coo(ra, ca, va, (b, b), block=b, device="cuda")
    B = BSR.from_coo(rb, cb, vb, (b, b), block=b, device="cuda")
    plan = bsr_mod.spgemm_symbolic(A, B)
    sr = S.get(srname)
    got = bsr_spgemm.spgemm_blocks(A, B, plan, sr)
    torch.cuda.synchronize()
    assert bsr_spgemm.picked == "tile (non-finite)"
    want = bsr_spgemm.spgemm_blocks_plain(A.blocks, B.blocks, plan, sr)
    assert torch.isnan(want).any()
    if srname == "plus_first":
        want = bsr_spgemm.spgemm_tile(A.blocks, B.blocks, plan, sr)
        skipped = bsr_spgemm.spgemm_entry(A.entry_form(), B.entry_form(),
                                          plan, sr)
        assert int(torch.isnan(skipped).sum()) < int(torch.isnan(want).sum())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    # the tile stacks take the same guard
    got_t = bsr_spgemm.spgemm_blocks(A.blocks, B.blocks, plan, sr)
    assert bsr_spgemm.picked == "tile (non-finite)"
    torch.testing.assert_close(got_t, want, rtol=0, atol=0, equal_nan=True)
    bsr_spgemm.spgemm_blocks(A, B, plan, S.PLUS_PAIR)
    assert bsr_spgemm.picked == "entry"


# -- BSR element-wise: kernel bsr_ewise ----------------------------------------
# Every mode is a select, a single fp32 op or a copy on each entry, so the
# kernel and the plain version agree bit for bit.
EWISE_OPS = {
    "union": [S.ewise(n) for n in ("plus", "times", "min", "max", "first",
                                   "second", "pair", "minus")],
    "intersect": [S.ewise(n) for n in ("plus", "times", "min", "minus")],
    "apply": [S.ewise("identity"), S.ewise("ainv"), S.ewise("abs"),
              S.ewise("one"), S.ewise("mul", 0.3), S.ewise("add", -1.0),
              S.ewise("gt", 0.0)],
    "select": [S.ewise(n, s) for n, s in (("ge", 1.0), ("gt", 0.0),
                                          ("le", -1.0), ("lt", 0.5),
                                          ("eq", 1.0), ("ne", 1.0),
                                          ("ge", 9.0))],
    "mask": [None],
    "mask_c": [None],
}


def _ewise_operands(rng, nblocks, b, T):
    """Tiles with values in {+-0.5 .. +-2} at 30% density, some all-zero,
    and T selectors per side with absent (-1) slots on both sides."""
    dense = rng.choice([-2, -1, -0.5, 0.5, 1, 2], size=(nblocks, b, b))
    keep = rng.uniform(size=(nblocks, b, b)) < 0.3
    tiles = np.where(keep, dense, 0.0).astype(np.float32)
    tiles[::7] = 0.0
    sa = rng.integers(-1, nblocks, size=T).astype(np.int32)
    sb = rng.integers(-1, nblocks, size=T).astype(np.int32)
    return torch.from_numpy(tiles).cuda(), sa, sb


@pytest.mark.parametrize("mode", list(EWISE_OPS))
@pytest.mark.parametrize("b,T", [(32, 1), (32, 97), (64, 40), (128, 33),
                                 (33, 20), (128, 0)])
def test_bsr_ewise_kernel_matches_plain(mode, b, T):
    rng = np.random.default_rng(b + T)
    A, sa, sb = _ewise_operands(rng, 12, b, T)
    B, _, _ = _ewise_operands(rng, 9, b, 1)
    sb = np.minimum(sb, 8)
    unary = mode in bsr_ewise.UNARY_MODES
    for op in EWISE_OPS[mode]:
        before = bsr_ewise.launches
        got = bsr_ewise.map_tiles(A, sa, None if unary else B,
                                  None if unary else sb, mode, op)
        torch.cuda.synchronize()
        assert bsr_ewise.launches == before + (1 if T else 0)
        want = bsr_ewise.map_tiles_plain(A, sa, B, sb, mode, op)
        assert got.shape == (T, b, b) and torch.equal(got, want), (mode, op)


def test_bsr_ewise_kernel_on_empty_and_absent_operands():
    """An operand with no tiles, and a side absent everywhere."""
    rng = np.random.default_rng(3)
    A, sa, _ = _ewise_operands(rng, 6, 32, 50)
    empty = torch.zeros((0, 32, 32), device="cuda")
    none = np.full(50, -1, np.int32)
    for mode in ("union", "intersect", "mask", "mask_c"):
        op = EWISE_OPS[mode][0]
        got = bsr_ewise.map_tiles(A, sa, empty, none, mode, op)
        want = bsr_ewise.map_tiles_plain(A, sa, empty, none, mode, op)
        assert torch.equal(got, want), mode
        got = bsr_ewise.map_tiles(empty, none, A, sa, mode, op)
        want = bsr_ewise.map_tiles_plain(empty, none, A, sa, mode, op)
        assert torch.equal(got, want), mode


def test_bsr_ewise_rejects_mixed_devices_and_bare_callables():
    rng = np.random.default_rng(4)
    A, sa, sb = _ewise_operands(rng, 6, 32, 10)
    with pytest.raises(ValueError, match="device"):
        bsr_ewise.map_tiles(A, sa, A.cpu(), sb, "union", S.PLUS)
    with pytest.raises(TypeError, match="named"):
        bsr_ewise.map_tiles(A, sa, A, sb, "union", lambda a, b: a + b)


def test_bsr_ewise_kernel_that_cannot_load_raises(monkeypatch):
    from repro_torch.kernels import KernelError, build

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bsr_ewise, "_bound", None)
    rng = np.random.default_rng(5)
    A, sa, _ = _ewise_operands(rng, 6, 32, 10)
    before = bsr_ewise.launches
    with pytest.raises(KernelError):
        bsr_ewise.map_tiles(A, sa, None, None, "select", S.ewise("gt", 0.0))
    assert bsr_ewise.launches == before


# -- bsr_ewise's entry kernel: against its plain version and the tile kernel
def _ewise_handles(rng, b, special=False):
    """Two BSR handles of 2.5 x 2 tiles with absent block-rows on either
    side; ``special`` values hold NaN, +-inf, values whose product
    underflows to -0.0 and pairs that cancel (+-0 results), and A holds
    tile-built -0.0s (a crop of negative values)."""
    n, m = 5 * b // 2, 2 * b + 3
    hands = []
    for skip in (range(0, b // 2), range(b, 3 * b // 2)):
        r = rng.integers(0, n, size=6 * n)
        c = rng.integers(0, m, size=6 * n)
        keep = ~np.isin(r, list(skip))
        choices = [-2, -1, -0.5, 0.5, 1, 2]
        if special:
            choices += [np.nan, np.inf, -np.inf, 1e-30, -1e-30, 3.0]
        v = rng.choice(choices, size=int(keep.sum()))
        hands.append(BSR.from_coo(r[keep], c[keep], v, (n, m), block=b,
                                  device="cuda"))
    if special:
        hands[0] = bsr_mod.extract_ranges(hands[0], 0, n - 1, 0, m - 2)
        hands[1] = bsr_mod.extract_ranges(hands[1], 0, n - 1, 0, m - 2)
    return hands


def _same_handle(got, want):
    assert got.nnz == want.nnz
    for f in ("blocks", "block_rows", "block_cols", "first", "last",
              "valid", "row_ptr"):
        g, w = getattr(got, f), getattr(want, f)
        if f == "blocks":
            g, w = g.view(torch.int32), w.view(torch.int32)  # bit for bit
        assert torch.equal(g, w), f


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("mode", list(EWISE_OPS))
@pytest.mark.parametrize("b", [16, 32, 128])
def test_bsr_ewise_entry_matches_plain_and_tile(mode, b, special,
                                                monkeypatch):
    """Each op through ``core.bsr`` on the entry kernel, its plain version
    and the tile kernel: the slots equal the plain version's bit for bit,
    the handles (lazily built tiles, tile lists, nnz) the tile route's."""
    rng = np.random.default_rng(b + len(mode) + special)
    A, B = _ewise_handles(rng, b, special)
    fn = {"union": bsr_mod.ewise_add, "intersect": bsr_mod.ewise_mult,
          "apply": bsr_mod.apply_stored, "select": bsr_mod.select_stored,
          "mask": lambda X, Y, op: bsr_mod.mask_keep(X, Y),
          "mask_c": lambda X, Y, op: bsr_mod.mask_keep(X, Y, True)}[mode]
    unary = mode in bsr_ewise.UNARY_MODES
    for op in EWISE_OPS[mode]:
        args = (A, op) if unary else (A, B, op)
        sel_a, sel_b, _, _, Bs = bsr_mod.ewise_plan(mode, A, None if unary
                                                    else B)
        FB = None if unary else Bs.payload_form()
        got = bsr_ewise.map_entries(A.payload_form(), sel_a, FB, sel_b,
                                    mode, op)
        want = bsr_ewise.map_entries_plain(
            A.payload_form(), sel_a, FB, sel_b, mode, op)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        # fminf / fmaxf drop a NaN that torch.minimum / maximum keep (the
        # tile kernel's known difference): the kernels agree, not the plain
        if not (special and getattr(op, "name", None) in ("min", "max")):
            assert torch.equal(got[3].view(torch.int32),
                               want[3].view(torch.int32)), (mode, op)
            keep = got[3].view(torch.int32) != 0
            for g, w in zip(got[1:3], want[1:3]):
                assert torch.equal(g[keep], w[keep])
        monkeypatch.setattr(bsr_ewise, "entry_max_fill", lambda b_: 1.01)
        e0 = bsr_ewise.launches_entry
        via_entry = fn(*args)
        assert bsr_ewise.picked == "entry"
        assert bsr_ewise.launches_entry == e0 + int(len(sel_a) > 0)
        monkeypatch.setattr(bsr_ewise, "entry_max_fill", lambda b_: 0.0)
        via_tile = fn(*args)
        assert bsr_ewise.picked == "tile"
        _same_handle(via_entry, via_tile)


def test_bsr_ewise_entry_payload_form_on_cuda_equals_cpu():
    rng = np.random.default_rng(31)
    A, _ = _ewise_handles(rng, 64, special=True)
    fc, fh = A.payload_form(), _to_cpu(A).payload_form()
    for f in ("base", "row_ptr", "rows", "cols", "vals", "bands"):
        g, w = getattr(fc, f).cpu(), getattr(fh, f)
        if f == "vals":
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f


def _to_cpu(A):
    return BSR(A.shape, A.block, A.blocks.cpu(), A.block_rows.cpu(),
               A.block_cols.cpu(), A.first.cpu(), A.last.cpu(),
               A.valid.cpu(), A.row_ptr.cpu(), A.nnz,
               None if A.emask is None else A.emask.cpu())


@pytest.mark.parametrize("variant", ["entry", "tile"])
def test_bsr_ewise_kernel_failure_raises_through_core(variant, monkeypatch):
    """Through ``core.bsr._ewise``: a variant that fails to launch or to
    load raises KernelError, and nothing else answers."""
    from repro_torch.kernels import KernelError, build
    rng = np.random.default_rng(32)
    A, B = _ewise_handles(rng, 32)
    attr = "_bound_entry" if variant == "entry" else "_bound"
    monkeypatch.setattr(bsr_ewise, "entry_max_fill",
                        lambda b: 1.01 if variant == "entry" else 0.0)
    before = (bsr_ewise.launches, bsr_ewise.launches_entry,
              bsr_ewise.launches_tile)
    monkeypatch.setattr(bsr_ewise, attr, lambda *a: 700)
    with pytest.raises(KernelError):
        bsr_mod.ewise_mult(A, B, S.ewise("times"))

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bsr_ewise, attr, None)
    with pytest.raises(KernelError):
        bsr_mod.select_stored(A, S.ewise("gt", 0.0))
    assert (bsr_ewise.launches, bsr_ewise.launches_entry,
            bsr_ewise.launches_tile) == before


def _analytics_graph(scale, device):
    from repro_torch.graph.graph import GraphBuilder
    src, dst, n = datagen.rmat_edges(scale)
    keep = src != dst
    s, d = src[keep], dst[keep]
    return GraphBuilder(n).add_edges("KNOWS", np.concatenate([s, d]),
                                     np.concatenate([d, s])).build(
                                         fmt="bsr", device=device)


def test_analytics_on_cuda_launch_and_match_cpu():
    """Triangles, k-truss and similarity on a CUDA BSR graph launch the
    masked dot SpGEMM (the graph's 128-tiles are under
    ``grb.DOT_MAX_FILL``) and bsr_ewise and give the CPU's answers."""
    from repro_torch import algorithms as algo
    gc, gh = _analytics_graph(10, "cuda"), _analytics_graph(10, "cpu")
    e0, s0, m0 = bsr_ewise.launches, bsr_dot.launches, bsr_mxm.launches
    assert int(algo.triangle_count(gc, "KNOWS")) == \
        int(algo.triangle_count(gh, "KNOWS"))
    tc, th = algo.ktruss(gc, 4, rel="KNOWS"), algo.ktruss(gh, 4, rel="KNOWS")
    for a, b in zip(tc.store.to_coo(), th.store.to_coo()):
        assert np.array_equal(a, b)
    jc = algo.similarity_matrix(gc, "jaccard", rel="KNOWS")
    jh = algo.similarity_matrix(gh, "jaccard", rel="KNOWS")
    for a, b in zip(jc.store.to_coo(), jh.store.to_coo()):
        assert np.array_equal(a, b)
    src = np.arange(0, 1024, 17)
    assert torch.equal(algo.similarity(gc, src, rel="KNOWS").cpu(),
                       algo.similarity(gh, src, rel="KNOWS"))
    assert bsr_ewise.launches > e0 and bsr_dot.launches > s0
    assert bsr_mxm.launches > m0


# -- the remaining algorithms on the card -------------------------------------
# Each on a small CUDA graph against the same call on the CPU graph: levels,
# k-hop counts, SSSP distances (integer weights), WCC and label propagation
# labels and closeness bit for bit; PageRank within atol 1e-6 and
# betweenness within 1e-4 relative (the entry kernel sums in column order,
# the CPU's plain version by index_add_).
def _algo_graphs(fmt, weighted=False):
    src, dst, n = datagen.rmat_edges(9, 8, seed=9)
    keep = src != dst
    s, d = src[keep], dst[keep]
    w = (np.random.default_rng(0).integers(0, 4, size=len(s)).astype(
        np.float32) if weighted else None)
    return [GraphBuilder(n).add_edges("KNOWS", s, d, w).build(
        fmt=fmt, device=dev).relations["KNOWS"] for dev in ("cuda", "cpu")]


@pytest.mark.parametrize("fmt", ["bsr", "ell", "bitadj"])
def test_algorithms_on_cuda_match_cpu(fmt):
    from repro_torch import algorithms as algo
    gc, gh = _algo_graphs(fmt)
    src = list(range(0, 512, 9))
    kernel = {"bsr": bsr_mxm, "ell": bitmap_mxv, "bitadj": bitadj_mxv}[fmt]
    before = kernel.launches
    for fn in (lambda r: algo.bfs_levels(r, src),
               lambda r: algo.khop_counts(r, src, 2),
               lambda r: algo.wcc(r),
               lambda r: algo.closeness(r, sources=src),
               lambda r: algo.label_propagation(r)):
        got, want = fn(gc), fn(gh)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    assert kernel.launches > before
    got, want = algo.pagerank(gc), algo.pagerank(gh)
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)
    got, want = algo.betweenness(gc, sources=src), algo.betweenness(
        gh, sources=src)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    wc, wh = _algo_graphs(fmt, weighted=fmt != "bitadj")
    assert torch.equal(algo.sssp(wc, src[:16]).cpu(), algo.sssp(wh, src[:16]))


def test_bsr_algorithms_launch_the_entry_kernel_at_their_shapes():
    """SSSP (bcast min_plus, F = 16), PageRank (plus_times, F = 1), Brandes
    (plus_times, F = the batch) and label propagation (plus_pair, F = up to
    256) each take bsr_mxm's entry kernel on Graph500 tiles, never the
    tile kernel."""
    from repro_torch import algorithms as algo
    (gc, _), (wc, _) = _algo_graphs("bsr"), _algo_graphs("bsr", True)
    for fn in (lambda: algo.sssp(wc, list(range(16))),
               lambda: algo.pagerank(gc, iters=3),
               lambda: algo.betweenness(gc, sources=list(range(40))),
               lambda: algo.label_propagation(gc, max_iter=2)):
        e0, t0 = bsr_mxm.launches_entry, bsr_mxm.launches_tile
        fn()
        torch.cuda.synchronize()
        assert bsr_mxm.launches_entry > e0 and bsr_mxm.launches_tile == t0


@pytest.mark.parametrize("srname,f", [("plus_times", 1), ("min_plus", 64),
                                      ("plus_times", 128),
                                      ("plus_pair", 256),
                                      ("or_and", 128)])
def test_bsr_mxm_entry_at_the_algorithm_shapes(srname, f, no_tf32):
    """The algorithms' widths of the entry kernel, on an R-MAT handle with
    integer weights (zeros stored through the emask): equal to the plain
    version and the tile kernel bit for bit."""
    (wc, _) = _algo_graphs("bsr", weighted=True)
    A = wc.A.T.store
    assert A.emask is not None
    rng = np.random.default_rng(f)
    X = torch.from_numpy(np.where(rng.uniform(size=(A.shape[1], f)) < 0.3,
                                  rng.integers(1, 4, size=(A.shape[1], f)),
                                  0).astype(np.float32)).cuda()
    sr = S.get(srname)
    csr = A.row_csr()
    got = bsr_mxm.bsr_mxm_entry(csr, X, sr)
    plain = bsr_mxm.bsr_mxm_entry_plain(csr, X, sr)
    tile = bsr_mxm.bsr_mxm_tile(A, X, sr)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(got, tile)


def test_sssp_zero_weight_golden_on_the_entry_kernel():
    from repro_torch import algorithms as algo
    A = BSR.from_coo(np.array([0, 1]), np.array([1, 2]),
                     np.array([0.0, 1.0], np.float32), (3, 3), block=2,
                     device="cuda")
    assert A.emask is not None
    e0 = bsr_mxm.launches_entry
    dist = algo.sssp(A, [0])
    torch.cuda.synchronize()
    assert bsr_mxm.launches_entry > e0
    assert dist[:, 0].cpu().tolist() == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("fmt", ["bsr", "ell"])
def test_call_through_the_server_on_cuda_matches_cpu(fmt):
    """Seeded closeness CALLs coalesce on the card and answer as on the
    CPU; an unseeded PageRank and WCC ride alone."""
    graphs = [datagen.rmat_graph(9, fmt=fmt, device=d) for d in ("cuda",
                                                                 "cpu")]
    t = "CALL algo.closeness(rel: KNOWS) YIELD node, score"
    outs, stats = [], []
    for g in graphs:
        srv = QueryServer(g)
        q = [srv.submit(t, seeds=[s]) for s in range(0, 300, 7)]
        q.append(srv.submit("CALL algo.wcc(rel: KNOWS)"))
        q.append(srv.submit("CALL algo.pagerank(rel: KNOWS, iters: 20)"))
        out = srv.flush()
        outs.append([out[i] for i in q])
        stats.append(srv.stats)
    assert all(r.error is None for r in outs[0] + outs[1])
    cuda_rows, cpu_rows = ([r.rows for r in o] for o in outs)
    assert cuda_rows[:-1] == cpu_rows[:-1]
    np.testing.assert_allclose([s for _, s in cuda_rows[-1]],
                               [s for _, s in cpu_rows[-1]], atol=1e-6)
    assert stats[0]["batches"] == stats[1]["batches"] == 1
    assert stats[0]["solo"] == 2


# -- the write path: delta handles, Database, MutableGraph on the card --------
def _delta_pair(fmt, dev, n=300, seed=11):
    """A delta handle (and its twin) over an R-MAT-like base of ``fmt`` on
    ``dev`` with 3% of the base deleted and as many pairs added."""
    from repro_torch.core import grb
    from repro_torch.core.delta import DeltaMatrix
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 6 * n)
    c = (r * 7 + rng.integers(0, 40, 6 * n) ** 2) % n
    D = np.zeros((n, n), np.float32)
    D[r, c] = 1.0
    er, ec = np.nonzero(D)
    pick = rng.choice(len(er), len(er) // 33, replace=False)
    ops = [("del", int(er[i]), int(ec[i]), 0.0) for i in pick]
    ops += [("add", int(a), int(b), 1.0) for a, b in
            rng.integers(0, n, (len(pick), 2)) if D[a, b] == 0]
    base = grb.GBMatrix.from_dense(D, fmt=fmt, block=64, device=dev)
    baseT = grb.GBMatrix.from_dense(D.T.copy(), fmt=fmt, block=64,
                                    device=dev)
    h = grb.GBMatrix(DeltaMatrix.wrap(base.store).apply_ops(ops), name="A")
    h.link_transpose(grb.GBMatrix(DeltaMatrix.wrap(baseT.store).apply_ops(
        [(k, j, i, w) for k, i, j, w in ops]), name="A^T"))
    return h


@pytest.mark.parametrize("fmt", ["ell", "bsr", "dense"])
def test_delta_handle_on_cuda_equals_cpu(fmt):
    from repro_torch.core import grb
    hc, hh = _delta_pair(fmt, "cuda"), _delta_pair(fmt, "cpu")
    p, rows = hc.store.patch()
    assert p.device.type == "cuda" and rows.device.type == "cuda"
    assert hc.store.materialize().device.type == "cuda"
    rng = np.random.default_rng(3)
    B = rng.integers(0, 3, (300, 40)).astype(np.float32)
    for srname in ("or_and", "min_plus", "plus_pair", "plus_times"):
        sr = S.get(srname)
        for d in (grb.NULL, grb.TRANSPOSE_A):
            got = grb.mxm(hc, torch.from_numpy(B).cuda(), sr, d)
            want = grb.mxm(hh, torch.from_numpy(B), sr, d)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want), srname
    for m in (S.PLUS, S.OR, S.MIN):
        for ax in (None, 0, 1):
            assert torch.equal(grb.reduce(hc, m, axis=ax).cpu(),
                               grb.reduce(hh, m, axis=ax)), (m.name, ax)


@pytest.mark.parametrize("fmt,kernel", [("ell", bitmap_mxv),
                                        ("bsr", bsr_mxm)])
def test_delta_hops_launch_the_base_kernel(fmt, kernel):
    """A hop on a delta handle launches the base's kernel (and, over an
    ELL base, the word kernel a second time on the patch)."""
    from repro_torch.core import grb
    h = _delta_pair(fmt, "cuda")
    B = torch.zeros((300, 64), device="cuda")
    B[torch.arange(64), torch.arange(64)] = 1.0
    before = kernel.launches
    grb.mxm(h, B, S.OR_AND, grb.Descriptor(mask=B, complement=True))
    torch.cuda.synchronize()
    assert kernel.launches - before == (2 if fmt == "ell" else 1)


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_delta_folds_free_the_card_after_the_call(fmt):
    """triangle_count, k-truss and the element-wise family fold a delta
    handle per call: once the result is read, the card's memory is back
    at its level before the call (no fold stays on the handle)."""
    from repro_torch import algorithms as algo
    from repro_torch.core import grb
    h = _delta_pair(fmt, "cuda")
    algo.triangle_count(h)                  # the base's forms, built once
    torch.cuda.synchronize()
    # earlier tests' cyclic garbage (a delta handle and its linked
    # transpose) holds card memory too: free it now, and let no collection
    # free more of it while the level is compared
    gc.collect()
    gc.disable()
    try:
        level = torch.cuda.memory_allocated()
        tri = int(algo.triangle_count(h))
        nv = algo.ktruss(h, 3).nvals
        nv += grb.ewise_add(h, h, S.PLUS).nvals
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    assert tri >= 0 and nv > 0
    assert after == level


def test_database_read_with_a_kernel_that_cannot_load_raises(monkeypatch):
    from repro_torch.engine import Database
    from repro_torch.kernels import KernelError, build

    db = Database(device="cuda")
    db.query("g", "CREATE (0)-[:R]->(1), (1)-[:R]->(2), (2)-[:R]->(3)")
    db._graph("g").fmt = "ell"
    q = "MATCH (a)-[:R*1..2]->(b) WHERE id(a) = 0 RETURN count(DISTINCT b)"
    assert db.query("g", q).scalar() == 2
    db.query("g", "CREATE (3)-[:R]->(4)")

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bitmap_mxv, "_bound", None)
    srv = db.server("g")
    tmpl = "MATCH (a)-[:R*1..3]->(b) RETURN count(DISTINCT b)"
    qids = [srv.submit(tmpl, seeds=[s]) for s in range(5)]   # one batch
    out = srv.flush()
    assert all("KernelError" in (out[i].error or "") for i in qids)


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_snapshot_isolation_with_device_caches_built(fmt):
    from repro_torch.engine import Database
    db = Database(device="cuda")
    src, dst, n = datagen.rmat_edges(9)
    for s, d in zip(src.tolist(), dst.tolist()):
        db._graph("g").create_edge(s, "KNOWS", d)
    db._graph("g").fmt = fmt
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    reader = db.context("g")
    assert reader.graph.relations["KNOWS"].A.store.device.type == "cuda"
    warm = db.server("g")                 # builds the bases' kernel forms
    for s in range(0, 512, 37):
        warm.submit(tmpl, seeds=[s])
    warm.flush()
    before = [reader.run(tmpl.replace("RETURN", f"WHERE id(a) = {s} RETURN"))
              .rows for s in range(0, 512, 37)]
    live = list(db._graph("g").edges)
    for k, (_, s, d) in enumerate(live[:200]):
        db.query("g", f"DELETE ({s})-[:KNOWS]->({d})")
        db.query("g", f"CREATE ({d})-[:KNOWS]->({(s + k) % n})")
    srv = db.server("g")
    qids = [srv.submit(tmpl, seeds=[s]) for s in range(0, 512, 37)]
    srv.flush()
    after = [reader.run(tmpl.replace("RETURN", f"WHERE id(a) = {s} RETURN"))
             .rows for s in range(0, 512, 37)]
    assert after == before and len(qids) == len(before)
    assert db._graph("g").rebuilds == 1
    cpu = Database(device="cpu")
    for (rel, s, d), w in db._graph("g").edges.items():
        cpu._graph("g").create_edge(s, rel, d, w)
    cpu._graph("g").fmt = fmt
    for s in range(0, 512, 37):
        q = tmpl.replace("RETURN", f"WHERE id(a) = {s} RETURN")
        assert db.query("g", q).rows == cpu.query("g", q).rows


# -- the mesh: the word kernels on every shard of a one-card mesh -------------
def _card_mesh(data, pod=1, model=1):
    from repro_torch.distr.mesh import Mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(np.array([dev] * (pod * data * model), dtype=object)
                .reshape(pod, data, model), ("pod", "data", "model"))


def _mesh_handle(fmt, rng, n):
    from repro_torch.core import grb
    r, c = _coo(rng, n, n, 8 * n)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    store = (ELL.from_coo(r, c, None, (n, n), device="cuda") if fmt == "ell"
             else BitELL.from_coo(r, c, None, (n, n), device="cuda"))
    twin = (ELL.from_coo(c, r, None, (n, n), device="cuda") if fmt == "ell"
            else BitELL.from_coo(c, r, None, (n, n), device="cuda"))
    h = grb.GBMatrix(store)
    h.link_transpose(grb.GBMatrix(twin))
    return h


@pytest.mark.parametrize("data", [4, 16])
@pytest.mark.parametrize("fmt", ["ell", "bitadj"])
def test_mesh_word_kernels_per_shard(fmt, data):
    """Every shard's word kernel equals its plain version at the shard's
    own shapes, padded rows and sentinel panels included (they read as
    zero), and the mesh product equals the unsharded one on the CPU; one
    launch a position."""
    from repro_torch.core import grb
    from repro_torch.distr import mesh as M
    rng = np.random.default_rng(data)
    n = 901                     # rows and 29 panels pad on both meshes
    h = _mesh_handle(fmt, rng, n)
    mesh = _card_mesh(data)
    sh = grb.distribute(h, mesh)
    assert sh.fmt == ("sharded" if fmt == "ell" else "bitshard")
    mod = bitmap_mxv if fmt == "ell" else bitadj_mxv
    xw = _words(rng, n, 5)
    for t in (False, True):
        before = mod.launches
        got = grb.mxm_words(sh, xw, transpose_a=t)
        torch.cuda.synchronize()
        assert mod.launches - before == mesh.size
        src = h.T if t else h
        store = src.store
        host = (ELL(shape=store.shape, indices=store.indices.cpu(),
                    mask=store.mask.cpu(), values=store.values.cpu(),
                    nnz=store.nnz) if fmt == "ell" else
                BitELL(shape=store.shape, tiles=store.tiles.cpu(),
                       cols=store.cols.cpu(), nnz=store.nnz))
        want = grb.mxm_words(grb.GBMatrix(host), xw.cpu())
        assert torch.equal(got.cpu(), want)
        local = (sh.T if t else sh).store.local
        xp = torch.zeros((n + (-n) % data, 5), dtype=torch.int32,
                         device="cuda")
        xp[:n] = xw
        xg = M.all_gather(mesh, M.shard(mesh, xp, ("data", None)), "data")
        for i, (e, x) in enumerate(zip(local, xg)):
            if fmt == "ell":
                k_, p_ = (bitmap_mxv.ell_mxv_packed(e, x),
                          ops.ell_mxm_packed(e, x))
            else:
                k_, p_ = (bitadj_mxv.bitadj_mxv_packed(e, x),
                          bitadj.mxm_words(e, x))
            torch.cuda.synchronize()
            assert torch.equal(k_, p_), f"shard {i}"
            rows = e.shape[0]
            pad_from = n - i * rows          # the last shard's padding
            if 0 <= pad_from < rows:
                assert not k_[pad_from:].any()


@pytest.mark.parametrize("mesh_shape", [(1, 4, 1), (2, 2, 2)])
@pytest.mark.parametrize("fmt", ["ell", "bitadj"])
def test_mesh_server_matches_cpu(fmt, mesh_shape):
    """k-hop through QueryServer(mesh=) on the card gives the CPU's rows
    and never gathers to the host."""
    from repro_torch.query.executor import ExecutionContext
    pod, data, model = mesh_shape
    g = datagen.rmat_graph(9, fmt=fmt, device="cuda")
    gc = datagen.rmat_graph(9, fmt=fmt, device="cpu")
    srv = QueryServer(g, mesh=_card_mesh(data, pod, model))
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    qids = [srv.submit(tmpl, seeds=[s]) for s in range(0, 512, 3)]
    out = srv.flush()
    ctx = ExecutionContext(gc)
    for q, s in zip(qids, range(0, 512, 3)):
        assert out[q].rows == ctx.run(tmpl.replace(
            "RETURN", f"WHERE id(a) = {s} RETURN")).rows
    assert srv.stats["errors"] == 0 and srv.stats["host_transfers"] == 0


@pytest.mark.parametrize("fmt", ["ell", "bitadj"])
def test_mesh_server_reports_a_kernel_that_cannot_load(fmt, monkeypatch):
    """A shard whose kernel cannot load fails the batch through
    QueryServer(mesh=): every query reports the KernelError, no shard is
    retried on the CPU."""
    from repro_torch.kernels import KernelError, build

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bitmap_mxv, "_bound", None)
    monkeypatch.setattr(bitadj_mxv, "_bound", None)
    g = datagen.rmat_graph(9, fmt=fmt, device="cuda")
    srv = QueryServer(g, mesh=_card_mesh(4))
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    qids = [srv.submit(tmpl, seeds=[s]) for s in range(0, 512, 5)]
    out = srv.flush()
    assert srv.pending == 0
    assert all("KernelError" in (out[q].error or "") for q in qids)
    assert srv.stats["errors"] == len(qids)


def test_mesh_transposed_and_algorithms_on_the_card():
    """The unlinked transposed lowerings (nibbles at 4 positions, float
    partials at 16) equal the linked twin's row form, and the algorithms
    on a mesh equal the unsharded ones, every tensor on the card."""
    from repro_torch import algorithms as algo
    from repro_torch.core import grb
    g = datagen.rmat_graph(10, fmt="ell", device="cuda")
    A = g.relations["KNOWS"].A
    rng = np.random.default_rng(1)
    X = torch.from_numpy(np.where(rng.random((g.n, 40)) < 0.05,
                                  rng.integers(1, 3, (g.n, 40)), 0)
                         .astype(np.float32)).cuda()
    for data in (4, 16):
        mesh = _card_mesh(data)
        linked = grb.distribute(A, mesh)
        un = grb.distribute(grb.GBMatrix(A.store), mesh)
        for sr in (S.OR_AND, S.PLUS_TIMES, S.MIN_PLUS):
            x = (X > 0).float() if sr is S.OR_AND else X
            got = grb.mxm(un, x, sr, grb.TRANSPOSE_A)
            assert got.device.type == "cuda"
            assert torch.equal(got, grb.mxm(linked, x, sr, grb.TRANSPOSE_A))
    sh = grb.distribute(A, _card_mesh(2, 2, 2))
    seeds = np.arange(0, 1024, 41)
    assert torch.equal(algo.khop_counts(sh, seeds, k=3),
                       algo.khop_counts(A, seeds, k=3))
    assert torch.equal(algo.bfs_levels(sh, seeds), algo.bfs_levels(A, seeds))
    assert torch.equal(algo.wcc(sh), algo.wcc(A))
    assert float((algo.pagerank(sh) - algo.pagerank(A)).abs().sum()) < 1e-5


# -- the probes and any_pair ---------------------------------------------------
def _probe_inputs(dev, scale=10, f=64):
    """R-MAT pull rows (the stored transpose's ELL), one-hot seeds and
    out-degrees on ``dev``."""
    from repro_torch.distr import graph2d
    g = datagen.rmat_graph(scale, edge_factor=8, fmt="ell", device="cpu")
    idx, msk = graph2d.ell_shard_inputs(g.relations["KNOWS"].A.T)
    idx_s, _ = graph2d.ell_shard_inputs(g.relations["KNOWS"].A.T,
                                        sentinel=True)
    seeds = np.random.default_rng(3).choice(g.n, f, replace=False)
    fr = np.zeros((g.n, f), np.int8)
    fr[seeds, np.arange(f)] = 1
    deg = g.relations["KNOWS"].A.store.mask.sum(dim=1).to(torch.float32)
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    return g.n, t(idx), t(msk), t(idx_s), t(fr), deg.to(dev)


def _mesh_on(dev, shape, names):
    from repro_torch.distr.mesh import Mesh
    return Mesh(np.array([dev] * int(np.prod(shape)), dtype=object)
                .reshape(shape), names)


@pytest.mark.parametrize("shape,names", [((4, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data",
                                                      "model"))])
def test_probes_on_cuda_launch_per_position_and_equal_cpu(shape, names):
    """The packed k-hop probes launch ell_mxv_packed once per position per
    hop; every variant and PageRank equal the same probe on CPU
    positions."""
    from repro_torch.distr import graph2d
    dev = torch.device("cuda", torch.cuda.current_device())
    cpu = torch.device("cpu")
    k = 2
    n, idx, msk, idx_s, fr, deg = _probe_inputs(dev)
    hn, hidx, hmsk, hidx_s, hfr, hdeg = _probe_inputs(cpu)
    mesh, cmesh = _mesh_on(dev, shape, names), _mesh_on(cpu, shape, names)
    for packed, sentinel in ((False, False), (True, False), (True, True)):
        before = bitmap_mxv.launches
        got = graph2d.khop_counts_2d(mesh, n, k, packed=packed,
                                     sentinel=sentinel)(
            idx_s if sentinel else idx, msk, fr)
        torch.cuda.synchronize()
        assert bitmap_mxv.launches - before == (mesh.size * k if packed
                                                else 0)
        want = graph2d.khop_counts_2d(cmesh, hn, k, packed=packed,
                                      sentinel=sentinel)(
            hidx_s if sentinel else hidx, hmsk, hfr)
        assert got.device == dev and torch.equal(got.cpu(), want)
    for pd in (None, torch.bfloat16):
        got = graph2d.pagerank_2d(mesh, n, iters=10, push_dtype=pd)(
            idx, msk, deg)
        want = graph2d.pagerank_2d(cmesh, hn, iters=10, push_dtype=pd)(
            hidx, hmsk, hdeg)
        assert float((got.cpu() - want).abs().sum()) < 1e-5


def test_packed_probe_with_a_kernel_that_cannot_load_raises(monkeypatch):
    from repro_torch.distr import graph2d
    from repro_torch.kernels import KernelError, build

    def no_library(name):
        raise KernelError(f"cannot load {name}")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(bitmap_mxv, "_bound", None)
    dev = torch.device("cuda", torch.cuda.current_device())
    n, idx, msk, _, fr, _ = _probe_inputs(dev, scale=8, f=32)
    fn = graph2d.khop_counts_2d(_mesh_on(dev, (4, 2), ("data", "model")),
                                n, 2, packed=True)
    with pytest.raises(KernelError):
        fn(idx, msk, fr)


@pytest.mark.parametrize("fmt,kernel", [("ell", bitmap_mxv),
                                        ("bitadj", bitadj_mxv),
                                        ("bsr", bsr_mxm)])
def test_any_pair_launches_the_or_and_kernel(fmt, kernel):
    """any_pair takes or_and's kernel on each storage kind (the word
    kernels, bsr_mxm's indicator mode) and gives its bits."""
    from repro_torch.core import grb
    g = datagen.rmat_graph(10, fmt=fmt, device="cuda")
    A = g.relations["KNOWS"].A
    X = torch.from_numpy((np.random.default_rng(2).random((g.n, 512))
                          < 0.01).astype(np.float32)).cuda()
    before = kernel.launches
    got = grb.mxm(A, X, S.ANY_PAIR)
    torch.cuda.synchronize()
    assert kernel.launches - before == 1
    assert torch.equal(got, grb.mxm(A, X, S.OR_AND))
    if fmt == "ell":
        with grb.packed_frontiers("off"):
            before = kernel.launches
            off = grb.mxm(A, X, S.ANY_PAIR)
            torch.cuda.synchronize()
            assert kernel.launches == before
        assert torch.equal(off, got)


# -- the models' serving path ------------------------------------------------------
MODEL_ARCHS = ["qwen2-1.5b", "gemma2-9b", "mixtral-8x7b", "rwkv6-3b",
               "zamba2-1.2b", "whisper-medium", "llava-next-mistral-7b"]


@pytest.mark.parametrize("name", MODEL_ARCHS)
def test_model_decode_on_the_card_matches_cpu(name, no_tf32):
    """A tiny model (the serve entry point's reduction, float32) from one seeded
    init on the CPU, copied to the card: prefill and 4 decode steps equal
    the same calls on the CPU within atol 1e-4 (float32 with TF32 off; the
    sums' order differs between the devices)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import tiny_config
    from repro_torch.models import get_model
    from repro_torch.models.base import zeros_from_specs
    cfg = tiny_config(get_config(name))
    model = get_model(cfg)
    cpu = model.init(0, "cpu")
    card = get_model(cfg).init(0, "cpu").to("cuda")
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32))}
    if cfg.family == "whisper":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.n_audio_frames, cfg.d_frontend)).astype(np.float32))
    if cfg.family == "llava":
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(2, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32))
    want, _ = model.prefill_fn(cpu, batch)
    got, _ = model.prefill_fn(card, {k: v.cuda() for k, v in batch.items()})
    assert got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)
    cc = zeros_from_specs(model.cache_specs(2, 8), "cpu")
    gc_ = zeros_from_specs(model.cache_specs(2, 8), "cuda")
    for pos in range(4):
        tok = batch["tokens"][:, pos:pos + 1]
        want, cc = model.decode_fn(cpu, cc, {"tokens": tok}, pos)
        got, gc_ = model.decode_fn(card, gc_, {"tokens": tok.cuda()}, pos)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-4)


def test_model_cache_is_written_in_place_on_the_card():
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import tiny_config
    from repro_torch.models import get_model
    from repro_torch.models.base import zeros_from_specs
    model = get_model(tiny_config(get_config("qwen2-1.5b")))
    params = model.init(0, "cuda")
    cache = zeros_from_specs(model.cache_specs(2, 8), "cuda")
    ptrs = [c.data_ptr() for c in cache]
    _, out = model.decode_fn(params, cache,
                             {"tokens": torch.tensor([[3], [4]]).cuda()}, 5)
    torch.cuda.synchronize()
    assert out is cache and [c.data_ptr() for c in out] == ptrs
    written = (cache[0] != 0).any(dim=(0, 1, 3, 4)).cpu().tolist()
    assert written == [False] * 5 + [True, False, False]


def test_serve_entry_point_runs_on_the_card_by_default():
    from repro_torch.launch import serve
    res = serve.main(["--arch", "qwen2-1.5b", "--batch", "2",
                      "--prompt-len", "4", "--max-new", "3"])
    assert res.tokens.is_cuda and res.tokens.shape == (2, 3)
    again = serve.main(["--arch", "qwen2-1.5b", "--batch", "2",
                        "--prompt-len", "4", "--max-new", "3"])
    assert torch.equal(again.tokens, res.tokens)


# -- the models' training path -----------------------------------------------------
TRAIN_ARCHS = ["qwen2-1.5b", "mixtral-8x7b", "rwkv6-3b", "zamba2-1.2b",
               "whisper-medium", "llava-next-mistral-7b"]


def _train_pair(name):
    """A tiny model (the serve entry point's reduction, float32) from one
    seeded init on the CPU, and its copy on the card, with a batch of the
    synthetic stream for each."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch.serve import tiny_config
    from repro_torch.models import get_model
    from repro_torch.train.data import synthetic_batch, to_device
    cfg = tiny_config(get_config(name))
    model = get_model(cfg)
    cpu, card = model.init(0, "cpu"), model.init(0, "cpu").to("cuda")
    batches = [synthetic_batch(cfg, ShapeConfig("t", 8, 2, "train"), k)
               for k in range(2)]
    return cfg, model, cpu, card, batches, to_device


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_cpu(name, no_tf32):
    """Two AdamW steps (qwen2 with microbatches and int8 compression) on the
    card and on the CPU: each step's loss within 1e-4, the params within
    1% of a step (lr 1e-3) a step, but for at most 1e-4 of them, each
    within 2 lr a step: float32 with TF32 off, the sums ordered otherwise
    on each device, and Adam's step m / sqrt(v) does not scale with the
    gradient, so an element whose gradient is at rounding level steps by
    that rounding (and under compression a gradient within rounding of a
    half step of the scale may take the neighbouring int8 code)."""
    from repro_torch.models.base import tree_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import make_train_step
    cfg, model, cpu, card, batches, to_device = _train_pair(name)
    kw = ({"microbatches": 2, "compress_grads": True}
          if name == "qwen2-1.5b" else {})
    opt = opt_mod.OptConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=1,
                            total_steps=2)
    losses = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        step = make_train_step(model, opt, **kw)
        state, err, losses[dev] = opt_mod.init_fn(cfg.optimizer)(params), \
            None, []
        for b in batches:
            out = step(params, state, to_device(b, dev), *(
                [err] if kw else []))
            params, state, metrics = out[:3]
            err = out[3] if kw else None
            losses[dev].append(float(metrics["loss"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                               atol=1e-4)
    d = torch.cat([(a.detach() - b.detach().cpu()).abs().flatten()
                   for a, b in zip(tree_leaves(cpu), tree_leaves(card))])
    assert card["ln_f"].is_cuda
    past = int((d > 0.01 * 1e-3 * 2).sum())
    assert past <= 1e-4 * d.numel()
    assert float(d.max()) <= 2 * 1e-3 * 2


@pytest.mark.parametrize("name", ["qwen2-1.5b", "rwkv6-3b", "zamba2-1.2b",
                                  "whisper-medium"])
def test_remat_on_the_card_matches_no_remat(name, no_tf32):
    """Loss and grads with every layer rematerialised equal those without,
    on the card: the recompute runs the same kernels on the same inputs
    (held within 1e-6 of each leaf's largest value, since backward's
    atomic adds may order a sum otherwise)."""
    import dataclasses
    from repro_torch.models import get_model
    from repro_torch.models.base import tree_leaves
    cfg, _, _, card, batches, to_device = _train_pair(name)
    b = to_device(batches[0], "cuda")
    out = []
    for remat in (True, False):
        model = get_model(dataclasses.replace(cfg, remat=remat))
        card.requires_grad_(True)
        loss = model.loss_fn(card, b)
        out.append((loss.detach(), torch.autograd.grad(loss,
                                                       tree_leaves(card))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b_ in zip(out[0][1], out[1][1]):
        assert a.is_cuda
        assert float((a - b_).abs().max()) <= 1e-6 * float(b_.abs().max())


def test_bfloat16_checkpoint_round_trip_on_the_card(tmp_path):
    """bfloat16 params and float32 AdamW state on the card through a
    checkpoint into a fresh tree on the card: bit for bit."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import tiny_config
    from repro_torch.models import get_model
    from repro_torch.models.base import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    cfg = dataclasses.replace(tiny_config(get_config("qwen2-1.5b")),
                              dtype="bfloat16")
    model = get_model(cfg)
    params = model.init(0, "cuda")
    state = opt_mod.adamw_init(params)
    for t in tree_leaves(state["m"]):
        t.normal_()
    state["step"] = torch.tensor(7, dtype=torch.int32)
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    w.save((params, state), 7)
    w.wait()
    fresh = model.init(1, "cuda")
    fresh_state = opt_mod.adamw_init(fresh)
    _, step = ckpt.restore((fresh, fresh_state), str(tmp_path))
    assert step == 7 and int(fresh_state["step"]) == 7
    assert fresh["embed"]["tok"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves((params, state)),
                    tree_leaves((fresh, fresh_state))):
        assert a.device == b.device and torch.equal(a, b)


def test_train_entry_point_runs_on_the_card_by_default():
    from repro_torch.launch import train
    run = train.run(["--steps", "3", "--batch", "2", "--seq", "8"])
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert run.params["ln_f"].is_cuda


def test_train_entry_point_raises_without_a_card(monkeypatch):
    """Asked for ``cuda`` (the default) on a host without a card, the entry
    point raises and never trains on the host."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--steps", "1", "--device", "cuda"])


# -- the models on the mesh ----------------------------------------------------------
def _mesh_of_card(shape, names):
    from repro_torch.distr.mesh import Mesh
    return Mesh(np.full(shape, torch.device("cuda", 0), dtype=object), names)


def _tiny_qwen2(device):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import tiny_config
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt_mod
    cfg = tiny_config(get_config("qwen2-1.5b"))
    model = get_model(cfg)
    params = model.init(0, "cpu").to(device)
    return cfg, model, params, opt_mod.adamw_init(params)


@pytest.mark.parametrize("clip", [1e3, 1.0])
def test_mesh_step_on_the_card_matches_the_cards_unsharded_step(clip):
    """A (2, 2) mesh of the card, AdamW with one microbatch a data block,
    against the card's unsharded step with two microbatches (deterministic
    algorithms on): the first loss bit for bit; with a clip the norm stays
    under, every param and moment bit for bit; with the default clip,
    which scales here (the tiny model's norm is about 2.8), the scale's
    last bits differ (the norm's partial sums run per block) and the
    params are held to ``train_parity``'s bounds (each within 2 lr, at
    most 1e-4 of them past 0.01 lr), the losses within 1e-5."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distr import sharding as sh
    from repro_torch.distr.shardctx import ShardCtx, use
    from repro_torch.models.base import tree_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.data import synthetic_batch, to_device
    from repro_torch.train.train_step import make_train_step
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = _mesh_of_card((2, 2), ("data", "model"))
        cfg, model, params, state = _tiny_qwen2("cuda")
        _, _, ref_p, ref_s = _tiny_qwen2("cuda")
        opt = opt_mod.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2,
                                clip_norm=clip)
        P = sh.place(params, sh.param_shardings(params, mesh, cfg.vocab),
                     mesh)
        St = sh.place(state, sh.opt_state_shardings(state, mesh, cfg.vocab),
                      mesh)
        step = make_train_step(model, opt)
        ref = make_train_step(model, opt, microbatches=2)
        for k in range(2):
            b = to_device(synthetic_batch(cfg, ShapeConfig("t", 8, 4,
                                                           "train"), k),
                          "cuda")
            with use(ShardCtx(mesh)):
                P, St, m = step(P, St, sh.place(
                    b, sh.batch_shardings(b, mesh), mesh))
            ref_p, ref_s, rm = ref(ref_p, ref_s, b)
            if k == 0 or clip > 1:
                assert float(m["loss"]) == float(rm["loss"])
            assert abs(float(m["loss"]) - float(rm["loss"])) <= 1e-5
            assert (float(rm["grad_norm"]) < clip) == (clip > 1)
        pairs = list(zip(tree_leaves(sh.gather(P)) + tree_leaves(
            sh.gather(St)), tree_leaves(ref_p) + tree_leaves(ref_s)))
        assert all(a.device.type == "cuda" for a, _ in pairs)
        if clip > 1:            # the step count is a host scalar there
            assert all(torch.equal(a, b_.detach().to(a.device))
                       for a, b_ in pairs)
        d = torch.cat([(a - b_.detach()).abs().flatten() for a, b_ in pairs
                       [:len(tree_leaves(ref_p))]])
        assert float(d.max()) <= 2 * 1e-3 * 2
        assert int((d > 0.01 * 1e-3 * 2).sum()) <= 1e-4 * d.numel()
    finally:
        torch.use_deterministic_algorithms(prev)


def test_restore_onto_a_mesh_of_the_card(tmp_path):
    """bfloat16 params and float32 moments restored from a checkpoint onto a
    (2, 4) mesh of the card: every block on the card, gathered bit for
    bit."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.distr import sharding as sh
    from repro_torch.launch.serve import tiny_config
    from repro_torch.models import get_model
    from repro_torch.models.base import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    cfg = dataclasses.replace(tiny_config(get_config("qwen2-1.5b")),
                              dtype="bfloat16")
    model = get_model(cfg)
    params = model.init(0, "cuda")
    state = opt_mod.adamw_init(params)
    for t in tree_leaves(state["m"]):
        t.normal_()
    ckpt.save((params, state), str(tmp_path), 2)
    mesh = _mesh_of_card((2, 4), ("data", "model"))
    like = (model.param_specs(),
            opt_mod.adamw_init(sh.as_meta(model.param_specs())))
    specs = (sh.param_shardings(like[0], mesh, cfg.vocab),
             sh.opt_state_shardings(like[1], mesh, cfg.vocab))
    placed, at = ckpt.restore(like, str(tmp_path), shardings=specs,
                              mesh=mesh)
    assert at == 2
    for x in sh.tree_items(placed):
        assert all(t.is_cuda for t in x.blocks if t is not None)
    for a, b in zip(tree_leaves(sh.gather(placed)),
                    tree_leaves((params, state))):
        assert torch.equal(a.cpu(), b.detach().cpu())


def test_replicated_leaf_is_held_once_per_card():
    """Placing on 16 positions of the card: a leaf replicated over the mesh
    is one tensor (no copy of the card's tensor); a sharded leaf's blocks
    are views of it, so the card holds each leaf once."""
    from repro_torch.distr import sharding as sh
    mesh = _mesh_of_card((4, 4), ("data", "model"))
    x = torch.randn(8, 6, device="cuda")        # 6 % 4: not sharded
    rep = sh.place_leaf(x, (None, None), mesh)
    assert len({id(t) for t in rep.blocks}) == 1
    assert rep.blocks[0].data_ptr() == x.data_ptr()
    y = torch.randn(16, 8, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    blk = sh.place_leaf(y, ("data", "model"), mesh)
    assert torch.cuda.memory_allocated() == before
    assert len({t.data_ptr() for t in blk.blocks}) == 16
    assert torch.equal(sh.gather_leaf(blk), y)


# -- the dry-run's cost side ---------------------------------------------------------
@pytest.mark.parametrize("name", MODEL_ARCHS)
def test_dryrun_counts_on_the_card_equal_meta(name):
    """``launch.dryrun``'s counters on card tensors: a tiny train part
    (forward and backward, remat on) and a decode step count the FLOPs and
    bytes that the same run on meta tensors counts, as integers, and the
    peak of the bytes they allocate is the card's, within the caching
    allocator's rounding of small blocks (1%)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import tiny_config
    cfg = tiny_config(get_config(name))
    for shape in (ShapeConfig("t", 64, 4, "train"),
                  ShapeConfig("d", 64, 4, "decode")):
        want = dryrun.count_ops(dryrun.part_fn(cfg, shape, 4))
        dryrun.part_fn(cfg, shape, 4, "cuda")()    # cuBLAS's workspace
        run = dryrun.part_fn(cfg, shape, 4, "cuda")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = dryrun.count_ops(run)
        torch.cuda.synchronize()
        above = torch.cuda.max_memory_allocated() - before
        assert got[:2] == want[:2], (shape.kind, got, want)
        assert abs(above - want[2]) <= 0.01 * want[2] + 4096, (above, want)

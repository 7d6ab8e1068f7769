"""PyTorch port on the card: each hand-written CUDA kernel against its plain
PyTorch version, and the k-hop slice (ELL, BitELL and BSR) on a CUDA graph
against the same slice on the CPU.

Every test here is marked ``cuda`` and skips when no card is present (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so on a machine with a card and without JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Everything compared is integer or boolean: ``torch.equal``, bit for bit,
except the BSR kernels' weighted modes (tolerance stated beside them).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitadj, ops
from repro_torch.core import bsr as bsr_mod, semiring as S
from repro_torch.core.bitadj import BitELL
from repro_torch.core.bsr import BSR
from repro_torch.core.ell import ELL
from repro_torch.engine import QueryServer
from repro_torch.graph import datagen
from repro_torch.kernels import bitadj_mxv, bitmap_mxv, bsr_mxm, bsr_spgemm
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
        mb = None
        if mask is not None:
            sel = torch.from_numpy(np.clip(plan.mask_sel, 0, None)).long()
            mb = mask.blocks[sel.cuda()] * torch.from_numpy(
                plan.mask_sel >= 0).float().cuda()[:, None, None]
        before = bsr_spgemm.launches
        got = bsr_spgemm.spgemm_blocks(A.blocks, B.blocks, plan, sr,
                                       mask_blocks=mb, complement=comp)
        torch.cuda.synchronize()
        assert bsr_spgemm.launches == before + 1
        want = bsr_spgemm.spgemm_blocks_plain(A.blocks, B.blocks, plan, sr,
                                              mb, comp)
        _same(got, want, sr)


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
    monkeypatch.setattr(bsr_spgemm, "_bound", None)
    g = datagen.rmat_graph(9, fmt="bsr", device="cuda")
    tmpl = ["MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)",
            "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(b)"]
    srv = QueryServer(g)
    qids = [srv.submit(tmpl[s % 2], seeds=[s]) for s in range(0, 512, 5)]
    out = srv.flush()
    assert srv.pending == 0
    assert all("KernelError" in (out[q].error or "") for q in qids)
    assert srv.stats["errors"] == len(qids)

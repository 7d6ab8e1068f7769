"""PyTorch port, the packed-word kernels' compact forms and work plans:
``ELL.row_csr`` / ``ELL.item_plan`` (``kernels.bitmap_mxv``) and
``BitELL.slot_plan`` (``kernels.bitadj_mxv``), held against the JAX
package's arrays and products.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``);
here their item-wise evaluations in plain torch (``ell_mxv_items_plain``,
``bitadj_mxv_items_plain``), which start from an all-ones output so that a
row no item writes shows, are held against ``repro.core.ops.
ell_mxm_packed`` / ``repro.core.bitadj.mxm_words`` and the Pallas kernels
in interpret mode. Inputs come from numpy with fixed seeds and carry a
planted hub row or hub panel longer than an item, empty rows and panels,
and storage in stored and in shuffled slot order. Everything compared is
words, so the tolerance is bit-identity (uint32 views).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitadj as jbitadj
from repro.core import ops as jops
from repro.core.bitadj import BitELL as JBitELL
from repro.core.ell import ELL as JELL
from repro.kernels import bitadj_mxv as jbitadj_mxv
from repro.kernels import bitmap_mxv as jbitmap_mxv
from repro_torch.core import bitadj as tbitadj
from repro_torch.core import ell as tell
from repro_torch.core import ops as tops
from repro_torch.core.bitadj import BitELL as TBitELL
from repro_torch.core.ell import ELL as TELL
from repro_torch.kernels import bitadj_mxv, bitmap_mxv

WIDTHS = [1, 3, 16, 17, 300]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def words(rng, n, w) -> np.ndarray:
    return rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


def ell_coo(rng, n, k, hub=60):
    """Rows 0, 10, 11 and n-1 empty, row 3 a hub of ``hub`` distinct ids,
    the rest a few random ids each."""
    r = rng.integers(0, n, size=3 * n)
    c = rng.integers(0, k, size=3 * n)
    r = np.concatenate([r, np.full(hub, 3)])
    c = np.concatenate([c, rng.choice(k, hub, replace=False)])
    keep = ~np.isin(r, [0, 10, 11, n - 1])
    return r[keep], c[keep]


def bitadj_coo(rng, n, k):
    """Panel 0 reaches every column tile (the hub panel), panel 2 is
    empty, other rows keep to one column tile."""
    C = -(-k // 32)
    r = rng.integers(0, n, size=4 * n)
    c = rng.integers(0, k, size=4 * n)
    c = np.where(r >= 32, np.minimum((r // 32 % C) * 32 + c % 32, k - 1), c)
    hub_c = np.minimum(np.arange(C) * 32 + rng.integers(0, 32, size=C), k - 1)
    r = np.concatenate([r, rng.integers(0, 32, size=C)])
    c = np.concatenate([c, hub_c])
    keep = r // 32 != 2
    return r[keep], c[keep]


def shuffled(rng, arrays):
    """The same arrays with each row's (panel's) slots in random order."""
    order = np.argsort(rng.random(arrays[0].shape[:2]), axis=1)
    return [np.take_along_axis(a, order if a.ndim == 2 else order[..., None],
                               axis=1) for a in arrays]


def ell_pair(rng, n, k, order):
    r, c = ell_coo(rng, n, k)
    je = JELL.from_coo(r, c, None, (n, k))
    idx, msk, val = (np.asarray(je.indices), np.asarray(je.mask),
                     np.asarray(je.values))
    if order == "shuffled":
        idx, msk, val = shuffled(rng, [idx, msk, val])
        je = JELL((n, k), jnp.asarray(idx), jnp.asarray(msk),
                  jnp.asarray(val), je.nnz)
    te = TELL((n, k), torch.from_numpy(idx.copy()),
              torch.from_numpy(msk.copy()), torch.from_numpy(val.copy()),
              je.nnz)
    return je, te, idx, msk


def bitadj_pair(rng, n, k, order):
    r, c = bitadj_coo(rng, n, k)
    jb = JBitELL.from_coo(r, c, None, (n, k))
    tiles, cols = np.asarray(jb.tiles), np.asarray(jb.cols)
    if order == "shuffled":
        tiles, cols = shuffled(rng, [tiles, cols])
        jb = JBitELL((n, k), jnp.asarray(tiles), jnp.asarray(cols), jb.nnz)
    tb = TBitELL((n, k), torch.from_numpy(tiles.view(np.int32).copy()),
                 torch.from_numpy(cols.copy()), jb.nnz)
    return jb, tb


# -- ELL.row_csr ----------------------------------------------------------------
@pytest.mark.parametrize("order", ["stored", "shuffled"])
@pytest.mark.parametrize("n,k", [(45, 70), (100, 300)])
def test_ell_row_csr_is_the_valid_ids_in_valid_first_order(n, k, order):
    rng = np.random.default_rng(n + k)
    _, te, idx, msk = ell_pair(rng, n, k, order)
    csr = te.row_csr()
    deg = msk.sum(axis=1)
    np.testing.assert_array_equal(csr.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(deg)]))
    assert csr.row_ptr.dtype == torch.int64 and csr.ids.dtype == torch.int32
    sent = te.sentinel_indices().numpy()
    for i in range(n):
        got = csr.ids[csr.row_ptr[i]:csr.row_ptr[i + 1]].numpy()
        np.testing.assert_array_equal(got, idx[i][msk[i]])   # slot order
        np.testing.assert_array_equal(got, sent[i, :deg[i]])
    assert te.row_csr() is csr                               # cached


# -- ELL.item_plan ----------------------------------------------------------------
@pytest.mark.parametrize("L", [1, 7, 32, tell.ITEM_IDS, 10_000])
def test_ell_item_plan_cuts_rows_at_item_boundaries(L):
    rng = np.random.default_rng(L)
    n, k = 100, 300
    _, te, _, msk = ell_pair(rng, n, k, "stored")
    csr = te.row_csr()
    plan = tell.item_plan(csr, L)
    deg = msk.sum(axis=1)
    ptr = np.concatenate([[0], np.cumsum(deg)])
    nnz = int(ptr[-1])
    assert plan.items == -(-nnz // L) and plan.L == L
    assert plan.longest_row == deg.max() == deg[3]
    word = plan.edge_rows.numpy().view(np.uint32).astype(np.int64)
    rows = word & ((1 << tell.ROW_BITS) - 1)
    np.testing.assert_array_equal(rows, np.repeat(np.arange(n), deg))
    full = deg > 0
    first = np.zeros(nnz, bool)
    first[ptr[:-1][full]] = True
    last = np.zeros(nnz, bool)
    last[ptr[1:][full] - 1] = True
    np.testing.assert_array_equal((word & tell.FIRST_EDGE) != 0, first)
    np.testing.assert_array_equal((word & tell.LAST_EDGE) != 0, last)
    # a row is cut where an item boundary falls strictly inside it
    bounds = np.arange(L, nnz, L)
    cut = np.unique(rows[bounds][rows[bounds] == rows[bounds - 1]])
    zero = plan.zero_rows.numpy()
    np.testing.assert_array_equal(zero[:plan.split_rows], cut)
    np.testing.assert_array_equal(zero[plan.split_rows:],
                                  np.nonzero(deg == 0)[0])
    if deg[3] > L:
        assert 3 in cut                                      # the hub row
    assert bool(np.isin([0, 10, 11, n - 1], zero).all())     # empty rows
    # the whole output is written: by a store, an OR or the zeroing
    xw = torch.from_numpy(words(rng, k, 2).view(np.int32))
    np.testing.assert_array_equal(
        u32(bitmap_mxv.ell_mxv_items_plain(csr, plan, xw)),
        u32(tops.ell_mxm_packed(te, xw)))


def test_ell_item_plan_puts_empty_rows_on_item_boundaries():
    """Rows of exactly L ids between empty rows: the empty rows start
    where items start, and are zeroed."""
    L = 8
    rows = np.repeat([1, 3, 5], L)
    cols = np.tile(np.arange(L), 3)
    te = TELL.from_coo(rows, cols, None, (7, 9), device="cpu")
    plan = tell.item_plan(te.row_csr(), L)
    ptr = te.row_csr().row_ptr.numpy()
    assert plan.items == 3 and plan.split_rows == 0
    np.testing.assert_array_equal(plan.zero_rows.numpy(), [0, 2, 4, 6])
    assert [ptr[r] % L for r in (0, 2, 4)] == [0, 0, 0]
    xw = torch.from_numpy(words(np.random.default_rng(0), 9, 3).view(np.int32))
    np.testing.assert_array_equal(
        u32(bitmap_mxv.ell_mxv_items_plain(te.row_csr(), plan, xw)),
        u32(tops.ell_mxm_packed(te, xw)))


# -- BitELL.slot_plan -------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 2, 3, tbitadj.ITEM_SLOTS])
@pytest.mark.parametrize("order", ["stored", "shuffled"])
def test_bitadj_slot_plan_covers_every_occupied_slot_once(K, order):
    rng = np.random.default_rng(K)
    n, k = 100, 300
    _, tb = bitadj_pair(rng, n, k, order)
    _, cols = tb.occupied_first()
    plan = tbitadj.slot_plan(cols, n, tb.n_ctiles, K)
    assert plan.K == K
    C = tb.n_ctiles
    occ = (cols < C).sum(dim=1).numpy()
    items = plan.items.numpy()
    assert plan.hub_slots == occ.max() == C
    seen = np.zeros(cols.shape, int)
    for p, s0, s1, split in items:
        assert 0 <= s0 <= s1 <= occ[p] and s1 - s0 <= K
        seen[p, s0:s1] += 1
    occupied = np.arange(cols.shape[1])[None, :] < occ[:, None]
    np.testing.assert_array_equal(seen, occupied.astype(int))  # once each
    per_panel = np.bincount(items[:, 0], minlength=tb.n_panels)
    assert (per_panel >= 1).all()                    # empty panels too
    assert per_panel[2] == 1 and occ[2] == 0         # the empty panel
    np.testing.assert_array_equal(items[:, 3], per_panel[items[:, 0]] > 1)
    if K < C:
        assert per_panel[0] >= 2                     # the hub panel split
    split_panels = np.nonzero(per_panel > 1)[0]
    assert plan.split_panels == len(split_panels)
    rows = (split_panels[:, None] * 32 + np.arange(32)).ravel()
    np.testing.assert_array_equal(plan.zero_rows.numpy(), rows[rows < n])


# -- the item-wise evaluations against the JAX package and Pallas -------------
@pytest.mark.parametrize("order", ["stored", "shuffled"])
@pytest.mark.parametrize("w", WIDTHS)
def test_ell_items_plain_matches_reference_and_pallas(w, order):
    rng = np.random.default_rng(w * 3 + len(order))
    n, k = 70, 90
    je, te, _, _ = ell_pair(rng, n, k, order)
    xw = words(rng, k, w)
    want = np.asarray(jops.ell_mxm_packed(je, jnp.asarray(xw)))
    pallas = np.asarray(jbitmap_mxv.ell_mxv_packed(je, jnp.asarray(xw),
                                                   interpret=True))
    np.testing.assert_array_equal(pallas, want)
    xt = torch.from_numpy(xw.view(np.int32))
    csr = te.row_csr()
    for plan in (tell.item_plan(csr, 7), te.item_plan()):
        got = bitmap_mxv.ell_mxv_items_plain(csr, plan, xt)
        np.testing.assert_array_equal(u32(got), want)
    assert te.item_plan() is plan and plan.L == tell.ITEM_IDS  # cached
    assert not want[0].any() and not want[n - 1].any()      # empty rows


@pytest.mark.parametrize("order", ["stored", "shuffled"])
@pytest.mark.parametrize("w", WIDTHS)
def test_bitadj_items_plain_matches_reference_and_pallas(w, order):
    rng = np.random.default_rng(w * 5 + len(order))
    n, k = 100, 300
    jb, tb = bitadj_pair(rng, n, k, order)
    tiles, cols = tb.occupied_first()
    for xrows in (k, k - 45):           # fewer frontier rows than C*32
        xw = words(rng, xrows, w)
        want = np.asarray(jbitadj.mxm_words(jb, jnp.asarray(xw)))
        pallas = np.asarray(jbitadj_mxv.bitadj_mxv_packed(
            jb, jnp.asarray(xw), interpret=True))
        np.testing.assert_array_equal(pallas, want)
        xt = torch.from_numpy(xw.view(np.int32))
        for plan in (tbitadj.slot_plan(cols, n, tb.n_ctiles, 2),
                     tb.slot_plan()):
            got = bitadj_mxv.bitadj_mxv_items_plain(tiles, cols, plan, xt,
                                                    tb.shape)
            np.testing.assert_array_equal(u32(got), want)
        assert tb.slot_plan() is plan and plan.K == tbitadj.ITEM_SLOTS
        assert not want[64:96].any()                         # empty panel

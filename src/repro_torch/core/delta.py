"""Delta matrices: live mutations over a frozen base, the fifth storage kind.

Port of ``repro.core.delta``. RedisGraph's write path never rebuilds the
adjacency on a write: each relation keeps small pending additions and
deletions that merge lazily into the main matrix. :class:`DeltaMatrix` is
that form: a frozen base (BSR, ELL or a dense tensor) plus two small
host-side COO sets,

  plus   entries added (or overwritten) since the base froze,
  minus  base entries deleted since the base froze,

with the effective matrix ``(base \\ minus) overridden-by plus``. The shape
may be larger than the base's: node creation grows the matrix without
touching the frozen storage.

Dispatch lives behind ``grb.GBMatrix`` (fmt ``"delta"``). Result row i of a
product depends only on matrix row i, so ``mxm(D, B)`` is the base's
product with the rows the deltas touch overwritten by the product of a
small ELL *patch* (:meth:`DeltaMatrix.patch`) holding their exact
effective content. Both products run where the base lies: on a CUDA base
the base's kernel and the patch's kernel launch on the card. The
element-wise family and SpGEMM take a :meth:`materialize` in the base's
own format, folded anew at each call and never kept on the handle: a
served view lives as long as its readers, and a fold kept with it would
hold a second copy of the relation on the card.

Host and device: the base's entry index (:class:`_BaseIndex`) is one
device-to-host copy per base (``ELL.to_coo`` selects the stored slots on
the device first), shared by every later handle over that base; the
patch and the materialization are composed on the host (numpy, as in the
JAX package) and placed on the base's device. Nothing here writes into a
base tensor: the base carries the kernels' cached forms, and a reader
holding an earlier handle must keep its answers.

Updates are functional: :meth:`apply_ops` returns a new DeltaMatrix
sharing the base and its index, so a reader holding an earlier handle
keeps a snapshot-consistent view while a writer streams edits.

Compaction: once the pending-entry count crosses ``AUTO_DELTA_COMPACT *
base_nnz`` (:func:`needs_compaction`), callers (``engine.MutableGraph``)
fold the deltas into a fresh base with :meth:`compact`.

Invariants (kept by :meth:`apply_ops`):
  * ``minus`` keys all lie in the base; ``plus`` and ``minus`` are
    disjoint; ``plus`` values are nonzero (stored == nonzero).
  * adding an entry with value 0 and deleting it are the same operation.
  * nnz is exact: ``base.nnz - |minus| + |plus keys not in base|``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import xfer
from repro_torch.core.bsr import BSR
from repro_torch.core.ell import ELL

# -- compaction policy -----------------------------------------------------
# The JAX package's value, measured there on its XLA-CPU reference (R-MAT
# scale 12): delta-served reads stay within 1.3-1.4x of compacted reads up
# to 5% pending, then pass 4x at 10%. Kept for parity; the card's own
# curve is in PERF.md (chip_smoke.py, phase write_read_cost).
AUTO_DELTA_COMPACT = 0.05


def needs_compaction(d: "DeltaMatrix") -> bool:
    """Pending deltas past this fraction of the base's stored entries."""
    return d.pending > AUTO_DELTA_COMPACT * max(d.base_nnz, 1)


BaseStorage = Union[BSR, ELL, torch.Tensor]

# one edit: ("add", row, col, value) | ("del", row, col, 0.0)
Op = Tuple[str, int, int, float]


class _BaseIndex:
    """Host-side entry index of a frozen base, built once and shared by
    every DeltaMatrix over that base: one device-to-host copy per base,
    never one per write."""

    def __init__(self, store: BaseStorage):
        if isinstance(store, (BSR, ELL)):
            if isinstance(store, ELL):
                xfer.record("delta_index")   # BSR.to_coo records its own
            r, c, v = store.to_coo()
        else:
            xfer.record("delta_index")
            r, c = torch.nonzero(store, as_tuple=True)
            v = store[r, c].cpu().numpy()
            r, c = r.cpu().numpy(), c.cpu().numpy()
        self.rows = np.asarray(r, dtype=np.int64)
        self.cols = np.asarray(c, dtype=np.int64)
        self.vals = np.asarray(v, dtype=np.float32)
        # row-sorted view for O(deg) touched-row gathers
        order = np.argsort(self.rows, kind="stable")
        self.r_sorted = self.rows[order]
        self.c_sorted = self.cols[order]
        self.v_sorted = self.vals[order]
        self.nnz = len(self.rows)
        self._keys = {}

    def keys(self, ncols: int) -> np.ndarray:
        """Sorted entry keys under a (possibly grown) column extent, cached
        per extent."""
        k = self._keys.get(int(ncols))
        if k is None:
            k = self._keys[int(ncols)] = np.sort(self.rows * int(ncols)
                                                 + self.cols)
        return k

    def row_slice(self, rows: np.ndarray):
        """(rows, cols, vals) of base entries whose row is in ``rows``
        (unique, ascending), by binary search on the row-sorted view."""
        lo = np.searchsorted(self.r_sorted, rows, side="left")
        hi = np.searchsorted(self.r_sorted, rows, side="right")
        lens = hi - lo
        # the ranges [lo, hi) laid end to end, without a loop over rows
        take = np.arange(int(lens.sum()), dtype=np.int64) + np.repeat(
            lo - (np.cumsum(lens) - lens), lens)
        return (self.r_sorted[take], self.c_sorted[take],
                self.v_sorted[take])


def _shape_of(store: BaseStorage) -> Tuple[int, int]:
    return tuple(store.shape)


def _in_sorted(sorted_keys: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Membership of ``query`` keys in a sorted key array."""
    if len(sorted_keys) == 0:
        return np.zeros(len(query), dtype=bool)
    j = np.clip(np.searchsorted(sorted_keys, query), 0,
                len(sorted_keys) - 1)
    return sorted_keys[j] == query


def _pow2_at_least(x: int, lo: int = 8) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass(eq=False)
class DeltaMatrix:
    """Frozen base + pending plus/minus COO deltas (module docstring).

    Treat instances as immutable: every mutation goes through
    :meth:`apply_ops` / :meth:`resize`, which return a new DeltaMatrix
    sharing the base and its host index. The row patch is cached per
    instance, on the base's device; the whole fold (``materialize``) is
    not.
    """
    base: BaseStorage
    shape: Tuple[int, int]
    plus_r: np.ndarray          # int64 rows of added/overridden entries
    plus_c: np.ndarray          # int64 cols
    plus_v: np.ndarray          # f32 values (all nonzero)
    minus_r: np.ndarray         # int64 rows of deleted base entries
    minus_c: np.ndarray         # int64 cols

    def __post_init__(self):
        self._index: Optional[_BaseIndex] = None
        self._patch = None      # (ELL, scatter rows) or (None, None)
        self._touched = 0       # the patch's real rows

    # -- construction ------------------------------------------------------
    @classmethod
    def wrap(cls, store: BaseStorage,
             shape: Optional[Tuple[int, int]] = None) -> "DeltaMatrix":
        """Empty-delta view over a frozen base. ``shape`` >= base shape
        grows the matrix (new rows/cols served from future deltas). A
        BitELL base becomes its cached ELL (a bit tile has no row patch)."""
        if isinstance(store, DeltaMatrix):
            return store if shape is None else store.resize(shape)
        from repro_torch.core.bitadj import BitELL
        if isinstance(store, BitELL):
            store = store.to_ell()
        if not isinstance(store, (BSR, ELL, torch.Tensor)):
            raise TypeError(f"DeltaMatrix base must be BSR, ELL, BitELL or "
                            f"a dense tensor, got {type(store).__name__}")
        bshape = _shape_of(store)
        shape = bshape if shape is None else tuple(shape)
        if shape[0] < bshape[0] or shape[1] < bshape[1]:
            raise ValueError(f"DeltaMatrix shape {shape} smaller than base "
                             f"{bshape} — deltas grow, never shrink")
        z = np.zeros(0, dtype=np.int64)
        return cls(store, shape, z, z, np.zeros(0, np.float32), z.copy(),
                   z.copy())

    def _with(self, **kw) -> "DeltaMatrix":
        d = dataclasses.replace(self, **kw)
        d._index = self._index           # base is shared; so is its index
        return d

    # -- introspection -----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def index(self) -> _BaseIndex:
        if self._index is None:
            self._index = _BaseIndex(self.base)
        return self._index

    @property
    def base_nnz(self) -> int:
        if isinstance(self.base, (BSR, ELL)):
            return self.base.nnz
        return int(torch.count_nonzero(self.base))

    @property
    def pending(self) -> int:
        """Pending delta entries (the compaction policy's quantity)."""
        return len(self.plus_r) + len(self.minus_r)

    @property
    def nnz(self) -> int:
        """Exact effective stored-entry count."""
        if self.pending == 0:
            return self.base_nnz
        m = self.shape[1]
        bk = self.index.keys(m)
        new = ~_in_sorted(bk, self.plus_r * m + self.plus_c)
        return self.base_nnz - len(self.minus_r) + int(new.sum())

    @property
    def fmt(self) -> str:
        """Base storage format the deltas compact back into."""
        if isinstance(self.base, BSR):
            return "bsr"
        if isinstance(self.base, ELL):
            return "ell"
        return "dense"

    def __repr__(self) -> str:
        n, m = self.shape
        return (f"DeltaMatrix {n}x{m} base={self.fmt}{_shape_of(self.base)} "
                f"+{len(self.plus_r)}/-{len(self.minus_r)} nnz={self.nnz}")

    # -- mutation (functional) ---------------------------------------------
    def resize(self, shape: Tuple[int, int]) -> "DeltaMatrix":
        shape = tuple(shape)
        if shape == self.shape:
            return self
        if shape[0] < self.shape[0] or shape[1] < self.shape[1]:
            raise ValueError(f"DeltaMatrix resize {self.shape} -> {shape}: "
                             f"deltas grow, never shrink")
        return self._with(shape=shape)

    def apply_ops(self, ops: Sequence[Op],
                  grow_to: Optional[Tuple[int, int]] = None) -> "DeltaMatrix":
        """One ordered batch of edits -> a new DeltaMatrix (self unchanged).

        ops: ("add", i, j, w) sets entry (i, j) to w (w == 0 deletes);
             ("del", i, j, _) deletes it (a no-op if absent). Later ops
             win.
        """
        out = self if grow_to is None else self.resize(grow_to)
        if not ops:
            return out
        n, m = out.shape
        plus = {(int(r), int(c)): float(v)
                for r, c, v in zip(out.plus_r, out.plus_c, out.plus_v)}
        minus = set(zip(out.minus_r.tolist(), out.minus_c.tolist()))
        # base membership of every op's key, looked up once for the batch
        ij = np.asarray([(int(i), int(j)) for _, i, j, _ in ops],
                        dtype=np.int64).reshape(-1, 2)
        in_base = _in_sorted(self.index.keys(m), ij[:, 0] * m + ij[:, 1])
        for (kind, _, _, w), (i, j), based in zip(ops, ij.tolist(),
                                                   in_base.tolist()):
            if i >= n or j >= m or i < 0 or j < 0:
                raise ValueError(f"delta op {kind} ({i}, {j}) out of bounds "
                                 f"for shape {(n, m)}")
            key = (i, j)
            if kind == "add" and w != 0.0:
                minus.discard(key)
                plus[key] = float(w)
            else:                         # delete (or add of an explicit 0)
                plus.pop(key, None)
                if based:
                    minus.add(key)
        pk = sorted(plus)
        mk = sorted(minus)
        return out._with(
            plus_r=np.asarray([k[0] for k in pk], dtype=np.int64),
            plus_c=np.asarray([k[1] for k in pk], dtype=np.int64),
            plus_v=np.asarray([plus[k] for k in pk], dtype=np.float32),
            minus_r=np.asarray([k[0] for k in mk], dtype=np.int64),
            minus_c=np.asarray([k[1] for k in mk], dtype=np.int64))

    # -- composition -------------------------------------------------------
    def touched_rows(self) -> np.ndarray:
        """Unique rows any pending delta touches."""
        return np.unique(np.concatenate([self.plus_r, self.minus_r]))

    def patch(self):
        """(ELL patch, scatter rows): the exact effective content of the
        delta-touched rows, the row half of the mxm / reduce composition,
        on the base's device.

        The patch holds only the t touched rows, its row count and ELL
        width bucketed up to powers of two as in the JAX package (there
        to bound XLA compiles; kept so both packages hold equal patches).
        ``rows`` maps patch row -> matrix row, padded with the
        out-of-bounds index n: consumers scatter only the first
        :attr:`touched` rows. (None, None) if no deltas are pending."""
        if self._patch is None:
            if self.pending == 0:
                self._patch = (None, None)
            else:
                n, m = self.shape
                rows = self.touched_rows()
                br, bc, bv = self.index.row_slice(rows)
                k = br * m + bc
                drop = _in_sorted(np.sort(self.minus_r * m + self.minus_c), k)
                drop |= _in_sorted(np.sort(self.plus_r * m + self.plus_c), k)
                er = np.concatenate([br[~drop], self.plus_r])
                ec = np.concatenate([bc[~drop], self.plus_c])
                ev = np.concatenate([bv[~drop], self.plus_v])
                er = np.searchsorted(rows, er)      # patch-local row ids
                t = len(rows)
                tp = _pow2_at_least(t)
                md = int(np.bincount(er, minlength=1).max()) if len(er) else 1
                pad = _pow2_at_least(md)
                scatter = np.full(tp, n, dtype=np.int32)
                scatter[:t] = rows
                dev = self.device
                self._touched = t
                self._patch = (ELL.from_coo(er, ec, ev, (tp, m),
                                            pad_deg_to=pad, device=dev),
                               torch.from_numpy(scatter).to(dev))
        return self._patch

    @property
    def touched(self) -> int:
        """Real rows of :meth:`patch` (the rest scatter nowhere)."""
        self.patch()
        return self._touched

    def effective_coo(self):
        """(rows, cols, vals) of the effective matrix, base minus
        deletions, overridden/extended by the plus set (numpy)."""
        m = self.shape[1]
        idx = self.index
        k = idx.rows * m + idx.cols
        drop = _in_sorted(np.sort(self.minus_r * m + self.minus_c), k)
        drop |= _in_sorted(np.sort(self.plus_r * m + self.plus_c), k)
        return (np.concatenate([idx.rows[~drop], self.plus_r]),
                np.concatenate([idx.cols[~drop], self.plus_c]),
                np.concatenate([idx.vals[~drop], self.plus_v]))

    def materialize(self) -> BaseStorage:
        """Effective matrix in the base's own format, on its device: the
        fallback of the element-wise family and SpGEMM, and the compaction
        product. Equal entries give storage equal to a fresh build of the
        same format. Folded at each call and held by the caller alone, so
        the card frees it with the caller's reference (the JAX package
        caches it on the handle)."""
        dev = self.device
        if self.pending == 0 and self.shape == _shape_of(self.base):
            return self.base
        if isinstance(self.base, BSR):
            r, c, v = self.effective_coo()
            return BSR.from_coo(r, c, v, self.shape, block=self.base.block,
                                device=dev)
        if isinstance(self.base, ELL):
            r, c, v = self.effective_coo()
            return ELL.from_coo(r, c, v, self.shape, device=dev)
        mat = torch.zeros(self.shape, dtype=torch.float32, device=dev)
        bn, bm = _shape_of(self.base)
        mat[:bn, :bm] = self.base
        if len(self.minus_r):
            mat[torch.from_numpy(self.minus_r).to(dev),
                torch.from_numpy(self.minus_c).to(dev)] = 0.0
        if len(self.plus_r):
            mat[torch.from_numpy(self.plus_r).to(dev),
                torch.from_numpy(self.plus_c).to(dev)] = \
                torch.from_numpy(self.plus_v).to(dev)
        return mat

    def compact(self) -> "DeltaMatrix":
        """Fold the deltas into a fresh base (empty-delta DeltaMatrix)."""
        return DeltaMatrix.wrap(self.materialize())

    # -- storage protocol (what GBMatrix forwards) -------------------------
    def to_dense(self) -> torch.Tensor:
        if isinstance(self.base, (BSR, ELL)):
            dev = self.device
            d = torch.zeros(self.shape, dtype=torch.float32, device=dev)
            r, c, v = self.effective_coo()
            d[torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)] = \
                torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            return d
        return self.materialize()        # dense base: the scatter above

    def to_coo(self):
        r, c, v = self.effective_coo()
        order = np.argsort(r * self.shape[1] + c)
        return (r[order].astype(np.int64), c[order].astype(np.int64),
                v[order].astype(np.float32))

    def transpose(self) -> "DeltaMatrix":
        """Transposed delta view. The graph layer keeps linked twins by
        applying swapped deltas (``engine.MutableGraph``); this serves an
        unlinked ``.T`` on a bare delta handle."""
        bt = self.base.t().contiguous() if isinstance(self.base, torch.Tensor) \
            else self.base.transpose()
        return DeltaMatrix(bt, (self.shape[1], self.shape[0]),
                           self.plus_c.copy(), self.plus_r.copy(),
                           self.plus_v.copy(), self.minus_c.copy(),
                           self.minus_r.copy())

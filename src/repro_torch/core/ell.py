"""ELL / padded-gather format: the hypersparse (power-law) path.

Port of ``repro.core.ell``. Per vertex, a padded list of neighbor ids: every
row is padded to the widest row's degree (rounded up to ``pad_deg_to``), in
the same slot order as the JAX package, so both packages hold identical
``indices`` / ``mask`` / ``values`` arrays for one edge list.

The tensors live on one ``device``; construction runs in numpy on the host
and copies once. Two cached forms serve the packed kernel
(``kernels.bitmap_mxv``), each built once per matrix on its device:
``row_csr`` (the valid ids as one CSR over the rows) and ``item_plan``
(its split into work items of at most L ids). ``sentinel_indices`` (valid
slots first, then the sentinel k) is the padded spelling of the same
order.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# ids per work item of the packed kernel (``ELL.item_plan``): 32 to 512
# lie within the run-to-run spread at the Graph500 scale-16 path shape
# (tools/word_kernels.py --sweep on an H100)
ITEM_IDS = 128
# the plan's per-edge word: the row in the low 30 bits, then two flags
ROW_BITS = 30
FIRST_EDGE = 1 << 30        # the edge opens its row
LAST_EDGE = 1 << 31         # the edge closes its row


class RowCSR(NamedTuple):
    """The valid ids as one CSR over the rows: row i holds
    ``ids[row_ptr[i]:row_ptr[i + 1]]`` in the valid-first order of
    ``ELL.sentinel_indices``."""
    row_ptr: torch.Tensor   # (n + 1,) int64
    ids: torch.Tensor       # (nnz,) int32


@dataclasses.dataclass
class ItemPlan:
    """The packed kernel's work: item i takes the ids ``[i * L, min((i +
    1) * L, nnz))`` of the CSR, so every item holds L ids but the last, a
    hub row is split over several items and short rows share one.

    ``edge_rows`` holds, per id, its row with ``FIRST_EDGE`` / ``LAST_EDGE``
    set where the id opens / closes the row (int32 bit pattern), so an item
    finds its rows without the row pointers. A row cut by an item boundary
    is OR-merged into the output, so it is zeroed first, as are the empty
    rows, which no item reaches: ``zero_rows``."""
    L: int
    items: int
    edge_rows: torch.Tensor   # (nnz,) int32
    zero_rows: torch.Tensor   # (z,) int32: the split rows, then the empty
    split_rows: int           # the first split_rows of zero_rows
    longest_row: int


def item_plan(csr: RowCSR, L: int = ITEM_IDS) -> ItemPlan:
    """Split a RowCSR into items of L ids (``ItemPlan``), on its device
    with no host loop."""
    if L < 1:
        raise ValueError(f"item_plan: L must be positive, got {L}")
    row_ptr = csr.row_ptr
    n = row_ptr.shape[0] - 1
    if n >= 1 << ROW_BITS:
        raise ValueError(f"item_plan: {n} rows do not fit {ROW_BITS} bits")
    dev = row_ptr.device
    nnz = int(csr.ids.shape[0])
    deg = row_ptr.diff()
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    erow = torch.repeat_interleave(rows, deg)
    full = deg > 0
    word = erow.clone()
    word[row_ptr[:-1][full]] |= FIRST_EDGE
    word[row_ptr[1:][full] - 1] |= LAST_EDGE
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    # a boundary b splits the row of id b when id b - 1 lies in it too
    items = -(-nnz // L)
    bounds = torch.arange(1, max(items, 1), dtype=torch.int64, device=dev) * L
    cut = bounds[erow[bounds] == erow[bounds - 1]]
    split = torch.unique(erow[cut])
    empty = rows[~full]
    return ItemPlan(L=L, items=items,
                    edge_rows=word.to(torch.int32).contiguous(),
                    zero_rows=torch.cat([split, empty]).to(
                        torch.int32).contiguous(),
                    split_rows=int(split.shape[0]),
                    longest_row=int(deg.max()) if n else 0)


@dataclasses.dataclass
class ELL:
    shape: Tuple[int, int]
    indices: torch.Tensor  # (n, max_deg) int32 neighbor ids, padded with 0
    mask: torch.Tensor     # (n, max_deg) bool validity
    values: torch.Tensor   # (n, max_deg) float32 edge weights (1.0 structural)
    nnz: int
    # valid ids first, then k: the padded spelling, cached per matrix
    _sentinel: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    # the packed kernel's operands: the CSR and its work plan
    _csr: Optional[RowCSR] = dataclasses.field(
        default=None, repr=False, compare=False)
    _plan: Optional[ItemPlan] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def max_deg(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @staticmethod
    def from_coo(rows, cols, vals, shape, pad_deg_to: int = 8,
                 device="cuda") -> "ELL":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if vals is None:
            vals = np.ones(rows.shape[0], dtype=np.float32)
        vals = np.asarray(vals, dtype=np.float32)
        n, _ = shape
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        deg = np.bincount(rows, minlength=n)
        md = int(deg.max()) if deg.size and deg.max() > 0 else 1
        md = md + (-md) % pad_deg_to
        idx = np.zeros((n, md), dtype=np.int32)
        msk = np.zeros((n, md), dtype=bool)
        val = np.zeros((n, md), dtype=np.float32)
        # slot position of each edge within its row
        starts = np.zeros(n + 1, dtype=np.int64)
        starts[1:] = np.cumsum(deg)
        slot = np.arange(rows.shape[0]) - starts[rows]
        idx[rows, slot] = cols
        msk[rows, slot] = True
        val[rows, slot] = vals
        dev = torch.device(device)
        return ELL(shape=(n, shape[1]),
                   indices=torch.from_numpy(idx).to(dev),
                   mask=torch.from_numpy(msk).to(dev),
                   values=torch.from_numpy(val).to(dev),
                   nnz=int(rows.shape[0]))

    @staticmethod
    def from_entries(keys, vals, shape, pad_deg_to: int = 8,
                     device="cuda") -> "ELL":
        """Build from flat row-major entry keys (``row * ncols + col``), the
        spelling the COO set algebra (``core.coo``) hands back."""
        w = max(shape[1], 1)
        keys = np.asarray(keys, dtype=np.int64)
        return ELL.from_coo(keys // w, keys % w, vals, shape,
                            pad_deg_to=pad_deg_to, device=device)

    @staticmethod
    def from_dense(A, pad_deg_to: int = 8, device=None) -> "ELL":
        """The nonzero entries of a dense matrix (tensor or numpy), row by
        row; on the tensor's device unless ``device`` is given (numpy input
        defaults to ``"cuda"``)."""
        if device is None:
            device = A.device if isinstance(A, torch.Tensor) else "cuda"
        A = A.cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
        r, c = np.nonzero(A)
        return ELL.from_coo(r, c, A[r, c].astype(np.float32), A.shape,
                            pad_deg_to=pad_deg_to, device=device)

    def sentinel_indices(self) -> torch.Tensor:
        """(n, max_deg) int32: each row's valid ``indices`` first, then k in
        every other slot, so a row ends at its first k. ``from_coo`` already
        stores rows valid-first; other storage is reordered within its rows
        (OR does not depend on slot order). Built once, then cached."""
        if self._sentinel is None:
            k = self.shape[1]
            m = self.mask
            idx = torch.where(m, self.indices, torch.full_like(self.indices, k))
            if bool((m[:, 1:] & ~m[:, :-1]).any()):
                order = torch.argsort((~m).to(torch.int8), dim=1, stable=True)
                idx = idx.gather(1, order)
            self._sentinel = idx.contiguous()
        return self._sentinel

    def row_csr(self) -> RowCSR:
        """The valid ids as one CSR over the rows, each row in the
        valid-first order of ``sentinel_indices`` (its valid slots in slot
        order), without the padded copy. Built once, on the device."""
        if self._csr is None:
            m = self.mask
            row_ptr = torch.zeros(self.shape[0] + 1, dtype=torch.int64,
                                  device=self.device)
            row_ptr[1:] = torch.cumsum(m.sum(dim=1), dim=0)
            self._csr = RowCSR(row_ptr=row_ptr,
                               ids=self.indices[m].to(torch.int32))
        return self._csr

    def item_plan(self) -> ItemPlan:
        """``item_plan(self.row_csr())``: items of ``ITEM_IDS`` ids. Built
        once, on the device."""
        if self._plan is None:
            self._plan = item_plan(self.row_csr())
        return self._plan

    def to_coo(self):
        """Host-side COO extraction (rows, cols, vals as numpy); the
        selection runs on the storage's device."""
        r, s = torch.nonzero(self.mask, as_tuple=True)
        return (r.cpu().numpy().astype(np.int64),
                self.indices[r, s].cpu().numpy().astype(np.int64),
                self.values[r, s].cpu().numpy())

    def to_dense(self) -> torch.Tensor:
        n, m = self.shape
        out = torch.zeros((n, m), dtype=torch.float32, device=self.device)
        r, s = torch.nonzero(self.mask, as_tuple=True)
        out[r, self.indices[r, s].long()] = self.values[r, s]
        return out

    def transpose(self) -> "ELL":
        r, c, v = self.to_coo()
        return ELL.from_coo(c, r, v, (self.shape[1], self.shape[0]),
                            device=self.device)

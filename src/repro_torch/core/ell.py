"""ELL / padded-gather format: the hypersparse (power-law) path.

Port of ``repro.core.ell``. Per vertex, a padded list of neighbor ids: every
row is padded to the widest row's degree (rounded up to ``pad_deg_to``), in
the same slot order as the JAX package, so both packages hold identical
``indices`` / ``mask`` / ``values`` arrays for one edge list.

The tensors live on one ``device``; construction runs in numpy on the host
and copies once. ``sentinel_indices`` caches the kernel's spelling of the
structure (valid slots first, then the sentinel k), built once per matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ELL:
    shape: Tuple[int, int]
    indices: torch.Tensor  # (n, max_deg) int32 neighbor ids, padded with 0
    mask: torch.Tensor     # (n, max_deg) bool validity
    values: torch.Tensor   # (n, max_deg) float32 edge weights (1.0 structural)
    nnz: int
    # valid ids first, then k: the packed kernel's operand, cached per matrix
    _sentinel: Optional[torch.Tensor] = dataclasses.field(
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

"""Host-side COO set algebra for the sparse element-wise / assign / extract
paths.

Port of ``repro.core.coo`` (numpy only, the JAX package's code). Every
sparse format (BSR tile lists, ELL padded rows) can hand its stored entries
over as flat ``(row * ncols + col)`` int64 keys plus f32 values. This
module implements the GraphBLAS entry-set operations on those key lists —
union-merge (eWiseAdd / accum), intersection (eWiseMult), pattern
restriction (<M> / <!M>) and the full descriptor blend — so the ELL
element-wise family and the GrB_assign/extract analogs never materialize a
dense matrix. The BSR family has its own block-aligned plans
(``repro_torch.core.bsr``); this is the format-neutral fallback.

Convention: stored == nonzero; an absent entry renders as 0. An ``op``
is a torch callable (a named op of ``core.semiring``, a ``Monoid``'s op or
any function of tensors): ``call_op`` hands it the values as CPU tensors
and takes a tensor or an array back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Entries = Tuple[np.ndarray, np.ndarray]  # (int64 keys, f32 values)


def keys_of(rows, cols, ncols: int) -> np.ndarray:
    return (np.asarray(rows, dtype=np.int64) * int(ncols)
            + np.asarray(cols, dtype=np.int64))


def call_op(op, *vals: np.ndarray) -> np.ndarray:
    """``op`` applied to host value arrays, as CPU tensors; float32 out."""
    out = op(*(torch.from_numpy(np.asarray(v)) for v in vals))
    if isinstance(out, torch.Tensor):
        out = out.numpy()
    return np.asarray(out, dtype=np.float32)


def _as_entries(k, v) -> Entries:
    k = np.asarray(k, dtype=np.int64)
    v = np.asarray(v, dtype=np.float32)
    return k, v


def _match(k1: np.ndarray, k2: np.ndarray):
    """For each key in k2, its position in k1 (k1 sorted by caller) or a
    miss. Returns (positions, hit_mask)."""
    if len(k1) == 0:
        return np.zeros(len(k2), np.int64), np.zeros(len(k2), bool)
    j = np.clip(np.searchsorted(k1, k2), 0, len(k1) - 1)
    return j, k1[j] == k2


def union(k1, v1, k2, v2, op) -> Entries:
    """GraphBLAS union-merge: op(a, b) where both stored, pass-through where
    only one side is (the absent side is never fed to op)."""
    k1, v1 = _as_entries(k1, v1)
    k2, v2 = _as_entries(k2, v2)
    order = np.argsort(k1)
    k1, v1 = k1[order], v1[order]
    j, hit = _match(k1, k2)
    merged2 = v2.copy()
    if hit.any():
        merged2[hit] = call_op(op, v1[j[hit]], v2[hit])
    only1 = np.ones(len(k1), dtype=bool)
    only1[j[hit]] = False
    keys = np.concatenate([k1[only1], k2])
    vals = np.concatenate([v1[only1], merged2])
    order = np.argsort(keys)
    return keys[order], vals[order]


def intersect(k1, v1, k2, v2, op) -> Entries:
    """GraphBLAS intersection: op(a, b) on keys stored in both."""
    k1, v1 = _as_entries(k1, v1)
    k2, v2 = _as_entries(k2, v2)
    order = np.argsort(k1)
    k1, v1 = k1[order], v1[order]
    j, hit = _match(k1, k2)
    vals = call_op(op, v1[j[hit]], v2[hit])
    return k2[hit], vals


def restrict(k, v, mask_keys: np.ndarray, complement: bool = False) -> Entries:
    """Entries whose key is in (out of, when complemented) the mask set."""
    k, v = _as_entries(k, v)
    member = np.isin(k, mask_keys)
    keep = ~member if complement else member
    return k[keep], v[keep]


def blend(kz, vz, kc: Optional[np.ndarray], vc: Optional[np.ndarray],
          mask_keys: Optional[np.ndarray], complement: bool,
          accum_op, replace: bool) -> Entries:
    """The descriptor blend rule (grb.finalize) on entry sets.

      z      = union-accum(C, result)  when accum and C given, else result
      inside  the mask: z
      outside the mask: absent when C is None or replace, else old C
    """
    kz, vz = _as_entries(kz, vz)
    if accum_op is not None and kc is not None:
        kz, vz = union(kc, vc, kz, vz, accum_op)
    if mask_keys is None:
        return kz, vz
    kin, vin = restrict(kz, vz, mask_keys, complement)
    if kc is None or replace:
        return kin, vin
    kout, vout = restrict(kc, vc, mask_keys, not complement)
    keys = np.concatenate([kin, kout])       # disjoint by construction
    vals = np.concatenate([vin, vout])
    order = np.argsort(keys)
    return keys[order], vals[order]


def nonzero(keys: np.ndarray, vals: np.ndarray) -> Entries:
    """Drop explicit zeros (stored == nonzero hygiene after an op)."""
    keep = vals != 0
    return keys[keep], vals[keep]


def extract_entries(rows, cols, vals, I: np.ndarray, J: np.ndarray,
                    n: int, m: int):
    """Entries of A[I, J] in local coordinates (GrB_extract relabeling):
    keep entries whose row is in I and col in J, remap to positions."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    lutr = np.full(n, -1, dtype=np.int64)
    lutr[I] = np.arange(len(I))
    lutc = np.full(m, -1, dtype=np.int64)
    lutc[J] = np.arange(len(J))
    keep = (lutr[rows] >= 0) & (lutc[cols] >= 0)
    return lutr[rows[keep]], lutc[cols[keep]], vals[keep]

"""Semiring matmuls over BSR and ELL storage, and storage auto-selection.

Port of ``repro.core.ops``:

  apply_mask      the legacy kwargs spelling of ``grb.finalize``;
  bsr_mxm_plain   Y = A_bsr (x) X in the five semiring modes: batched tile
                  products and a segment reduction over block-rows, the
                  port of ``bsr_mxm_jnp`` and the plain version of the CUDA
                  kernel ``kernels.bsr_mxm``.
  ell_mxm         the float gather + masked reduce (plus_times walk counts
                  and narrow or_and frontiers), over chunks of rows. The
                  JAX package runs it as XLA outside any Pallas kernel, so
                  it stays plain torch.
  ell_mxm_packed  the or_and gather-OR on packed frontier words: the plain
                  version of the CUDA kernel ``kernels.bitmap_mxv``.
  dense_mxm_packed  the same for a dense A, over chunks of its columns.
  mxm / mxv / vxm the legacy kwargs spelling of ``grb.mxm`` over raw
                  storage.
  auto_format     the fmt="auto" storage choice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import semiring as S
from repro_torch.core.bsr import BSR
from repro_torch.core.ell import ELL

# entries of one chunk's gathered frontier tiles (or bcast products) in
# bsr_mxm_plain: the JAX reference gathers one X tile per stored tile at
# once, (nnzb, b, F), which is 24.6 GB for Graph500 scale 16 at F = 512;
# and of one chunk's gathered (rows, deg, F) frontier in ell_mxm, 105 GB
# for the scale-16 ELL (a hub of 6,272 slots) at F = 64
_CHUNK_ENTRIES = 1 << 27


def apply_mask(result: torch.Tensor, mask: Optional[torch.Tensor],
               complement: bool, accum: Optional[S.Monoid],
               old: Optional[torch.Tensor], identity: float) -> torch.Tensor:
    """GraphBLAS C<M> (+)= result, replace semantics when old is None: the
    legacy kwargs spelling of :func:`repro_torch.core.grb.finalize`."""
    from repro_torch.core import grb
    d = grb.Descriptor(mask=mask, complement=complement, accum=accum)
    return grb.finalize(d, result, old, identity)


def _segment_reduce(vals: torch.Tensor, ids: torch.Tensor, num: int,
                    monoid: S.Monoid, out=None) -> torch.Tensor:
    """Reduce ``vals`` (k, ...) into ``num`` segments by ``ids`` (k,) under
    ``monoid``; empty segments hold its identity. With ``out`` the reduction
    folds into that accumulator (earlier chunks' segments) in place."""
    if out is None:
        out = torch.full((num,) + tuple(vals.shape[1:]), monoid.identity,
                         dtype=vals.dtype, device=vals.device)
    ids = ids.long()
    if monoid.name == "plus":
        return out.index_add_(0, ids, vals)
    how = {"or": "amax", "max": "amax", "min": "amin"}.get(monoid.name)
    if how is None:
        raise NotImplementedError(monoid.name)
    idx = ids.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce_(0, idx.contiguous(), vals, reduce=how,
                               include_self=True)


def bsr_mxm_plain(A: BSR, X: torch.Tensor, sr: S.Semiring) -> torch.Tensor:
    """Y = A (x) X with A in BSR: batched (b x b) @ (b x F) tile products
    and a segment reduction over block-rows, over chunks of tiles so the
    gathered frontier tiles stay bounded. Padding tiles (valid = 0)
    contribute nothing. bcast reads the ``emask`` where A has one, so a
    stored zero-weight edge relaxes instead of vanishing."""
    n, m = A.shape
    b = A.block
    f = X.shape[1]
    nbr, nbc = A.nbrows, A.nbcols
    Xp = torch.zeros((nbc * b, f), dtype=torch.float32, device=X.device)
    Xp[:m] = X.to(torch.float32)
    Xb = Xp.view(nbc, b, f)
    y = torch.full((nbr, b, f), sr.identity, dtype=torch.float32,
                   device=X.device)
    per = b * f * (b if sr.mode == "bcast" else 1)
    step = max(1, _CHUNK_ENTRIES // max(per, 1))
    ident = torch.tensor(sr.identity, dtype=torch.float32, device=X.device)
    for lo in range(0, A.nnzb, step):
        hi = min(lo + step, A.nnzb)
        blocks = A.blocks[lo:hi].to(torch.float32)
        Xg = Xb[A.block_cols[lo:hi].long()]            # (c, b, f)
        valid = A.valid[lo:hi] != 0
        if sr.mode == "dot":
            contrib = torch.bmm(blocks, Xg)
        elif sr.mode in ("dot_indicator", "dot_pair"):
            contrib = torch.bmm((blocks != 0).to(torch.float32),
                                (Xg != 0).to(torch.float32))
        elif sr.mode == "dot_first":
            contrib = torch.bmm(blocks, (Xg != 0).to(torch.float32))
        elif sr.mode == "bcast":
            stored = (blocks != 0) if A.emask is None else A.emask[lo:hi]
            a = torch.where(stored & valid[:, None, None], blocks, ident)
            prod = sr.mul(a[:, :, :, None], Xg[:, None, :, :])  # (c,b,b,f)
            contrib = sr.add.reduce(prod, dim=2)
        else:
            raise NotImplementedError(sr.mode)
        if sr.mode != "bcast":
            contrib = contrib * valid.to(torch.float32)[:, None, None]
        _segment_reduce(contrib, A.block_rows[lo:hi], nbr, sr.add, out=y)
    if sr.mode == "dot_indicator":
        y = (y > 0).to(torch.float32)
    return y.reshape(nbr * b, f)[:n]


def ell_mxm(A: ELL, X: torch.Tensor, sr: S.Semiring) -> torch.Tensor:
    """Y[i,f] = add_{j in adj(i)} mul(w_ij, X[j,f]) via gather + masked
    reduce, over chunks of rows so the gathered (rows, deg, f) frontier
    stays within ``_CHUNK_ENTRIES`` (each row reduces whole, so the result
    does not depend on the chunking)."""
    n = A.shape[0]
    step = max(1, _CHUNK_ENTRIES // max(A.max_deg * X.shape[1], 1))
    X = X.to(torch.float32)
    if step >= n:
        return _ell_mxm_rows(A.indices, A.mask, A.values, X, sr)
    return torch.cat([_ell_mxm_rows(A.indices[r0:r0 + step],
                                    A.mask[r0:r0 + step],
                                    A.values[r0:r0 + step], X, sr)
                      for r0 in range(0, n, step)])


def _ell_mxm_rows(indices, mask, values, X, sr) -> torch.Tensor:
    Xg = X[indices.long()]                             # (rows, deg, f)
    w = values[:, :, None]
    m = mask[:, :, None]
    ident = torch.tensor(sr.identity, dtype=torch.float32, device=X.device)
    if sr.mode == "dot":
        term = torch.where(m, w * Xg, ident)
    elif sr.mode in ("dot_indicator", "dot_pair"):
        term = torch.where(m & (Xg != 0), torch.ones_like(Xg), ident)
    elif sr.mode == "dot_first":
        term = torch.where(m & (Xg != 0), w, ident)
    elif sr.mode == "bcast":
        term = torch.where(m, sr.mul(w, Xg), ident)
    else:
        raise NotImplementedError(sr.mode)
    y = sr.add.reduce(term, dim=1)
    if sr.mode == "dot_indicator":
        y = (y > 0).to(torch.float32)
    return y


def ell_mxm_packed(A: ELL, Xw: torch.Tensor) -> torch.Tensor:
    """Yw[i] = OR_{j in adj(i)} Xw[j] on packed frontier words — the or_and
    gather-OR with the frontier in ``core.bitmap`` form. torch has no OR
    reduction, so the slots fold in one at a time; an invalid slot ANDs
    its gathered word with 0."""
    n, _ = A.shape
    acc = torch.zeros((n, Xw.shape[1]), dtype=Xw.dtype, device=Xw.device)
    for s in range(A.max_deg):
        keep = -A.mask[:, s].to(Xw.dtype)              # 0 or all ones
        acc |= Xw.index_select(0, A.indices[:, s]) & keep[:, None]
    return acc


def dense_mxm_packed(A: torch.Tensor, Xw: torch.Tensor,
                     k_chunk: int = 1024) -> torch.Tensor:
    """Packed or_and product for a dense A: Yw[i] = OR_{j: A[i,j] != 0}
    Xw[j]. K runs in chunks of ``k_chunk`` columns so no (n, k, W)
    temporary forms whole; each chunk is an indicator product of A's
    columns with the chunk's frontier rows unpacked to bits (a count of at
    most ``k_chunk``, exact in float32), OR-ed into the words."""
    from repro_torch.core import bitmap
    n, k = A.shape
    f = Xw.shape[1] * bitmap.WORD_BITS
    acc = torch.zeros((n, Xw.shape[1]), dtype=Xw.dtype, device=Xw.device)
    for start in range(0, k, k_chunk):
        a = (A[:, start:start + k_chunk] != 0).to(torch.float32)
        x = bitmap.unpack(Xw[start:start + k_chunk], f)
        acc |= bitmap._pack_words(a @ x)
    return acc


def mxm(A, X: torch.Tensor, sr: S.Semiring, *,
        mask: Optional[torch.Tensor] = None, complement: bool = False,
        accum: Optional[S.Monoid] = None,
        C: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Semiring matmul Y<mask> (accum)= A (x) X over raw storage or a
    handle: the legacy kwargs spelling of :func:`repro_torch.core.grb.mxm`
    (the JAX package's ``impl=`` has no counterpart: the route follows
    where the tensors lie)."""
    from repro_torch.core import grb
    d = grb.Descriptor(mask=mask, complement=complement, accum=accum)
    return grb.mxm(grb.GBMatrix.wrap(A), X, sr, d, out=C)


def mxv(A, x: torch.Tensor, sr: S.Semiring, **kw) -> torch.Tensor:
    """y = A (x) x for a single vector (a width-1 frontier)."""
    y = mxm(A, x[:, None], sr, **{
        k: (v[:, None] if k in ("mask", "C") and v is not None else v)
        for k, v in kw.items()})
    return y[:, 0]


def vxm(x: torch.Tensor, A, sr: S.Semiring, *, A_T=None,
        **kw) -> torch.Tensor:
    """y = x (x) A == A^T (x) x; pass ``A_T`` (a stored transpose) when
    there is one."""
    target = A_T if A_T is not None else _transpose(A)
    return mxv(target, x, sr, **kw)


def _transpose(A):
    from repro_torch.core import grb
    if isinstance(A, grb.GBMatrix):
        return A.T
    if isinstance(A, torch.Tensor):
        return A.t().contiguous()
    return A.transpose()


def auto_format(rows, cols, vals, shape, block: int = 128,
                bsr_min_fill: float = 0.02, device="cuda"):
    """Pick the storage kind for a COO build (fmt="auto"): BitELL for
    boolean relations whose 32x32 tiles clear ``auto_bitadj_ok``, else BSR
    when stored ``block``-tiles are at least ``bsr_min_fill`` full, else
    ELL."""
    from repro_torch.core import bitadj as _bitadj
    if _bitadj.auto_bitadj_ok(rows, cols, vals, shape):
        return _bitadj.BitELL.from_coo(rows, cols, vals, shape, device=device)
    rows_np = np.asarray(rows)
    cols_np = np.asarray(cols)
    nbc = -(-shape[1] // block)
    nb = len(np.unique(rows_np // block * nbc + cols_np // block))
    fill = len(rows_np) / max(nb * block * block, 1)
    if fill >= bsr_min_fill:
        return BSR.from_coo(rows, cols, vals, shape, block=block,
                            device=device)
    return ELL.from_coo(rows, cols, vals, shape, device=device)

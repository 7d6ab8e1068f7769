"""Semiring matmuls over BSR and ELL storage, and storage auto-selection.

Port of ``repro.core.ops``:

  bsr_mxm_plain   Y = A_bsr (x) X in the five semiring modes: batched tile
                  products and a segment reduction over block-rows, the
                  port of ``bsr_mxm_jnp`` and the plain version of the CUDA
                  kernel ``kernels.bsr_mxm``.
  ell_mxm         the float gather + masked reduce (plus_times walk counts
                  and narrow or_and frontiers). The JAX package runs it as
                  XLA outside any Pallas kernel, so it stays plain torch.
  ell_mxm_packed  the or_and gather-OR on packed frontier words: the plain
                  version of the CUDA kernel ``kernels.bitmap_mxv``.
  auto_format     the fmt="auto" storage choice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import semiring as S
from repro_torch.core.bsr import BSR
from repro_torch.core.ell import ELL

# entries of one chunk's gathered frontier tiles (or bcast products) in
# bsr_mxm_plain: the JAX reference gathers one X tile per stored tile at
# once, (nnzb, b, F), which is 24.6 GB for Graph500 scale 16 at F = 512
_CHUNK_ENTRIES = 1 << 27


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
    reduce."""
    Xg = X.to(torch.float32)[A.indices.long()]         # (n, deg, f)
    w = A.values[:, :, None]
    m = A.mask[:, :, None]
    ident = torch.tensor(sr.identity, dtype=torch.float32, device=X.device)
    if sr.mode == "dot":
        term = torch.where(m, w * Xg, ident)
    elif sr.mode == "dot_indicator":
        term = torch.where(m & (Xg != 0), torch.ones_like(Xg), ident)
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

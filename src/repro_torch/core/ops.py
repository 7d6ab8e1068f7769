"""Semiring matmuls over ELL storage, and storage auto-selection.

Port of ``repro.core.ops`` for the ELL path:

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
from repro_torch.core.ell import ELL


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
    ELL. BSR is not ported yet: where it would be chosen this raises."""
    from repro_torch.core import bitadj as _bitadj
    if _bitadj.auto_bitadj_ok(rows, cols, vals, shape):
        return _bitadj.BitELL.from_coo(rows, cols, vals, shape, device=device)
    rows_np = np.asarray(rows)
    cols_np = np.asarray(cols)
    nbc = -(-shape[1] // block)
    nb = len(np.unique(rows_np // block * nbc + cols_np // block))
    fill = len(rows_np) / max(nb * block * block, 1)
    if fill >= bsr_min_fill:
        raise NotImplementedError(
            f"fmt='auto' picks BSR here (128-block fill {fill:.4f} >= "
            f"{bsr_min_fill}); BSR storage is not ported yet (ROADMAP "
            f"'Modules to port', BSR storage with kernel bsr_mxm). Build "
            f"with fmt='ell' or fmt='bitadj'.")
    return ELL.from_coo(rows, cols, vals, shape, device=device)

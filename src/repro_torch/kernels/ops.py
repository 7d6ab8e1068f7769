"""Dispatch wrappers for the hand-written kernels.

Port of ``repro.kernels.ops``. Each takes a raw store or a ``GBMatrix``
handle. On CUDA tensors the kernel launches; on CPU tensors the plain
version runs.
"""
from __future__ import annotations

from typing import Optional

import torch


def bsr_mxm(A, X: torch.Tensor, sr, *, mask: Optional[torch.Tensor] = None,
            complement: bool = False) -> torch.Tensor:
    """Block-sparse semiring matmul with a fused <M> / <!M> epilogue
    (``kernels.bsr_mxm``)."""
    from repro_torch.kernels import bsr_mxm as _bsr
    return _bsr.bsr_mxm(getattr(A, "store", A), X, sr, mask=mask,
                        complement=complement)


def ell_mxv_packed(A, Xw: torch.Tensor) -> torch.Tensor:
    """Packed or_and gather-OR over ELL rows (``kernels.bitmap_mxv``)."""
    from repro_torch.kernels import bitmap_mxv as _bm
    return _bm.ell_mxv_packed(getattr(A, "store", A), Xw)


def bitadj_mxv_packed(A, Xw: torch.Tensor) -> torch.Tensor:
    """Bit-tile or_and product over BitELL (``kernels.bitadj_mxv``)."""
    from repro_torch.kernels import bitadj_mxv as _ba
    return _ba.bitadj_mxv_packed(getattr(A, "store", A), Xw)


def bsr_ewise(A, B, mode: str, op=None):
    """The BSR element-wise family through ``kernels.bsr_ewise`` (the
    ``core.bsr`` plans). ``mode`` is one of union | intersect | apply |
    select | mask | mask_c; the unary modes (apply, select) ignore ``B``.
    ``op`` is a named op of ``core.semiring`` or a Monoid."""
    from repro_torch.core import bsr as _b
    A = getattr(A, "store", A)
    B = getattr(B, "store", B)
    if mode == "union":
        return _b.ewise_add(A, B, op)
    if mode == "intersect":
        return _b.ewise_mult(A, B, op)
    if mode == "apply":
        return _b.apply_stored(A, op)
    if mode == "select":
        return _b.select_stored(A, op)
    if mode in ("mask", "mask_c"):
        return _b.mask_keep(A, B, complement=mode == "mask_c")
    raise ValueError(f"bsr_ewise mode {mode!r}")


def bsr_spgemm(A, B, sr, *, mask=None, complement: bool = False):
    """BSR x BSR -> BSR: the symbolic phase on the operands' device, then
    the numeric phase through ``kernels.bsr_spgemm`` (``core.bsr.spgemm``).
    ``mask`` may be a BSR, a handle, or a dense tensor (tiled
    structurally)."""
    from repro_torch.core.bsr import BSR, spgemm
    A = getattr(A, "store", A)
    B = getattr(B, "store", B)
    if mask is not None:
        mask = getattr(mask, "store", mask)
        if not isinstance(mask, BSR):
            mask = BSR.from_dense(mask, block=A.block)
    return spgemm(A, B, sr, mask=mask, complement=complement)

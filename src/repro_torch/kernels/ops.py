"""Dispatch wrappers for the hand-written kernels.

Port of ``repro.kernels.ops`` (the two word-route entries). Each takes a
raw store or a ``GBMatrix`` handle. On CUDA tensors the kernel launches;
on CPU tensors the plain version runs. The other three TPU kernels
(``bsr_mxm``, ``bsr_spgemm``, ``bsr_ewise``) are not ported yet.
"""
from __future__ import annotations

import torch


def ell_mxv_packed(A, Xw: torch.Tensor) -> torch.Tensor:
    """Packed or_and gather-OR over ELL rows (``kernels.bitmap_mxv``)."""
    from repro_torch.kernels import bitmap_mxv as _bm
    return _bm.ell_mxv_packed(getattr(A, "store", A), Xw)


def bitadj_mxv_packed(A, Xw: torch.Tensor) -> torch.Tensor:
    """Bit-tile or_and product over BitELL (``kernels.bitadj_mxv``)."""
    from repro_torch.kernels import bitadj_mxv as _ba
    return _ba.bitadj_mxv_packed(getattr(A, "store", A), Xw)

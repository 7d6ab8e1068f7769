"""Block-sparse semiring matmul: Y = A_bsr (x) X, with an optional fused
<M> / <!M> write mask.

Port of ``repro.kernels.bsr_mxm`` (the Pallas TPU kernel ``bsr_mxm``). The
kernel is hand-written CUDA C++ for ``sm_90a``, ``csrc/bsr_mxm.cu``; its
source notes what bounds it and why it is shaped as it is. It computes
all five semiring modes (dot, dot_indicator, dot_pair, dot_first, and
bcast for min_plus / max_plus, reading the BSR's ``emask`` where there is
one).

``bsr_mxm(A, X, sr, mask=..., complement=...)`` launches the kernel when
its tensors lie on a CUDA device and takes the plain version,
``core.ops.bsr_mxm_plain`` followed by the same mask epilogue, when they
lie on the CPU. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import semiring as S
from repro_torch.core.bsr import BSR
from repro_torch.core.ops import bsr_mxm_plain  # the plain version
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)

MAX_BLOCK = 128       # the kernel holds one tile's rows per thread block

_MODES = {"dot": 0, "dot_indicator": 1, "dot_pair": 2, "dot_first": 3}
_BCAST = {"min_plus": 4, "max_plus": 5}

_bound = None


def _fn():
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        fn = build.load("bsr_mxm").bsr_mxm
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def mask_epilogue(y: torch.Tensor, mask: Optional[torch.Tensor],
                  complement: bool, identity: float) -> torch.Tensor:
    """The kernel's write mask: keep ``y`` where the mask is nonzero (zero
    under ``complement``), the semiring identity elsewhere."""
    if mask is None:
        return y
    keep = (mask == 0) if complement else (mask != 0)
    return torch.where(keep, y, torch.tensor(identity, dtype=y.dtype,
                                             device=y.device))


def _mode(sr: S.Semiring) -> int:
    if sr.mode == "bcast":
        if sr.name not in _BCAST:
            raise NotImplementedError(
                f"bsr_mxm: the kernel's bcast mode computes min_plus and "
                f"max_plus, not {sr.name!r}")
        return _BCAST[sr.name]
    if sr.mode not in _MODES:
        raise NotImplementedError(f"bsr_mxm: mode {sr.mode!r}")
    return _MODES[sr.mode]


def bsr_mxm(A: BSR, X: torch.Tensor, sr: S.Semiring, *,
            mask: Optional[torch.Tensor] = None,
            complement: bool = False) -> torch.Tensor:
    """Y[i, f] = add_j mul(A[i, j], X[j, f]), then <mask> / <!mask> with the
    semiring identity outside. A: BSR (n, m); X: (m, F); mask: (n, F) or
    None. Returns (n, F) float32."""
    global launches
    n, m = A.shape
    if X.dim() != 2 or X.shape[0] != m:
        raise ValueError(f"bsr_mxm: X must be (m={m}, F), got "
                         f"{tuple(X.shape)}")
    F = X.shape[1]
    if mask is not None and tuple(mask.shape) != (n, F):
        raise ValueError(f"bsr_mxm: mask must be ({n}, {F}), got "
                         f"{tuple(mask.shape)}")
    tensors = [X] + ([] if mask is None else [mask])
    if A.device.type == "cpu" and all(t.device.type == "cpu"
                                      for t in tensors):
        return mask_epilogue(bsr_mxm_plain(A, X, sr), mask, complement,
                             sr.identity)
    if not (A.device.type == "cuda"
            and all(t.device == A.device for t in tensors)):
        raise ValueError(f"bsr_mxm: A on {A.device}, X on {X.device}"
                         + ("" if mask is None else f", mask on {mask.device}")
                         + "; all must lie on one CUDA device (or all on "
                           "the CPU)")
    mode = _mode(sr)
    if A.block > MAX_BLOCK:
        raise ValueError(f"bsr_mxm: block {A.block} > {MAX_BLOCK}, which the "
                         f"kernel does not take")
    X = X.to(torch.float32).contiguous()
    M = None if mask is None else mask.to(torch.float32).contiguous()
    E = (A.emask.contiguous().view(torch.uint8)
         if mode >= 4 and A.emask is not None else None)
    y = torch.empty((n, F), dtype=torch.float32, device=X.device)
    rc = _fn()(A.blocks.contiguous().data_ptr(),
               None if E is None else E.data_ptr(),
               A.block_cols.data_ptr(), A.valid.data_ptr(),
               A.row_ptr.data_ptr(), X.data_ptr(),
               None if M is None else M.data_ptr(), y.data_ptr(),
               A.nbrows, A.block, n, m, F, mode, int(complement),
               torch.cuda.current_stream(X.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_mxm: kernel launch failed, cudaError {rc}")
    launches += 1
    return y

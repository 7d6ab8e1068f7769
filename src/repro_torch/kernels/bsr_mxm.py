"""Block-sparse semiring matmul: Y = A_bsr (x) X, with an optional fused
<M> / <!M> write mask.

Port of ``repro.kernels.bsr_mxm`` (the Pallas TPU kernel ``bsr_mxm``) as
two hand-written CUDA C++ kernels for ``sm_90a`` that compute the same
function; each source notes what bounds it and why it is shaped as it is.
Both compute all five semiring modes (dot, dot_indicator, dot_pair,
dot_first, and bcast for min_plus / max_plus, which reads the BSR's
``emask`` where there is one).

  tile   ``csrc/bsr_mxm.cu``: whole-tile products against 64-column
         frontier tiles, for full tiles.
  entry  ``csrc/bsr_mxm_entry.cu``: one gathered frontier row per stored
         entry, over the handle's :class:`~repro_torch.core.bsr.RowCSR`
         (``BSR.row_csr()``, built on the device once per handle), for
         sparse tiles.

``bsr_mxm(A, X, sr, mask=..., complement=...)`` picks one by the handle's
fill against ``entry_max_fill(b)`` (``core.grb.MXM_ENTRY_MAX_FILL``); a
dot product over a non-finite X takes the tile variant, which multiplies
the absent zeros the entry kernel skips (``picked`` says which ran, and
why). On CUDA tensors it launches that kernel, which never gives way to
the other or to a plain version; on CPU tensors it takes that variant's
plain version, ``core.ops.bsr_mxm_plain`` (tiles) or
``bsr_mxm_entry_plain`` (a CSR gather-reduce), then the same mask
epilogue. ``launches`` counts kernel launches, ``launches_entry`` and
``launches_tile`` those of each kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import grb
from repro_torch.core import semiring as S
from repro_torch.core.bsr import BSR, RowCSR
from repro_torch.core.ops import _segment_reduce, bsr_mxm_plain
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)
launches_entry = 0    # of which the entry kernel's
launches_tile = 0     # of which the tile kernel's
picked = None         # the last dispatch's variant: "entry", "tile" or
                      # "tile (non-finite)"

MAX_BLOCK = 128       # the tile kernel holds one tile's rows per block
# the entry kernel cuts a row into 32-column slices when its chain of
# memory waits would outlast the mean work of one warp the card holds at
# once (132 SMs x 32): entries x wide slices / RESIDENT_WARPS entries, and
# at least LONG_ROW (its source says why)
LONG_ROW = 256
RESIDENT_WARPS = 132 * 32

_MODES = {"dot": 0, "dot_indicator": 1, "dot_pair": 2, "dot_first": 3}
_BCAST = {"min_plus": 4, "max_plus": 5}

# entries x frontier columns of one chunk's gathered rows in the plain
# entry version (1M entries x 512 columns at Graph500 scale 16 is 2 GB)
_CHUNK_ENTRIES = 1 << 26

_bound = None
_bound_entry = None


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


def _fn_entry():
    global _bound_entry
    if _bound_entry is None:
        from repro_torch.kernels import build
        fn = build.load("bsr_mxm_entry").bsr_mxm_entry
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound_entry = fn
    return _bound_entry


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
                f"bsr_mxm: the kernels' bcast mode computes min_plus and "
                f"max_plus, not {sr.name!r}")
        return _BCAST[sr.name]
    if sr.mode not in _MODES:
        raise NotImplementedError(f"bsr_mxm: mode {sr.mode!r}")
    return _MODES[sr.mode]


def entry_max_fill(b: int) -> float:
    """The dispatch's crossover for tiles of side ``b``."""
    return grb.entry_max_fill(grb.MXM_ENTRY_MAX_FILL, b)


def pick(A: BSR, X: torch.Tensor, sr: S.Semiring) -> str:
    """The variant for ``A (x) X``: "tile" at or above the crossover fill;
    "tile (non-finite)" for a dot product whose X holds an inf or NaN (the
    tile variant multiplies the absent zeros, 0 * inf = NaN, as the JAX
    package does; the entry kernel never sees them); else "entry". Only
    dot reads X's values beside stored entries: the 0/1 modes test
    X != 0, and bcast adds nothing where A stores nothing."""
    if A.fill_ratio >= entry_max_fill(A.block):
        return "tile"
    if sr.mode == "dot" and not bool(torch.isfinite(X).all()):
        return "tile (non-finite)"
    return "entry"


def bsr_mxm_entry_plain(csr: RowCSR, X: torch.Tensor,
                        sr: S.Semiring) -> torch.Tensor:
    """Y = A (x) X over A's row CSR, before the mask: each entry gathers
    its frontier row and a segment reduction folds the terms into their
    rows (``index_add_`` for the dot modes, scatter min / max for bcast),
    over chunks of entries. Returns (n, F) float32."""
    n = csr.indptr.shape[0] - 1
    F = X.shape[1]
    X = X.to(torch.float32)
    y = torch.full((n, F), sr.identity, dtype=torch.float32,
                   device=X.device)
    rows = torch.repeat_interleave(
        torch.arange(n, device=X.device), csr.indptr.diff(),
        output_size=csr.entries)
    step = max(1, _CHUNK_ENTRIES // max(F, 1))
    for lo in range(0, csr.entries, step):
        a = csr.vals[lo:lo + step, None]
        xg = X[csr.cols[lo:lo + step].long()]
        if sr.mode == "dot":
            term = a * xg
        elif sr.mode in ("dot_indicator", "dot_pair"):
            term = ((a != 0) & (xg != 0)).to(torch.float32)
        elif sr.mode == "dot_first":
            term = a * (xg != 0).to(torch.float32)
        elif sr.mode == "bcast":
            term = sr.mul(a, xg)
        else:
            raise NotImplementedError(sr.mode)
        _segment_reduce(term, rows[lo:lo + step], n, sr.add, out=y)
    if sr.mode == "dot_indicator":
        y = (y > 0).to(torch.float32)
    return y


def _operands(X, mask):
    X = X.to(torch.float32).contiguous()
    M = None if mask is None else mask.to(torch.float32).contiguous()
    return X, M


def bsr_mxm_tile(A: BSR, X: torch.Tensor, sr: S.Semiring, *,
                 mask: Optional[torch.Tensor] = None,
                 complement: bool = False) -> torch.Tensor:
    """The tile kernel, ``csrc/bsr_mxm.cu``, on a CUDA handle's tiles."""
    global launches, launches_tile
    n, m = A.shape
    mode = _mode(sr)
    if A.block > MAX_BLOCK:
        raise ValueError(f"bsr_mxm: block {A.block} > {MAX_BLOCK}, which the "
                         f"tile kernel does not take")
    X, M = _operands(X, mask)
    F = X.shape[1]
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
    launches_tile += 1
    return y


def bsr_mxm_entry(csr: RowCSR, X: torch.Tensor, sr: S.Semiring, *,
                  mask: Optional[torch.Tensor] = None,
                  complement: bool = False) -> torch.Tensor:
    """The entry kernel, ``csrc/bsr_mxm_entry.cu``, on a handle's row CSR
    (``BSR.row_csr()``) on a CUDA device."""
    global launches, launches_entry
    mode = _mode(sr)
    n = csr.indptr.shape[0] - 1
    X, M = _operands(X, mask)
    F = X.shape[1]
    y = torch.empty((n, F), dtype=torch.float32, device=X.device)
    ptrs = [t.data_ptr() for t in (X, M, y) if t is not None]
    vec = 4 if F % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    long_row = max(LONG_ROW, csr.entries * -(-F // (32 * vec))
                   // RESIDENT_WARPS)
    rc = _fn_entry()(csr.indptr.data_ptr(), csr.cols.data_ptr(),
                     csr.vals.data_ptr(), csr.order.data_ptr(), X.data_ptr(),
                     None if M is None else M.data_ptr(), y.data_ptr(), n,
                     csr.rows_at_least(long_row), F, mode, int(complement),
                     vec,
                     torch.cuda.current_stream(X.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_mxm_entry: kernel launch failed, "
                          f"cudaError {rc}")
    launches += 1
    launches_entry += 1
    return y


def bsr_mxm(A: BSR, X: torch.Tensor, sr: S.Semiring, *,
            mask: Optional[torch.Tensor] = None,
            complement: bool = False) -> torch.Tensor:
    """Y[i, f] = add_j mul(A[i, j], X[j, f]), then <mask> / <!mask> with the
    semiring identity outside. A: BSR (n, m); X: (m, F); mask: (n, F) or
    None. Returns (n, F) float32."""
    global picked
    n, m = A.shape
    if X.dim() != 2 or X.shape[0] != m:
        raise ValueError(f"bsr_mxm: X must be (m={m}, F), got "
                         f"{tuple(X.shape)}")
    F = X.shape[1]
    if mask is not None and tuple(mask.shape) != (n, F):
        raise ValueError(f"bsr_mxm: mask must be ({n}, {F}), got "
                         f"{tuple(mask.shape)}")
    tensors = [X] + ([] if mask is None else [mask])
    cpu = A.device.type == "cpu" and all(t.device.type == "cpu"
                                         for t in tensors)
    if not cpu and not (A.device.type == "cuda"
                        and all(t.device == A.device for t in tensors)):
        raise ValueError(f"bsr_mxm: A on {A.device}, X on {X.device}"
                         + ("" if mask is None else f", mask on {mask.device}")
                         + "; all must lie on one CUDA device (or all on "
                           "the CPU)")
    picked = pick(A, X, sr)
    if cpu:
        y = (bsr_mxm_entry_plain(A.row_csr(), X, sr) if picked == "entry"
             else bsr_mxm_plain(A, X, sr))
        return mask_epilogue(y, mask, complement, sr.identity)
    if picked == "entry":
        return bsr_mxm_entry(A.row_csr(), X, sr, mask=mask,
                             complement=complement)
    return bsr_mxm_tile(A, X, sr, mask=mask, complement=complement)

"""Bit-tile or_and product: Yw = BitELL (&|) Xw.

Port of ``repro.kernels.bitadj_mxv`` (the Pallas TPU kernel
``bitadj_mxv_packed``). The kernel is hand-written CUDA C++ for
``sm_90a``, ``csrc/bitadj_mxv_packed.cu``; its source notes what bounds it
and why it is shaped as it is.

``bitadj_mxv_packed(A, Xw)`` launches the kernel when its tensors lie on a
CUDA device and takes the plain version, ``core.bitadj.mxm_words`` (over
``panels_mxm_words``), when they lie on the CPU. ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bitadj import TILE, BitELL
from repro_torch.core.bitadj import mxm_words  # the plain version
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)

# words per launch: the (32, wc) shared-memory accumulator stays at 32 KB
MAX_WORDS_PER_LAUNCH = 256

_bound = None


def _fn():
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        fn = build.load("bitadj_mxv_packed").bitadj_mxv_packed
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def bitadj_mxv_packed(A: BitELL, Xw: torch.Tensor) -> torch.Tensor:
    """Yw[i] = OR_{j in adj(i)} Xw[j] over int32 words (uint32 bit
    pattern), the adjacency read straight from the bit-tiles. Xw: (k, W)
    packed frontier. Returns (n, W) words."""
    global launches
    n, k = A.shape
    if Xw.dim() != 2:
        raise ValueError(f"bitadj_mxv_packed: Xw must be 2-D, got "
                         f"{tuple(Xw.shape)}")
    if Xw.dtype != torch.int32:
        raise TypeError(f"bitadj_mxv_packed: Xw must be int32 words, got "
                        f"{Xw.dtype}")
    if A.device.type == "cpu" and Xw.device.type == "cpu":
        return mxm_words(A, Xw)
    if not (A.device.type == "cuda" and Xw.device == A.device):
        raise ValueError(f"bitadj_mxv_packed: A on {A.device}, Xw on "
                         f"{Xw.device}; both must lie on one CUDA device "
                         f"(or both on the CPU)")
    if (A.tiles.dtype != torch.int32 or A.cols.dtype != torch.int32
            or A.tiles.shape[2] != TILE
            or tuple(A.cols.shape) != tuple(A.tiles.shape[:2])):
        raise TypeError("bitadj_mxv_packed: tiles (P, S, 32) and cols (P, S) "
                        "must be int32")
    tiles, cols = A.occupied_first()             # cached per matrix
    P, S, _ = tiles.shape
    Xw = Xw.contiguous()
    W = Xw.shape[1]
    C = A.n_ctiles
    xrows = min(Xw.shape[0], C * TILE)   # rows past these read as zero
    y = torch.empty((n, W), dtype=torch.int32, device=Xw.device)
    stream = torch.cuda.current_stream(Xw.device).cuda_stream
    for w0 in range(0, W, MAX_WORDS_PER_LAUNCH):
        wc = min(MAX_WORDS_PER_LAUNCH, W - w0)
        rc = _fn()(tiles.data_ptr(), cols.data_ptr(), Xw.data_ptr(),
                   y.data_ptr(), P, S, C, xrows, n, W, w0, wc, stream)
        if rc != 0:
            raise KernelError(f"bitadj_mxv_packed: kernel launch failed, "
                              f"cudaError {rc}")
        launches += 1
    return y

"""Packed or_and gather-OR over ELL rows: Yw = A_ell (|) Xw.

Port of ``repro.kernels.bitmap_mxv`` (the Pallas TPU kernel
``ell_mxv_packed``). The kernel is hand-written CUDA C++ for ``sm_90a``,
``csrc/ell_mxv_packed.cu``; its source notes what bounds it and why it is
shaped as it is.

``ell_mxv_packed(A, Xw)`` launches the kernel when its tensors lie on a
CUDA device and takes the plain version, ``core.ops.ell_mxm_packed``, when
they lie on the CPU. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ell import ELL
from repro_torch.kernels import KernelError
from repro_torch.core.ops import ell_mxm_packed  # the plain version

launches = 0          # kernel launches since import (plain calls excluded)

_bound = None


def _fn():
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        fn = build.load("ell_mxv_packed").ell_mxv_packed
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def ell_mxv_packed(A: ELL, Xw: torch.Tensor) -> torch.Tensor:
    """Yw[i] = OR_{j in adj(i)} Xw[j] over int32 words (uint32 bit
    pattern). A: ELL adjacency (only the structure is used); Xw: (k, W)
    packed frontier, k = A.shape[1]. Returns (n, W) words."""
    global launches
    n, k = A.shape
    if Xw.dim() != 2 or Xw.shape[0] != k:
        raise ValueError(f"ell_mxv_packed: Xw must be (k={k}, W), got "
                         f"{tuple(Xw.shape)}")
    if Xw.dtype != torch.int32:
        raise TypeError(f"ell_mxv_packed: Xw must be int32 words, got "
                        f"{Xw.dtype}")
    if A.device.type == "cpu" and Xw.device.type == "cpu":
        return ell_mxm_packed(A, Xw)
    if not (A.device.type == "cuda" and Xw.device == A.device):
        raise ValueError(f"ell_mxv_packed: A on {A.device}, Xw on "
                         f"{Xw.device}; both must lie on one CUDA device "
                         f"(or both on the CPU)")
    if A.indices.dtype != torch.int32:
        raise TypeError("ell_mxv_packed: ELL indices must be int32")
    idx = A.sentinel_indices()                   # cached per matrix
    Xw = Xw.contiguous()
    W = Xw.shape[1]
    y = torch.empty((n, W), dtype=torch.int32, device=Xw.device)
    rc = _fn()(idx.data_ptr(), Xw.data_ptr(), y.data_ptr(), n, A.max_deg, k,
               W, torch.cuda.current_stream(Xw.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"ell_mxv_packed: kernel launch failed, "
                          f"cudaError {rc}")
    launches += 1
    return y

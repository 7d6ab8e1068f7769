"""BSR x BSR SpGEMM numeric phase: run a symbolic plan's tasks, one
(b x b) semiring tile product each, into the output tiles.

Port of ``repro.kernels.bsr_spgemm`` (the Pallas TPU kernel
``spgemm_blocks`` -> ``_spgemm_pallas``). The kernel is hand-written CUDA
C++ for ``sm_90a``, ``csrc/bsr_spgemm.cu``; its source notes what bounds
it and why it is shaped as it is. Dot modes only (plus_times, or_and,
plus_pair, plus_first), as on the TPU.

``spgemm_blocks(Ablocks, Bblocks, plan, sr, ...)`` launches the kernel
when its tensors lie on a CUDA device and takes the plain version,
``spgemm_blocks_plain`` (the port of ``_spgemm_jnp``), when they lie on
the CPU. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core import semiring as S
from repro_torch.core.bsr import SPGEMM_MODES, SpGEMMPlan
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)

MAX_BLOCK = 128       # the kernel holds one output tile per thread block

_MODES = {"dot": 0, "dot_indicator": 1, "dot_pair": 2, "dot_first": 3}

# entries of one chunk's gathered task tiles in the plain version: the JAX
# reference gathers every task's tiles at once, 1.0M tasks x 64 KB x 2 =
# 132 GB for the Graph500 scale-14 hop matrix
_CHUNK_ENTRIES = 1 << 27

_bound = None


def _fn():
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        fn = build.load("bsr_spgemm").bsr_spgemm
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _ind(x: torch.Tensor) -> torch.Tensor:
    return (x != 0).to(torch.float32)


def spgemm_blocks_plain(Ab: torch.Tensor, Bb: torch.Tensor,
                        plan: SpGEMMPlan, sr: S.Semiring,
                        mask_blocks: Optional[torch.Tensor] = None,
                        complement: bool = False) -> torch.Tensor:
    """Gather each task's tiles, take the batched tile products and sum
    them into their output tiles, over chunks of tasks; then the
    dot_indicator clamp and the mask. Returns (nc, b, b) float32."""
    b = int(Ab.shape[1])
    dev = Ab.device
    y = torch.zeros((plan.nc, b, b), dtype=torch.float32, device=dev)
    sel = [torch.from_numpy(a.astype(np.int64)).to(dev)
           for a in (plan.a_sel, plan.b_sel, plan.c_sel)]
    valid = torch.from_numpy(plan.valid.astype(np.float32)).to(dev)
    step = max(1, _CHUNK_ENTRIES // (b * b))
    for lo in range(0, plan.ntasks, step):
        a = Ab[sel[0][lo:lo + step]].to(torch.float32)
        bt = Bb[sel[1][lo:lo + step]].to(torch.float32)
        if sr.mode == "dot":
            contrib = torch.bmm(a, bt)
        elif sr.mode in ("dot_indicator", "dot_pair"):
            contrib = torch.bmm(_ind(a), _ind(bt))
        elif sr.mode == "dot_first":
            contrib = torch.bmm(a, _ind(bt))
        else:
            raise NotImplementedError(sr.mode)
        contrib = contrib * valid[lo:lo + step, None, None]
        y.index_add_(0, sel[2][lo:lo + step], contrib)
    if sr.mode == "dot_indicator":
        y = (y > 0).to(torch.float32)
    if mask_blocks is not None:
        keep = (mask_blocks == 0) if complement else (mask_blocks != 0)
        y = torch.where(keep, y, torch.tensor(sr.identity,
                                              dtype=torch.float32,
                                              device=dev))
    return y


def run_pointer(plan: SpGEMMPlan) -> np.ndarray:
    """(nc+1,) int32: output tile j's tasks are ptr[j] .. ptr[j+1]. Built
    from the plan's ``first`` flags; grid padding lies past ptr[nc]."""
    starts = np.nonzero(plan.first)[0]
    if len(starts) != plan.nc:
        raise ValueError(f"spgemm plan: {len(starts)} task runs for "
                         f"{plan.nc} output tiles")
    return np.append(starts, int(plan.valid.sum())).astype(np.int32)


def spgemm_blocks(Ablocks: torch.Tensor, Bblocks: torch.Tensor,
                  plan: SpGEMMPlan, sr: S.Semiring, *,
                  mask_blocks: Optional[torch.Tensor] = None,
                  complement: bool = False) -> torch.Tensor:
    """Run a symbolic plan's numeric phase; returns (nc, b, b) output tiles.
    ``mask_blocks`` (nc, b, b) is aligned with the output tiles."""
    global launches
    if sr.mode not in SPGEMM_MODES:
        raise NotImplementedError(f"spgemm_blocks: mode {sr.mode!r}")
    b = int(Ablocks.shape[1])
    tensors = [Ablocks, Bblocks] + ([] if mask_blocks is None
                                    else [mask_blocks])
    if all(t.device.type == "cpu" for t in tensors):
        return spgemm_blocks_plain(Ablocks, Bblocks, plan, sr, mask_blocks,
                                   complement)
    dev = Ablocks.device
    if not (dev.type == "cuda" and all(t.device == dev for t in tensors)):
        raise ValueError("spgemm_blocks: tiles on "
                         f"{[str(t.device) for t in tensors]}; all must lie "
                         f"on one CUDA device (or all on the CPU)")
    if b > MAX_BLOCK or tuple(Bblocks.shape[1:]) != (b, b):
        raise ValueError(f"spgemm_blocks: tiles {tuple(Ablocks.shape[1:])} x "
                         f"{tuple(Bblocks.shape[1:])}; the kernel takes "
                         f"square tiles of one side <= {MAX_BLOCK}")
    if mask_blocks is not None and tuple(mask_blocks.shape) != (plan.nc, b, b):
        raise ValueError(f"spgemm_blocks: mask tiles must be "
                         f"({plan.nc}, {b}, {b})")
    c = torch.empty((plan.nc, b, b), dtype=torch.float32, device=dev)
    if plan.nc == 0:
        return c

    def dev_i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    a_sel, b_sel = dev_i32(plan.a_sel), dev_i32(plan.b_sel)
    valid, cptr = dev_i32(plan.valid), dev_i32(run_pointer(plan))
    A = Ablocks.to(torch.float32).contiguous()
    B = Bblocks.to(torch.float32).contiguous()
    M = (None if mask_blocks is None
         else mask_blocks.to(torch.float32).contiguous())
    rc = _fn()(A.data_ptr(), B.data_ptr(), None if M is None else M.data_ptr(),
               a_sel.data_ptr(), b_sel.data_ptr(), valid.data_ptr(),
               cptr.data_ptr(), c.data_ptr(), plan.nc, b, _MODES[sr.mode],
               int(complement), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_spgemm: kernel launch failed, cudaError {rc}")
    launches += 1
    return c

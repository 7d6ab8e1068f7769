"""Bit-tile or_and product: Yw = BitELL (&|) Xw.

Port of ``repro.kernels.bitadj_mxv`` (the Pallas TPU kernel
``bitadj_mxv_packed``). The kernel is hand-written CUDA C++ for
``sm_90a``, ``csrc/bitadj_mxv_packed.cu``; its source notes what bounds it
and why it is shaped as it is. It reads the occupied slots
(``BitELL.occupied_first``) split into items of at most K slots
(``BitELL.slot_plan``), one warp an item, so a hub panel is spread over
many warps.

``bitadj_mxv_packed(A, Xw)`` launches the kernel when its tensors lie on a
CUDA device and takes the plain version, ``core.bitadj.mxm_words`` (over
``panels_mxm_words``), when they lie on the CPU. ``launches`` counts
kernel launches. ``bitadj_mxv_items`` launches it on given slots and plan;
``bitadj_mxv_items_plain`` is the same item-wise evaluation in plain
torch, which the tests hold against the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bitadj import TILE, BitELL, SlotPlan
from repro_torch.core.bitadj import mxm_words, panels_mxm_words  # plain
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)

_bound = None


def _fn():
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        fn = build.load("bitadj_mxv_packed").bitadj_mxv_packed
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def bitadj_mxv_items(tiles: torch.Tensor, cols: torch.Tensor,
                     plan: SlotPlan, Xw: torch.Tensor, shape) -> torch.Tensor:
    """Launch the kernel over ``plan``'s items of the occupied-first
    ``tiles`` (P, S, 32) and ``cols`` (P, S) of an (n, k) BitELL: (n, W)
    words from the contiguous int32 frontier ``Xw`` (rows past
    ``ceil(k/32)*32`` are not read) on one CUDA device."""
    global launches
    n, k = shape
    P, S, _ = tiles.shape
    if not (Xw.is_cuda and Xw.dim() == 2 and Xw.dtype == torch.int32
            and Xw.is_contiguous() and tiles.is_contiguous()
            and cols.is_contiguous() and tiles.device == Xw.device
            and cols.device == Xw.device and plan.items.device == Xw.device):
        raise ValueError("bitadj_mxv_items: Xw must be contiguous (k, W) int32 "
                         "words on the CUDA device of the tiles, cols and "
                         "plan")
    W = Xw.shape[1]
    xrows = min(Xw.shape[0], -(-k // TILE) * TILE)   # rows past: zero
    y = torch.empty((n, W), dtype=torch.int32, device=Xw.device)
    vec = W % 4 == 0 and Xw.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    rc = _fn()(tiles.data_ptr(), cols.data_ptr(), plan.items.data_ptr(),
               plan.items.shape[0], plan.zero_rows.data_ptr(),
               plan.zero_rows.shape[0], Xw.data_ptr(), y.data_ptr(), S,
               xrows, n, W, int(vec),
               torch.cuda.current_stream(Xw.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"bitadj_mxv_packed: kernel launch failed, "
                          f"cudaError {rc}")
    launches += 1
    return y


def bitadj_mxv_packed(A: BitELL, Xw: torch.Tensor) -> torch.Tensor:
    """Yw[i] = OR_{j in adj(i)} Xw[j] over int32 words (uint32 bit
    pattern), the adjacency read straight from the bit-tiles. Xw: (k, W)
    packed frontier. Returns (n, W) words."""
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
    return bitadj_mxv_items(tiles, cols, A.slot_plan(), Xw.contiguous(),
                            A.shape)


def bitadj_mxv_items_plain(tiles: torch.Tensor, cols: torch.Tensor,
                           plan: SlotPlan, Xw: torch.Tensor, shape
                           ) -> torch.Tensor:
    """The kernel's item-wise evaluation in plain torch: the output starts
    all ones (so a row that nothing writes shows), ``plan.zero_rows`` are
    zeroed, each item takes the product of its slots
    (``panels_mxm_words``), and a panel's only item stores its rows while
    the items of a split panel OR theirs in."""
    n, k = shape
    P, S, _ = tiles.shape
    W = Xw.shape[1]
    dev = Xw.device
    panel, s0, s1, split = plan.items.long().unbind(1)
    width = int((s1 - s0).max()) if panel.numel() else 0
    slot = s0[:, None] + torch.arange(width, device=dev)
    inside = slot < s1[:, None]
    slot = torch.where(inside, slot, torch.zeros_like(slot))
    part_tiles = torch.where(inside[..., None], tiles[panel[:, None], slot],
                             torch.zeros((), dtype=tiles.dtype, device=dev))
    part_cols = torch.where(inside, cols[panel[:, None], slot],
                            torch.full((), -(-k // TILE), dtype=cols.dtype,
                                       device=dev))
    part = panels_mxm_words(part_tiles, part_cols, Xw, k).reshape(
        -1, TILE, W)
    y = torch.full((P * TILE, W), -1, dtype=torch.int32, device=dev)
    y[plan.zero_rows.long()] = 0
    y3 = y.view(P, TILE, W)
    whole = split == 0
    y3[panel[whole]] = part[whole]
    cut_panels, cut_part = panel[~whole], part[~whole]   # panels ascend
    rank = torch.arange(cut_panels.shape[0], device=dev) - torch.searchsorted(
        cut_panels, cut_panels)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        y3[cut_panels[sel]] |= cut_part[sel]
    return y[:n]

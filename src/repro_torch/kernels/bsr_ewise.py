"""BSR element-wise numeric phase: the gathered-tile map.

Port of ``repro.kernels.bsr_ewise`` (the Pallas TPU kernel ``map_tiles`` ->
``_ewise_pallas``). The host plans of ``core.bsr`` (union, intersection or
mask alignment of the valid-tile key lists) give, per output tile, a
selector into each operand's tile payloads (-1: no stored tile on that
side, read as the all-zero tile); this module runs the numeric phase on
the device. The kernel is hand-written CUDA C++ for ``sm_90a``,
``csrc/bsr_ewise.cu``; its source notes what bounds it and how it is
shaped.

Modes (absent == 0; zeros stay zeros, so tiles an op empties are pruned
later by ``BSR.from_blocks_device``):
  union      where(both stored, op(a, b), a + b)   GrB_eWiseAdd
  intersect  where(both stored, op(a, b), 0)       GrB_eWiseMult
  apply      where(a stored, op(a), 0)             GrB_apply
  select     where(a stored and op(a), a, 0)       GxB_select
  mask       where(b stored, a, 0)                 <M> restrict
  mask_c     where(b absent, a, 0)                 <!M> restrict

The JAX kernel takes any Python callable as ``op``; a CUDA kernel cannot,
so ``map_tiles`` takes the named ops of ``core.semiring`` (``ewise``, or a
``Monoid``) and raises TypeError for a bare callable, on every device.

``map_tiles`` launches the kernel when its tensors lie on a CUDA device
and takes the plain version, ``map_tiles_plain`` (the port of
``_ewise_jnp`` and ``_tile_fn``), when they lie on the CPU. ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core import semiring as S
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)

EWISE_MODES = ("union", "intersect", "apply", "select", "mask", "mask_c")

# modes whose second operand is never read
UNARY_MODES = ("apply", "select")

_MODE_CODES = {m: i for i, m in enumerate(EWISE_MODES)}

# the op kinds each mode takes (mask modes take no op)
_OP_KINDS = {"union": ("binary",), "intersect": ("binary",),
             "apply": ("unary", "predicate"), "select": ("predicate",)}

# entries of one chunk's gathered operand tiles in the plain version: the
# JAX reference gathers every tile pair at once, 38,978 x 64 KB x 2 = 5.1 GB
# for the Graph500 scale-15 support matrix
_CHUNK_ENTRIES = 1 << 26

_bound = None


def _fn():
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        fn = build.load("bsr_ewise").bsr_ewise
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _tile_fn(mode: str, op):
    """The per-tile-pair closure on (t, b, b) float32 tiles, absent == 0."""
    if mode == "union":
        def fn(a, b):
            both = (a != 0) & (b != 0)
            # where only one side stores, the other holds 0, so a + b is
            # exactly the stored value there (0 where neither stores)
            return torch.where(both, op(a, b).to(torch.float32), a + b)
    elif mode == "intersect":
        def fn(a, b):
            both = (a != 0) & (b != 0)
            return torch.where(both, op(a, b).to(torch.float32), 0.0)
    elif mode == "apply":
        def fn(a, b):
            return torch.where(a != 0, op(a).to(torch.float32), 0.0)
    elif mode == "select":
        def fn(a, b):
            return torch.where((a != 0) & op(a), a, 0.0)
    elif mode == "mask":
        def fn(a, b):
            return torch.where(b != 0, a, 0.0)
    elif mode == "mask_c":
        def fn(a, b):
            return torch.where(b == 0, a, 0.0)
    else:
        raise NotImplementedError(f"bsr_ewise mode {mode!r}")
    return fn


def _gather(blocks: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Tiles ``blocks[sel]`` as float32, the zero tile where sel is -1."""
    b = blocks.shape[1]
    if blocks.shape[0] == 0:
        return torch.zeros((len(sel), b, b), dtype=torch.float32,
                           device=sel.device)
    t = blocks[sel.clamp(min=0)].to(torch.float32)
    return torch.where((sel >= 0)[:, None, None], t, 0.0)


def map_tiles_plain(Ablocks: torch.Tensor, sel_a, Bblocks: Optional[
        torch.Tensor], sel_b, mode: str, op=None) -> torch.Tensor:
    """Gather each output tile's operand tiles and apply the mode's
    closure, over chunks of tiles. ``op`` may be any torch callable here.
    Returns (T, b, b) float32 on the operands' device."""
    b = int(Ablocks.shape[1])
    dev = Ablocks.device
    sa = torch.from_numpy(np.asarray(sel_a, np.int64)).to(dev)
    unary = mode in UNARY_MODES or sel_b is None
    sb = None if unary else torch.from_numpy(
        np.asarray(sel_b, np.int64)).to(dev)
    fn = _tile_fn(mode, op)
    out = torch.empty((len(sa), b, b), dtype=torch.float32, device=dev)
    step = max(1, _CHUNK_ENTRIES // (b * b))
    for lo in range(0, len(sa), step):
        a = _gather(Ablocks, sa[lo:lo + step])
        bt = a if unary else _gather(Bblocks, sb[lo:lo + step])
        out[lo:lo + step] = fn(a, bt)
    return out


def _selectors(sel, nblocks: int, side: str) -> np.ndarray:
    sel = np.asarray(sel, dtype=np.int32)
    if len(sel) and (sel.max() >= nblocks or sel.min() < -1):
        raise ValueError(f"bsr_ewise: {side} selectors must lie in "
                         f"[-1, {nblocks}); got [{sel.min()}, {sel.max()}]")
    return sel


def map_tiles(Ablocks: torch.Tensor, sel_a, Bblocks: Optional[torch.Tensor],
              sel_b, mode: str, op=None) -> torch.Tensor:
    """Numeric phase of a BSR element-wise op: (T, b, b) output payloads,
    aligned with the caller's output tile list.

    ``sel_a`` / ``sel_b`` are host int arrays of length T indexing the
    operand payloads; -1 selects the all-zero tile. For the unary modes
    pass ``Bblocks=None`` / ``sel_b=None``. ``op`` is a named op (or a
    Monoid) of the kind the mode takes; the mask modes take none."""
    global launches
    if mode not in EWISE_MODES:
        raise ValueError(f"bsr_ewise mode {mode!r} (one of {EWISE_MODES})")
    named = (S.named_op(op, _OP_KINDS[mode], f"bsr_ewise {mode}")
             if mode in _OP_KINDS else None)
    unary = mode in UNARY_MODES
    if not unary and (Bblocks is None or sel_b is None):
        raise ValueError(f"bsr_ewise {mode}: needs B tiles and selectors")
    b = int(Ablocks.shape[1])
    sel_a = _selectors(sel_a, Ablocks.shape[0], "A")
    if not unary:
        sel_b = _selectors(sel_b, Bblocks.shape[0], "B")
        if len(sel_b) != len(sel_a) or tuple(Bblocks.shape[1:]) != (b, b):
            raise ValueError(f"bsr_ewise {mode}: {len(sel_a)} / "
                             f"{len(sel_b)} selectors, tiles "
                             f"{tuple(Ablocks.shape[1:])} / "
                             f"{tuple(Bblocks.shape[1:])}")
    tensors = [Ablocks] + ([] if unary else [Bblocks])
    if all(t.device.type == "cpu" for t in tensors):
        return map_tiles_plain(Ablocks, sel_a, Bblocks, sel_b, mode, named)
    dev = Ablocks.device
    if not (dev.type == "cuda" and all(t.device == dev for t in tensors)):
        raise ValueError("bsr_ewise: tiles on "
                         f"{[str(t.device) for t in tensors]}; all must lie "
                         f"on one CUDA device (or all on the CPU)")
    nt = len(sel_a)
    out = torch.empty((nt, b, b), dtype=torch.float32, device=dev)
    if nt == 0:
        return out

    def dev_i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    A = Ablocks.to(torch.float32).contiguous()
    B = None if unary else Bblocks.to(torch.float32).contiguous()
    sa = dev_i32(sel_a)
    sb = None if unary else dev_i32(sel_b)
    ptrs = [t.data_ptr() for t in (A, B, out) if t is not None]
    vec = 4 if (b * b) % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    rc = _fn()(A.data_ptr(), None if B is None else B.data_ptr(),
               sa.data_ptr(), None if sb is None else sb.data_ptr(),
               out.data_ptr(), nt, b, _MODE_CODES[mode],
               0 if named is None else named.code,
               0.0 if named is None else named.scalar, vec,
               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_ewise: kernel launch failed, cudaError {rc}")
    launches += 1
    return out

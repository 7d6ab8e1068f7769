"""BSR x BSR SpGEMM numeric phase: run a symbolic plan's tasks, one
(b x b) semiring tile product each, into the output tiles.

Port of ``repro.kernels.bsr_spgemm`` (the Pallas TPU kernel
``spgemm_blocks`` -> ``_spgemm_pallas``) as two hand-written CUDA C++
kernels for ``sm_90a`` that compute the same function from the same plan
and run pointer; each source notes what bounds it and why it is shaped as
it is. Dot modes only (plus_times, or_and, plus_pair, plus_first), as on
the TPU.

  tile   ``csrc/bsr_spgemm.cu``: whole b^3 tile products per task, for
         full tiles.
  entry  ``csrc/bsr_spgemm_entry.cu``: one multiply-add per pair of stored
         entries, on each operand's :class:`EntryForm` (a per-tile CSR
         built on the device by :func:`entry_form`), for sparse tiles.

``spgemm_blocks(Ablocks, Bblocks, plan, sr, ...)`` launches one of the two
when its tensors lie on a CUDA device, the entry kernel when the operands'
fill is under ``entry_max_fill(b)`` and the tile kernel otherwise; neither
ever gives way to the other or to the plain version. On the CPU it takes
the plain version, ``spgemm_blocks_plain`` (the port of ``_spgemm_jnp``).
``launches`` counts kernel launches, ``launches_entry`` and
``launches_tile`` those of each kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import semiring as S
from repro_torch.core.bsr import SPGEMM_MODES, SpGEMMPlan
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)
launches_entry = 0    # of which the entry kernel's
launches_tile = 0     # of which the tile kernel's

MAX_BLOCK = 128       # both kernels hold one output tile per thread block

# The dispatch's crossover by tile side: operands of side b whose fill
# (stored entries over the capacity of the tiles that hold any) is under
# ENTRY_MAX_FILL[s], s the smallest side listed >= b, take the entry
# kernel. From the fill sweeps of ``chip_smoke.py`` on an NVIDIA H100 80GB
# HBM3 (700 W; PERF.md): uniform tiles cross between 50% and 100% fill at
# b = 16, 15-25% at 32, 10-15% at 64 and 7-10% at 128, and the uneven
# 128-tiles of a planted-partition graph between 8.4% and 14%. Graph500
# R-MAT 128-tiles are 0.13-0.14% full.
ENTRY_MAX_FILL = {16: 0.7, 32: 0.19, 64: 0.12, 128: 0.09}


def entry_max_fill(b: int) -> float:
    """The dispatch's crossover for tiles of side ``b`` (b <= 128)."""
    return ENTRY_MAX_FILL[min(s for s in ENTRY_MAX_FILL if s >= b)]


_MODES = {"dot": 0, "dot_indicator": 1, "dot_pair": 2, "dot_first": 3}

# entries of one chunk's gathered task tiles in the plain version: the JAX
# reference gathers every task's tiles at once, 1.0M tasks x 64 KB x 2 =
# 132 GB for the Graph500 scale-14 hop matrix
_CHUNK_ENTRIES = 1 << 27
# tile elements per chunk of the entry-form build (a 64 MB bool scan and at
# most 512 MB of int64 positions at a time)
_FORM_ENTRIES = 1 << 26
BANDS = 32            # row bands per tile in EntryForm.bands

_bound = None
_bound_entry = None


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


def _fn_entry():
    global _bound_entry
    if _bound_entry is None:
        from repro_torch.kernels import build
        fn = build.load("bsr_spgemm_entry").bsr_spgemm_entry
        fn.argtypes = [ctypes.c_void_p] * 16 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound_entry = fn
    return _bound_entry


# -- the entry form -----------------------------------------------------------
@dataclasses.dataclass
class EntryForm:
    """The nonzeros of a stack of (b x b) tiles as one CSR per tile. Tile
    t's row i holds entries ``base[t] + row_ptr[t, i]`` up to
    ``base[t] + row_ptr[t, i + 1]``, sorted by column. Zeros are dropped:
    they add nothing in any dot mode (for finite inputs)."""
    block: int
    base: torch.Tensor     # (nnzb + 1,) int64 first entry of each tile
    row_ptr: torch.Tensor  # (nnzb, b + 1) int32 offsets inside the tile
    rows: torch.Tensor     # (E,) uint8 row in the tile
    cols: torch.Tensor     # (E,) uint8 column in the tile
    vals: torch.Tensor     # (E,) float32
    bands: torch.Tensor    # (nnzb,) int32 bit q: band q of rows holds one
    entries: int           # E


def entry_counts(blocks: torch.Tensor) -> torch.Tensor:
    """(nnzb, b) int32: the nonzeros of each tile row, chunked."""
    nnzb, b = int(blocks.shape[0]), int(blocks.shape[1])
    step = max(1, _FORM_ENTRIES // (b * b))
    if nnzb == 0:
        return torch.zeros((0, b), dtype=torch.int32, device=blocks.device)
    return torch.cat([(blocks[lo:lo + step] != 0).sum(dim=2,
                                                      dtype=torch.int32)
                      for lo in range(0, nnzb, step)])


def _occupancy(counts: torch.Tensor):
    """(entries, tiles holding any) of one operand's row counts."""
    per_tile = counts.sum(dim=1, dtype=torch.int64)
    return int(per_tile.sum()), int((per_tile > 0).sum())


def operand_fill(*counts: torch.Tensor) -> float:
    """The fill the dispatch reads: stored entries over the capacity of
    the tiles that hold any, over the distinct operands' row counts (for
    one BSR of distinct nonzero entries, ``BSR.fill_ratio``)."""
    b = int(counts[0].shape[1])
    occ = [_occupancy(c) for c in counts]
    return (sum(e for e, _ in occ)
            / max(sum(t for _, t in occ) * b * b, 1))


def entry_form(blocks: torch.Tensor,
               counts: Optional[torch.Tensor] = None) -> EntryForm:
    """The per-tile CSR of ``blocks`` (nnzb, b, b), on their device: plain
    torch glue, a chunked ``nonzero`` in row-major order, which groups the
    entries by tile and row and sorts each row by column."""
    nnzb, b = int(blocks.shape[0]), int(blocks.shape[1])
    if b > 256:
        raise ValueError(f"entry_form: tile side {b} > 256 does not fit "
                         f"uint8 coordinates")
    dev = blocks.device
    if counts is None:
        counts = entry_counts(blocks)
    row_ptr = torch.zeros((nnzb, b + 1), dtype=torch.int32, device=dev)
    row_ptr[:, 1:] = torch.cumsum(counts, dim=1, dtype=torch.int32)
    per_tile = row_ptr[:, -1].to(torch.int64)
    base = torch.zeros(nnzb + 1, dtype=torch.int64, device=dev)
    base[1:] = torch.cumsum(per_tile, dim=0)
    base_h = base.cpu().numpy()
    E = int(base_h[-1])
    rows = torch.empty(E, dtype=torch.uint8, device=dev)
    cols = torch.empty(E, dtype=torch.uint8, device=dev)
    vals = torch.empty(E, dtype=torch.float32, device=dev)
    flat = blocks.reshape(nnzb, b * b)
    step = max(1, _FORM_ENTRIES // (b * b))
    for lo in range(0, nnzb, step):
        hi = min(lo + step, nnzb)
        s, e = int(base_h[lo]), int(base_h[hi])
        if s == e:
            continue
        chunk = flat[lo:hi]
        t, p = torch.nonzero(chunk, as_tuple=True)
        rows[s:e] = torch.div(p, b, rounding_mode="floor").to(torch.uint8)
        cols[s:e] = (p % b).to(torch.uint8)
        vals[s:e] = chunk[t, p].to(torch.float32)
    band_of = torch.arange(b, device=dev) * BANDS // b
    per_band = torch.zeros((nnzb, BANDS), dtype=torch.int32, device=dev)
    per_band.index_add_(1, band_of, counts)
    word = ((per_band > 0).to(torch.int64)
            << torch.arange(BANDS, device=dev)).sum(dim=1)
    bands = torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)
    return EntryForm(block=b, base=base, row_ptr=row_ptr, rows=rows,
                     cols=cols, vals=vals, bands=bands, entries=E)


# -- the plain version ------------------------------------------------------
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
    starts = np.flatnonzero(plan.first.astype(bool))
    if len(starts) != plan.nc:
        raise ValueError(f"spgemm plan: {len(starts)} task runs for "
                         f"{plan.nc} output tiles")
    return np.append(starts, np.count_nonzero(plan.valid)).astype(np.int32)


# -- the two kernels ----------------------------------------------------------
@dataclasses.dataclass
class DevicePlan:
    """A symbolic plan as the kernels read it, int32 on one device: the
    task selections, the valid flags and the run pointer."""
    nc: int
    a_sel: torch.Tensor    # (T,)
    b_sel: torch.Tensor    # (T,)
    valid: torch.Tensor    # (T,)
    cptr: torch.Tensor     # (nc + 1,) see run_pointer


def device_plan(plan: SpGEMMPlan, device) -> DevicePlan:
    """Ship a host plan to ``device``, each array straight from the plan's
    memory (no host copy first)."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return DevicePlan(plan.nc, up(plan.a_sel), up(plan.b_sel),
                      up(plan.valid), up(run_pointer(plan)))


def _check(b, sr, dplan, dev, tensors, mask_blocks, what):
    if sr.mode not in SPGEMM_MODES:
        raise NotImplementedError(f"{what}: mode {sr.mode!r}")
    tensors = tensors + [dplan.cptr]
    if not (dev.type == "cuda" and all(t.device == dev for t in tensors)):
        raise ValueError(f"{what}: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must lie "
                         f"on one CUDA device")
    if b > MAX_BLOCK:
        raise ValueError(f"{what}: tile side {b} > {MAX_BLOCK}")
    if mask_blocks is not None and \
            tuple(mask_blocks.shape) != (dplan.nc, b, b):
        raise ValueError(f"{what}: mask tiles must be ({dplan.nc}, {b}, {b})")


def _mask_arg(mask_blocks):
    return (None if mask_blocks is None
            else mask_blocks.to(torch.float32).contiguous())


def spgemm_tile(Ablocks: torch.Tensor, Bblocks: torch.Tensor,
                dplan: DevicePlan, sr: S.Semiring, *,
                mask_blocks: Optional[torch.Tensor] = None,
                complement: bool = False) -> torch.Tensor:
    """The tile kernel, ``csrc/bsr_spgemm.cu``, on CUDA tiles."""
    global launches, launches_tile
    b = int(Ablocks.shape[1])
    dev = Ablocks.device
    tensors = [Ablocks, Bblocks] + ([] if mask_blocks is None
                                    else [mask_blocks])
    _check(b, sr, dplan, dev, tensors, mask_blocks, "spgemm_tile")
    if tuple(Bblocks.shape[1:]) != (b, b):
        raise ValueError(f"spgemm_tile: tiles {tuple(Ablocks.shape[1:])} x "
                         f"{tuple(Bblocks.shape[1:])}; the kernel takes "
                         f"square tiles of one side")
    c = torch.empty((dplan.nc, b, b), dtype=torch.float32, device=dev)
    if dplan.nc == 0:
        return c
    M = _mask_arg(mask_blocks)
    A = Ablocks.to(torch.float32).contiguous()
    B = Bblocks.to(torch.float32).contiguous()
    rc = _fn()(A.data_ptr(), B.data_ptr(), None if M is None else M.data_ptr(),
               dplan.a_sel.data_ptr(), dplan.b_sel.data_ptr(),
               dplan.valid.data_ptr(), dplan.cptr.data_ptr(), c.data_ptr(),
               dplan.nc, b, _MODES[sr.mode], int(complement),
               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_spgemm: kernel launch failed, cudaError {rc}")
    launches += 1
    launches_tile += 1
    return c


def spgemm_entry(EA: EntryForm, EB: EntryForm, dplan: DevicePlan,
                 sr: S.Semiring, *,
                 mask_blocks: Optional[torch.Tensor] = None,
                 complement: bool = False) -> torch.Tensor:
    """The entry kernel, ``csrc/bsr_spgemm_entry.cu``, on the operands'
    entry forms (``EB`` may be ``EA``) on a CUDA device."""
    global launches, launches_entry
    b = EA.block
    dev = EA.vals.device
    tensors = [EA.vals, EB.vals] + ([] if mask_blocks is None
                                    else [mask_blocks])
    _check(b, sr, dplan, dev, tensors, mask_blocks, "spgemm_entry")
    if EB.block != b:
        raise ValueError(f"spgemm_entry: tile sides {b} and {EB.block}")
    c = torch.empty((dplan.nc, b, b), dtype=torch.float32, device=dev)
    if dplan.nc == 0:
        return c
    M = _mask_arg(mask_blocks)
    rc = _fn_entry()(
        EA.base.data_ptr(), EA.row_ptr.data_ptr(), EA.rows.data_ptr(),
        EA.cols.data_ptr(), EA.vals.data_ptr(), EA.bands.data_ptr(),
        EB.base.data_ptr(), EB.row_ptr.data_ptr(), EB.cols.data_ptr(),
        EB.vals.data_ptr(), None if M is None else M.data_ptr(),
        dplan.a_sel.data_ptr(), dplan.b_sel.data_ptr(),
        dplan.valid.data_ptr(), dplan.cptr.data_ptr(), c.data_ptr(),
        dplan.nc, b, _MODES[sr.mode], int(complement),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_spgemm_entry: kernel launch failed, "
                          f"cudaError {rc}")
    launches += 1
    launches_entry += 1
    return c


def spgemm_blocks(Ablocks: torch.Tensor, Bblocks: torch.Tensor,
                  plan: SpGEMMPlan, sr: S.Semiring, *,
                  mask_blocks: Optional[torch.Tensor] = None,
                  complement: bool = False) -> torch.Tensor:
    """Run a symbolic plan's numeric phase; returns (nc, b, b) output tiles.
    ``mask_blocks`` (nc, b, b) is aligned with the output tiles. On CUDA
    tiles the operands' fill picks the kernel (``entry_max_fill``); when
    both operands are one tensor (A x A) its entry form is built once."""
    if sr.mode not in SPGEMM_MODES:
        raise NotImplementedError(f"spgemm_blocks: mode {sr.mode!r}")
    b = int(Ablocks.shape[1])
    tensors = [Ablocks, Bblocks] + ([] if mask_blocks is None
                                    else [mask_blocks])
    if all(t.device.type == "cpu" for t in tensors):
        return spgemm_blocks_plain(Ablocks, Bblocks, plan, sr, mask_blocks,
                                   complement)
    dev = Ablocks.device
    if dev.type != "cuda":
        raise ValueError(f"spgemm_blocks: tiles on {dev}; all must lie on "
                         f"one CUDA device (or all on the CPU)")
    if tuple(Bblocks.shape[1:]) != (b, b):
        raise ValueError(f"spgemm_blocks: tiles {tuple(Ablocks.shape[1:])} "
                         f"x {tuple(Bblocks.shape[1:])}; the kernels take "
                         f"square tiles of one side")
    dplan = device_plan(plan, dev)
    _check(b, sr, dplan, dev, tensors, mask_blocks, "spgemm_blocks")
    same = Bblocks is Ablocks
    ca = entry_counts(Ablocks)
    cb = ca if same else entry_counts(Bblocks)
    if operand_fill(*([ca] if same else [ca, cb])) >= entry_max_fill(b):
        return spgemm_tile(Ablocks, Bblocks, dplan, sr,
                           mask_blocks=mask_blocks, complement=complement)
    EA = entry_form(Ablocks, ca)
    EB = EA if same else entry_form(Bblocks, cb)
    return spgemm_entry(EA, EB, dplan, sr, mask_blocks=mask_blocks,
                        complement=complement)

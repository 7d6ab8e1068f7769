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
         built on the device by :func:`entry_form`, cached by the BSR
         handle, ``core.bsr``), for sparse tiles.

Both read the symbolic plan (``core.bsr.spgemm_symbolic``) as it lies on
the operands' device: its task selections, valid flags and run pointer.
``spgemm_blocks(A, B, plan, sr, ...)`` (tiles or BSR handles) launches one
of the two when its tensors lie on a CUDA device, the entry kernel when
the operands' fill is under ``entry_max_fill(b)`` and their values are
finite where the product reads them, the tile kernel otherwise; neither
ever gives way to the other or to the plain version. On the CPU it takes
the plain version, ``spgemm_blocks_plain`` (the port of ``_spgemm_jnp``).
``launches`` counts kernel launches, ``launches_entry`` and
``launches_tile`` those of each kernel, ``picked`` the last choice.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.core import semiring as S
# the entry forms live with the handle that caches them; re-exported here
from repro_torch.core.bsr import (BANDS, BSR, SPGEMM_MODES,  # noqa: F401
                                  EntryForm, SpGEMMPlan, entry_counts,
                                  entry_form, operand_fill, stored_fill)
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)
launches_entry = 0    # of which the entry kernel's
launches_tile = 0     # of which the tile kernel's
picked = None         # the last dispatch's kernel: "entry", "tile" or
                      # "tile (non-finite)"

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
    sel = [t.to(dev, torch.int64)
           for t in (plan.a_sel, plan.b_sel, plan.c_sel())]
    valid = plan.valid.to(dev, torch.float32)
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


# -- the two kernels ----------------------------------------------------------
def _check(b, sr, plan, dev, tensors, mask_blocks, what):
    if sr.mode not in SPGEMM_MODES:
        raise NotImplementedError(f"{what}: mode {sr.mode!r}")
    sched = [plan.a_sel, plan.b_sel, plan.valid, plan.cptr]
    tensors = tensors + sched
    if not (dev.type == "cuda" and all(t.device == dev for t in tensors)):
        raise ValueError(f"{what}: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must lie "
                         f"on one CUDA device")
    if not all(t.dtype == torch.int32 and t.is_contiguous() for t in sched):
        raise ValueError(f"{what}: the plan's tensors must be contiguous "
                         f"int32")
    if b > MAX_BLOCK:
        raise ValueError(f"{what}: tile side {b} > {MAX_BLOCK}")
    if mask_blocks is not None and \
            tuple(mask_blocks.shape) != (plan.nc, b, b):
        raise ValueError(f"{what}: mask tiles must be ({plan.nc}, {b}, {b})")


def _mask_arg(mask_blocks):
    return (None if mask_blocks is None
            else mask_blocks.to(torch.float32).contiguous())


def spgemm_tile(Ablocks: torch.Tensor, Bblocks: torch.Tensor,
                plan: SpGEMMPlan, sr: S.Semiring, *,
                mask_blocks: Optional[torch.Tensor] = None,
                complement: bool = False) -> torch.Tensor:
    """The tile kernel, ``csrc/bsr_spgemm.cu``, on CUDA tiles."""
    global launches, launches_tile
    b = int(Ablocks.shape[1])
    dev = Ablocks.device
    tensors = [Ablocks, Bblocks] + ([] if mask_blocks is None
                                    else [mask_blocks])
    _check(b, sr, plan, dev, tensors, mask_blocks, "spgemm_tile")
    if tuple(Bblocks.shape[1:]) != (b, b):
        raise ValueError(f"spgemm_tile: tiles {tuple(Ablocks.shape[1:])} x "
                         f"{tuple(Bblocks.shape[1:])}; the kernel takes "
                         f"square tiles of one side")
    c = torch.empty((plan.nc, b, b), dtype=torch.float32, device=dev)
    if plan.nc == 0:
        return c
    M = _mask_arg(mask_blocks)
    A = Ablocks.to(torch.float32).contiguous()
    B = Bblocks.to(torch.float32).contiguous()
    rc = _fn()(A.data_ptr(), B.data_ptr(), None if M is None else M.data_ptr(),
               plan.a_sel.data_ptr(), plan.b_sel.data_ptr(),
               plan.valid.data_ptr(), plan.cptr.data_ptr(), c.data_ptr(),
               plan.nc, b, _MODES[sr.mode], int(complement),
               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_spgemm: kernel launch failed, cudaError {rc}")
    launches += 1
    launches_tile += 1
    return c


def spgemm_entry(EA: EntryForm, EB: EntryForm, plan: SpGEMMPlan,
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
    _check(b, sr, plan, dev, tensors, mask_blocks, "spgemm_entry")
    if EB.block != b:
        raise ValueError(f"spgemm_entry: tile sides {b} and {EB.block}")
    c = torch.empty((plan.nc, b, b), dtype=torch.float32, device=dev)
    if plan.nc == 0:
        return c
    M = _mask_arg(mask_blocks)
    rc = _fn_entry()(
        EA.base.data_ptr(), EA.row_ptr.data_ptr(), EA.rows.data_ptr(),
        EA.cols.data_ptr(), EA.vals.data_ptr(), EA.bands.data_ptr(),
        EB.base.data_ptr(), EB.row_ptr.data_ptr(), EB.cols.data_ptr(),
        EB.vals.data_ptr(), None if M is None else M.data_ptr(),
        plan.a_sel.data_ptr(), plan.b_sel.data_ptr(),
        plan.valid.data_ptr(), plan.cptr.data_ptr(), c.data_ptr(),
        plan.nc, b, _MODES[sr.mode], int(complement),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_spgemm_entry: kernel launch failed, "
                          f"cudaError {rc}")
    launches += 1
    launches_entry += 1
    return c


# the modes whose products read each operand's values (and not only
# whether an entry is there): a non-finite value there meets the zeros the
# entry kernel skips, so those products take the tile kernel
_VALUES_READ = {"dot": (True, True), "dot_first": (True, False)}


def _finite(form: EntryForm) -> bool:
    return bool(torch.isfinite(form.vals).all())


def spgemm_blocks(A: Union[torch.Tensor, BSR], B: Union[torch.Tensor, BSR],
                  plan: SpGEMMPlan, sr: S.Semiring, *,
                  mask_blocks: Optional[torch.Tensor] = None,
                  complement: bool = False) -> torch.Tensor:
    """Run a symbolic plan's numeric phase; returns (nc, b, b) output tiles.
    ``A`` / ``B`` are tile stacks (nnzb, b, b) or BSR handles, whose cached
    entry forms the entry kernel reads (their tiles are read only by the
    tile kernel and the plain version). ``mask_blocks`` (nc, b, b) is
    aligned with the output tiles. On CUDA the operands' fill picks the
    kernel (``entry_max_fill``), and a product whose values meet a
    non-finite stored value (dot: either operand, dot_first: A) takes the
    tile kernel, which multiplies the absent zeros the entry kernel skips
    (``picked`` says which ran, and why). A x A reads one form."""
    global picked
    if sr.mode not in SPGEMM_MODES:
        raise NotImplementedError(f"spgemm_blocks: mode {sr.mode!r}")
    same = B is A
    handles = isinstance(A, BSR)
    if handles != isinstance(B, BSR):
        raise TypeError("spgemm_blocks: A and B must both be tiles or both "
                        "BSR handles")
    dev = A.device
    tensors = [A if not handles else A.block_rows,
               B if not handles else B.block_rows] + (
        [] if mask_blocks is None else [mask_blocks])
    b = A.block if handles else int(A.shape[1])
    if all(t.device.type == "cpu" for t in tensors):
        tiles = (A.blocks, B.blocks) if handles else (A, B)
        return spgemm_blocks_plain(*tiles, plan, sr, mask_blocks, complement)
    if dev.type != "cuda":
        raise ValueError(f"spgemm_blocks: tiles on {dev}; all must lie on "
                         f"one CUDA device (or all on the CPU)")
    bb = B.block if handles else int(B.shape[1])
    if bb != b or (not handles and tuple(B.shape[1:]) != (b, b)):
        raise ValueError(f"spgemm_blocks: tile sides {b} and {bb}; the "
                         f"kernels take square tiles of one side")
    _check(b, sr, plan, dev, tensors, mask_blocks, "spgemm_blocks")
    ops = [A] if same else [A, B]
    if handles:
        fill = stored_fill(*ops)
    else:
        counts = [entry_counts(X) for X in ops]
        fill = operand_fill(*counts)
    picked = "tile"
    if fill < entry_max_fill(b):
        forms = ([X.entry_form() for X in ops] if handles else
                 [entry_form(X, c) for X, c in zip(ops, counts)])
        EA, EB = forms[0], forms[-1]
        reads = _VALUES_READ.get(sr.mode, (False, False))
        if (reads[0] and not _finite(EA)) or (reads[1] and not _finite(EB)):
            picked = "tile (non-finite)"
        else:
            picked = "entry"
            return spgemm_entry(EA, EB, plan, sr, mask_blocks=mask_blocks,
                                complement=complement)
    tiles = (A.blocks, B.blocks) if handles else (A, B)
    return spgemm_tile(*tiles, plan, sr, mask_blocks=mask_blocks,
                       complement=complement)

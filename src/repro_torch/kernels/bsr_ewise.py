"""BSR element-wise numeric phase: the gathered-tile map.

Port of ``repro.kernels.bsr_ewise`` (the Pallas TPU kernel ``map_tiles`` ->
``_ewise_pallas``). The host plans of ``core.bsr`` (union, intersection or
mask alignment of the valid-tile key lists) give, per output tile, a
selector into each operand (-1: no stored tile on that side, read as the
all-zero tile); this module runs the numeric phase on the device, as two
hand-written CUDA C++ kernels for ``sm_90a`` computing the same function;
each source notes what bounds it and how it is shaped.

  tile   ``csrc/bsr_ewise.cu`` (``map_tiles``): whole tiles in, whole
         tiles out, for full tiles.
  entry  ``csrc/bsr_ewise_entry.cu`` (``map_entries``): the operands'
         payload forms in (``BSR.payload_form()``), entries out, for
         sparse tiles; ``core.bsr`` keeps the output as entries.

Modes (absent == 0; zeros stay zeros, so tiles an op empties are pruned):
  union      where(both stored, op(a, b), a + b)   GrB_eWiseAdd
  intersect  where(both stored, op(a, b), 0)       GrB_eWiseMult
  apply      where(a stored, op(a), 0)             GrB_apply
  select     where(a stored and op(a), a, 0)       GxB_select
  mask       where(b stored, a, 0)                 <M> restrict
  mask_c     where(b absent, a, 0)                 <!M> restrict

The JAX kernel takes any Python callable as ``op``; a CUDA kernel cannot,
so both take the named ops of ``core.semiring`` (``ewise``, or a
``Monoid``) and raise TypeError for a bare callable, on every device.

``pick`` chooses by the operands' fill against ``entry_max_fill(b)``
(``core.grb.EWISE_ENTRY_MAX_FILL``). Each wrapper launches its kernel
when its tensors lie on a CUDA device, never giving way to the other or
to a plain version, and takes its plain version, ``map_tiles_plain`` (the
port of ``_ewise_jnp`` and ``_tile_fn``) or ``map_entries_plain`` (a
per-tile key merge), when they lie on the CPU. ``launches`` counts kernel
launches, ``launches_entry`` and ``launches_tile`` those of each kernel,
``picked`` the last choice.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import grb
from repro_torch.core import semiring as S
from repro_torch.core.bsr import BSR, EntryForm, stored_fill
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)
launches_entry = 0    # of which the entry kernel's
launches_tile = 0     # of which the tile kernel's
picked = None         # the last pick: "entry" or "tile"

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
_bound_entry = None


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


def _fn_entry():
    global _bound_entry
    if _bound_entry is None:
        from repro_torch.kernels import build
        fn = build.load("bsr_ewise_entry").bsr_ewise_entry
        fn.argtypes = [ctypes.c_void_p] * 14 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound_entry = fn
    return _bound_entry


def entry_max_fill(b: int) -> float:
    """The dispatch's crossover for tiles of side ``b``."""
    return grb.entry_max_fill(grb.EWISE_ENTRY_MAX_FILL, b)


def pick(A: BSR, B: Optional[BSR] = None) -> str:
    """The variant for an element-wise op on ``A`` (and ``B``): "entry"
    when the operands' fill (stored entries over the capacity of their
    valid tiles) is under the crossover and the side fits the forms'
    uint8 coordinates, else "tile"."""
    global picked
    b = A.block
    fill = stored_fill(*([A] if B is None or B is A else [A, B]))
    picked = "entry" if b <= 256 and fill < entry_max_fill(b) else "tile"
    return picked


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


def _validate(mode, op, sel_a, sel_b, A, B, na: int, nb, a_side, b_side):
    """The checks both wrappers make: the mode, its named op, the
    selectors against the operands' tile counts (``na`` / ``nb``), their
    tile sides and devices. Returns (named op, sel_a, sel_b, all on the
    CPU)."""
    if mode not in EWISE_MODES:
        raise ValueError(f"bsr_ewise mode {mode!r} (one of {EWISE_MODES})")
    named = (S.named_op(op, _OP_KINDS[mode], f"bsr_ewise {mode}")
             if mode in _OP_KINDS else None)
    unary = mode in UNARY_MODES
    if not unary and (B is None or sel_b is None):
        raise ValueError(f"bsr_ewise {mode}: needs B and its selectors")
    sel_a = _selectors(sel_a, na, "A")
    if not unary:
        sel_b = _selectors(sel_b, nb, "B")
        if len(sel_b) != len(sel_a) or b_side != a_side:
            raise ValueError(f"bsr_ewise {mode}: {len(sel_a)} / "
                             f"{len(sel_b)} selectors, tiles {a_side} / "
                             f"{b_side}")
    devs = [A.device] + ([] if unary else [B.device])
    if all(d.type == "cpu" for d in devs):
        return named, sel_a, sel_b, True
    if not (devs[0].type == "cuda" and all(d == devs[0] for d in devs)):
        raise ValueError("bsr_ewise: operands on "
                         f"{[str(d) for d in devs]}; all must lie on one "
                         f"CUDA device (or all on the CPU)")
    return named, sel_a, sel_b, False


@dataclasses.dataclass
class KernelCall:
    """One kernel call prepared on the card, its selectors uploaded and its
    outputs allocated: :func:`launch` runs it, ``out`` holds the results
    (the tile kernel's (T, b, b) tiles; the entry kernel's ``(base, rows,
    cols, vals)`` slots)."""
    variant: str           # "entry" or "tile"
    args: tuple            # the kernel's arguments, the stream last
    out: object
    nt: int                # output tiles
    keep: tuple = ()       # the tensors whose pointers ``args`` holds


def launch(call: KernelCall):
    """Launch a prepared call (none for no output tiles); returns its
    ``out``. Counts the launch; raises KernelError on a failed one."""
    global launches, launches_entry, launches_tile
    if call.nt == 0:
        return call.out
    entry = call.variant == "entry"
    rc = (_fn_entry() if entry else _fn())(*call.args)
    if rc != 0:
        raise KernelError(f"bsr_ewise{'_entry' if entry else ''}: kernel "
                          f"launch failed, cudaError {rc}")
    launches += 1
    if entry:
        launches_entry += 1
    else:
        launches_tile += 1
    return call.out


def _dev_i32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def tile_call(Ablocks: torch.Tensor, sel_a, Bblocks: Optional[torch.Tensor],
              sel_b, mode: str, op=None) -> KernelCall:
    """:func:`map_tiles` on CUDA tiles, up to its launch."""
    named, sel_a, sel_b, cpu = _validate(
        mode, op, sel_a, sel_b, Ablocks, Bblocks, int(Ablocks.shape[0]),
        None if Bblocks is None else int(Bblocks.shape[0]),
        tuple(Ablocks.shape[1:]),
        None if Bblocks is None else tuple(Bblocks.shape[1:]))
    if cpu:
        raise ValueError("bsr_ewise: the tile kernel takes CUDA tiles")
    unary = mode in UNARY_MODES
    b = int(Ablocks.shape[1])
    dev = Ablocks.device
    nt = len(sel_a)
    out = torch.empty((nt, b, b), dtype=torch.float32, device=dev)
    A = Ablocks.to(torch.float32).contiguous()
    B = None if unary else Bblocks.to(torch.float32).contiguous()
    sa = _dev_i32(sel_a, dev)
    sb = None if unary else _dev_i32(sel_b, dev)
    ptrs = [t.data_ptr() for t in (A, B, out) if t is not None]
    vec = 4 if (b * b) % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    return KernelCall("tile", (
        A.data_ptr(), None if B is None else B.data_ptr(), sa.data_ptr(),
        None if sb is None else sb.data_ptr(), out.data_ptr(), nt, b,
        _MODE_CODES[mode], 0 if named is None else named.code,
        0.0 if named is None else named.scalar, vec,
        torch.cuda.current_stream(dev).cuda_stream), out, nt, (A, B, sa, sb))


def map_tiles(Ablocks: torch.Tensor, sel_a, Bblocks: Optional[torch.Tensor],
              sel_b, mode: str, op=None) -> torch.Tensor:
    """Numeric phase of a BSR element-wise op: (T, b, b) output payloads,
    aligned with the caller's output tile list.

    ``sel_a`` / ``sel_b`` are host int arrays of length T indexing the
    operand payloads; -1 selects the all-zero tile. For the unary modes
    pass ``Bblocks=None`` / ``sel_b=None``. ``op`` is a named op (or a
    Monoid) of the kind the mode takes; the mask modes take none."""
    named, sel_a, sel_b, cpu = _validate(
        mode, op, sel_a, sel_b, Ablocks, Bblocks, int(Ablocks.shape[0]),
        None if Bblocks is None else int(Bblocks.shape[0]),
        tuple(Ablocks.shape[1:]),
        None if Bblocks is None else tuple(Bblocks.shape[1:]))
    if cpu:
        return map_tiles_plain(Ablocks, sel_a, Bblocks, sel_b, mode, named)
    return launch(tile_call(Ablocks, sel_a, Bblocks, sel_b, mode, named))


# -- the entry kernel -----------------------------------------------------------
def _tile_counts(F: EntryForm, sel: torch.Tensor) -> torch.Tensor:
    """(T,) int64: the entries of tile ``sel[t]`` (0 where it is -1)."""
    per = torch.cat([F.base.diff(),
                     torch.zeros(1, dtype=torch.int64, device=sel.device)])
    n = F.base.shape[0] - 1
    return per[torch.where(sel >= 0, sel.long(), n)]


def _slot_base(FA, sa, FB, sb, mode) -> torch.Tensor:
    """(T + 1,) int64: output tile t's slots start at base[t], an upper
    bound of its results: A's entries and, under union, B's."""
    ub = _tile_counts(FA, sa)
    if mode == "union":
        ub = ub + _tile_counts(FB, sb)
    base = torch.zeros(len(sa) + 1, dtype=torch.int64, device=sa.device)
    base[1:] = torch.cumsum(ub, dim=0)
    return base


def _ranges(base: torch.Tensor, sel: torch.Tensor, lens: torch.Tensor):
    """(owner, index): for each t, ``lens[t]`` indices from
    ``base[sel[t]]`` on, with their t, in order."""
    owner = torch.repeat_interleave(
        torch.arange(len(sel), device=sel.device), lens)
    start = torch.cumsum(lens, dim=0) - lens
    first = base[sel.clamp(min=0).long()]
    idx = torch.arange(int(lens.sum()), device=sel.device) \
        - start[owner] + first[owner]
    return owner, idx


def map_entries_plain(FA: EntryForm, sel_a, FB: Optional[EntryForm], sel_b,
                      mode: str, op=None):
    """The entry kernel's function in torch, a per-tile key merge: the
    candidates of output tile t are the keys (row * b + column) of A's
    tile ``sel_a[t]`` and, under union, B's; each takes the mode's closure
    on the values (an absent side reads 0) and the slot of its rank in the
    tile, as ``map_entries`` lays them out. ``op`` may be any torch
    callable here."""
    dev = FA.vals.device
    b = FA.block
    unary = mode in UNARY_MODES or sel_b is None
    sa = torch.from_numpy(np.asarray(sel_a, np.int64)).to(dev)
    sb = None if unary else torch.from_numpy(
        np.asarray(sel_b, np.int64)).to(dev)
    base = _slot_base(FA, sa, FB, sb, mode)
    total = int(base[-1])
    rows = torch.zeros(total, dtype=torch.uint8, device=dev)
    cols = torch.zeros(total, dtype=torch.uint8, device=dev)
    vals = torch.zeros(total, dtype=torch.float32, device=dev)
    fn = _tile_fn(mode, op)

    def side(F, sel):
        t, e = _ranges(F.base, sel, _tile_counts(F, sel))
        key = t * (b * b) + F.rows[e].long() * b + F.cols[e].long()
        return t, key, F.vals[e]

    ta, ka, va = side(FA, sa)
    if unary:
        out_t, out_k, out_v = ta, ka, fn(va, va)
    else:
        tb, kb, vb = side(FB, sb)

        def lookup(keys, into, v):
            j = torch.searchsorted(into, keys).clamp(max=max(len(into) - 1, 0))
            hit = (into[j] == keys) if len(into) else torch.zeros_like(
                keys, dtype=torch.bool)
            return hit, torch.where(hit, v[j] if len(into) else 0.0, 0.0)

        _, bv = lookup(ka, kb, vb)
        out_t, out_k, out_v = ta, ka, fn(va, bv)
        if mode == "union":
            in_a, _ = lookup(kb, ka, va)
            only = ~in_a
            zero = torch.zeros_like(vb[only])
            out_t = torch.cat([ta, tb[only]])
            out_k = torch.cat([ka, kb[only]])
            out_v = torch.cat([out_v, fn(zero, vb[only])])
            out_k, order = torch.sort(out_k)
            out_t, out_v = out_t[order], out_v[order]
    # each candidate's slot: its tile's first slot plus its rank there
    cnt = torch.bincount(out_t, minlength=len(sa))
    start = torch.cumsum(cnt, dim=0) - cnt
    slot = base[out_t] + torch.arange(len(out_t), device=dev) - start[out_t]
    local = out_k % (b * b)
    rows[slot] = (local // b).to(torch.uint8)
    cols[slot] = (local % b).to(torch.uint8)
    vals[slot] = out_v.to(torch.float32)
    return base, rows, cols, vals


def entry_call(FA: EntryForm, sel_a, FB: Optional[EntryForm], sel_b,
               mode: str, op=None) -> KernelCall:
    """:func:`map_entries` on CUDA forms, up to its launch: the selectors
    uploaded, the slots sized (one sync) and allocated, values zeroed."""
    named, sel_a, sel_b, cpu = _validate(
        mode, op, sel_a, sel_b, FA.vals, None if FB is None else FB.vals,
        FA.base.shape[0] - 1, None if FB is None else FB.base.shape[0] - 1,
        FA.block, None if FB is None else FB.block)
    if cpu:
        raise ValueError("bsr_ewise: the entry kernel takes CUDA forms")
    dev = FA.vals.device
    Bf = None if mode in UNARY_MODES else FB
    sa = _dev_i32(sel_a, dev)
    sb = None if Bf is None else _dev_i32(sel_b, dev)
    base = _slot_base(FA, sa, FB, sb, mode)
    total = int(base[-1])
    rows = torch.empty(total, dtype=torch.uint8, device=dev)
    cols = torch.empty(total, dtype=torch.uint8, device=dev)
    vals = torch.zeros(total, dtype=torch.float32, device=dev)
    nt = len(sel_a)
    return KernelCall("entry", (
        FA.base.data_ptr(), FA.rows.data_ptr(), FA.cols.data_ptr(),
        FA.vals.data_ptr(), None if Bf is None else Bf.base.data_ptr(),
        None if Bf is None else Bf.rows.data_ptr(),
        None if Bf is None else Bf.cols.data_ptr(),
        None if Bf is None else Bf.vals.data_ptr(), sa.data_ptr(),
        None if sb is None else sb.data_ptr(), base.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), nt, FA.block,
        _MODE_CODES[mode], 0 if named is None else named.code,
        0.0 if named is None else named.scalar,
        torch.cuda.current_stream(dev).cuda_stream),
        (base, rows, cols, vals), nt, (FA, Bf, sa, sb))


def map_entries(FA: EntryForm, sel_a, FB: Optional[EntryForm], sel_b,
                mode: str, op=None):
    """Numeric phase of a BSR element-wise op on the operands' payload
    forms: ``(base, rows, cols, vals)``, output tile t's results in slots
    ``base[t]`` .. ``base[t + 1]`` row-major, a slot whose value bits are
    +0.0 holding nothing (``BSR.from_entry_slots`` keeps the rest).
    Selectors, ops and modes as :func:`map_tiles`."""
    named, sel_a, sel_b, cpu = _validate(
        mode, op, sel_a, sel_b, FA.vals, None if FB is None else FB.vals,
        FA.base.shape[0] - 1, None if FB is None else FB.base.shape[0] - 1,
        FA.block, None if FB is None else FB.block)
    if cpu:
        return map_entries_plain(FA, sel_a, FB, sel_b, mode, named)
    return launch(entry_call(FA, sel_a, FB, sel_b, mode, named))

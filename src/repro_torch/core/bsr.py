"""Block-Sparse-Row matrices: dense ``block x block`` tiles, only tiles that
hold an edge stored.

Port of ``repro.core.bsr``: the BSR struct, its builders and the
sparse-output half the k-hop path reaches (SpGEMM and the structural
union). Every array is bit-identical to the JAX build of the same input:

  * tiles are sorted by (block_row, block_col);
  * every block-row has >= 1 tile (empty rows get an all-zero padding tile
    with valid=0), so each output tile of a row is initialised once;
  * ``first`` / ``last`` mark the first / last tile of each block-row and
    ``row_ptr`` points at each row's run, counted before grid padding;
  * the tile count is padded to a multiple of ``pad_to`` = 8 by repeating
    the last tile's coordinates with valid = first = last = 0.

Coordinates are planned on the host in numpy (``_assemble_meta``,
``spgemm_symbolic``, copied from the JAX package); tile payloads are
built, gathered and pruned on the storage's device. ``from_coo`` is one
vectorised scatter straight into the final tile order (the JAX build loops
over tiles on the host), and ``transpose`` transposes each tile on the
device (the JAX build goes through a dense n x n on the host).

The element-wise family (``ewise_add`` ... ``extract_ranges``) is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import xfer

# entries per device chunk of the structure scan in to_coo, so no single
# boolean scan exceeds 2^30 entries
_SCAN_ENTRIES = 1 << 30


@dataclasses.dataclass
class BSR:
    shape: Tuple[int, int]
    block: int
    blocks: torch.Tensor      # (nnzb, block, block) float32 tile payloads
    block_rows: torch.Tensor  # (nnzb,) int32 block-row of each tile
    block_cols: torch.Tensor  # (nnzb,) int32 block-col of each tile
    first: torch.Tensor       # (nnzb,) int32 1 iff first tile of its row
    last: torch.Tensor        # (nnzb,) int32 1 iff last tile of its row
    valid: torch.Tensor       # (nnzb,) int32 0 for padding tiles
    row_ptr: torch.Tensor     # (nbrows+1,) int32 pointers over tiles
    nnz: int                  # element count (pre-blocking)
    # per-entry structure (nnzb, block, block) bool, present only when the
    # build saw explicit 0.0 entries, which the payload cannot tell from
    # absent; the tropical (bcast) product, to_coo and transpose read it
    emask: Optional[torch.Tensor] = None

    # -- properties ----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[0]

    @property
    def nbrows(self) -> int:
        return -(-self.shape[0] // self.block)

    @property
    def nbcols(self) -> int:
        return -(-self.shape[1] // self.block)

    @property
    def fill_ratio(self) -> float:
        """nnz / stored-tile capacity."""
        cap = int(self.valid.sum()) * self.block * self.block
        return self.nnz / max(cap, 1)

    # -- construction --------------------------------------------------------
    @staticmethod
    def _empty(shape, block: int, nnz: int, device) -> "BSR":
        """Zero-row shapes: no tiles at all."""
        z32 = torch.zeros(0, dtype=torch.int32, device=device)
        return BSR(shape=tuple(shape), block=block,
                   blocks=torch.zeros((0, block, block), dtype=torch.float32,
                                      device=device),
                   block_rows=z32, block_cols=z32, first=z32, last=z32,
                   valid=z32, row_ptr=torch.zeros(1, dtype=torch.int32,
                                                  device=device),
                   nnz=nnz)

    @staticmethod
    def _assemble_meta(b_r, b_c, nbr: int, nbc: int, pad_to: int = 8):
        """Structural phase on coordinates only (host numpy, the JAX
        package's code). From unique, unsorted valid-tile coordinates
        returns ``(a_r, a_c, valid, first, last, row_ptr, src)``, where
        ``src`` maps each output slot to its position in the caller's
        valid-tile list (-1 = an all-zero padding tile)."""
        b_r = np.asarray(b_r, dtype=np.int32)
        b_c = np.asarray(b_c, dtype=np.int32)
        nv = len(b_r)

        present = np.zeros(nbr, dtype=bool)
        present[b_r] = True
        missing = np.nonzero(~present)[0].astype(np.int32)
        tot = nv + len(missing)

        a_r = np.concatenate([b_r, missing])
        a_c = np.concatenate([b_c, np.zeros(len(missing), np.int32)])
        valid = np.concatenate([np.ones(nv, np.int32),
                                np.zeros(len(missing), np.int32)])
        src = np.concatenate([np.arange(nv, dtype=np.int32),
                              np.full(len(missing), -1, np.int32)])

        order = np.argsort(a_r.astype(np.int64) * nbc + a_c, kind="stable")
        a_r, a_c, valid, src = a_r[order], a_c[order], valid[order], src[order]

        first = np.zeros(tot, dtype=np.int32)
        last = np.zeros(tot, dtype=np.int32)
        first[0] = 1
        first[1:] = (a_r[1:] != a_r[:-1]).astype(np.int32)
        last[:-1] = first[1:]
        last[-1] = 1

        row_ptr = np.zeros(nbr + 1, dtype=np.int32)
        np.add.at(row_ptr, a_r + 1, 1)
        row_ptr = np.cumsum(row_ptr).astype(np.int32)

        pad = (-tot) % pad_to
        if pad:
            a_r = np.concatenate([a_r, np.full(pad, a_r[-1], np.int32)])
            a_c = np.concatenate([a_c, np.full(pad, a_c[-1], np.int32)])
            valid = np.concatenate([valid, np.zeros(pad, np.int32)])
            first = np.concatenate([first, np.zeros(pad, np.int32)])
            last = np.concatenate([last, np.zeros(pad, np.int32)])
            src = np.concatenate([src, np.full(pad, -1, np.int32)])
        return a_r, a_c, valid, first, last, row_ptr, src

    @staticmethod
    def _from_meta(meta, payload, shape, block: int, nnz: int,
                   emask=None) -> "BSR":
        a_r, a_c, valid, first, last, row_ptr, _ = meta
        dev = payload.device

        def i32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        return BSR(shape=tuple(shape), block=block, blocks=payload,
                   block_rows=i32(a_r), block_cols=i32(a_c), first=i32(first),
                   last=i32(last), valid=i32(valid), row_ptr=i32(row_ptr),
                   nnz=nnz, emask=emask)

    @staticmethod
    def _assemble(tiles: torch.Tensor, b_r, b_c, shape, block: int, nnz: int,
                  pad_to: int = 8, emask=None) -> "BSR":
        """A BSR from a list of *valid* tiles (a tensor on the target
        device) with unique, unsorted coordinates; the payload is gathered
        into the final order on the device. ``emask`` (same tile list,
        bool) rides the same gather."""
        n, m = shape
        nbr, nbc = -(-n // block), -(-m // block)
        if nbr == 0:
            return BSR._empty((n, m), block, nnz, tiles.device)
        meta = BSR._assemble_meta(b_r, b_c, nbr, nbc, pad_to)
        src = torch.from_numpy(meta[-1].astype(np.int64)).to(tiles.device)
        keep = (src >= 0)[:, None, None]
        gather = src.clamp(min=0)

        def place(t, zero):
            if t.shape[0] == 0:
                return torch.zeros((len(src), block, block), dtype=t.dtype,
                                   device=t.device)
            return torch.where(keep, t[gather], zero)

        payload = place(tiles.to(torch.float32), 0.0)
        em = None if emask is None else place(emask, False)
        return BSR._from_meta(meta, payload, shape, block, nnz, em)

    @staticmethod
    def from_coo(rows, cols, vals, shape, block: int = 128, pad_to: int = 8,
                 device="cuda") -> "BSR":
        """Tiles from an entry list, scattered once into their final slots
        on ``device``. Of repeated (row, col) entries the last one written
        holds, as in the JAX build; ``nnz`` counts every entry given."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if vals is None:
            vals = np.ones(rows.shape[0], dtype=np.float64)
        vals = np.asarray(vals, dtype=np.float64)
        n, m = shape
        dev = torch.device(device)
        nbr, nbc = -(-n // block), -(-m // block)
        nnz = int(rows.shape[0])
        if nbr == 0:
            return BSR._empty((n, m), block, nnz, dev)
        explicit_zero = bool(np.any(vals == 0.0))
        if nnz:
            key = rows * m + cols
            _, last_rev = np.unique(key[::-1], return_index=True)
            pick = nnz - 1 - last_rev
            rows, cols, vals = rows[pick], cols[pick], vals[pick]
        tkey = (rows // block) * nbc + cols // block
        ukey, inv = np.unique(tkey, return_inverse=True)
        meta = BSR._assemble_meta((ukey // nbc).astype(np.int32),
                                  (ukey % nbc).astype(np.int32), nbr, nbc,
                                  pad_to)
        src = meta[-1]
        slot = np.empty(len(ukey), dtype=np.int64)
        pos = np.nonzero(src >= 0)[0]
        slot[src[pos]] = pos
        idx = (torch.from_numpy(slot[inv.reshape(-1)]).to(dev),
               torch.from_numpy(rows % block).to(dev),
               torch.from_numpy(cols % block).to(dev))
        payload = torch.zeros((len(src), block, block), dtype=torch.float32,
                              device=dev)
        payload[idx] = torch.from_numpy(vals.astype(np.float32)).to(dev)
        emask = None
        if explicit_zero:
            emask = torch.zeros(payload.shape, dtype=torch.bool, device=dev)
            emask[idx] = True
        return BSR._from_meta(meta, payload, (n, m), block, nnz, emask)

    @staticmethod
    def from_blocks_device(block_rows, block_cols, blocks, shape, block: int,
                           pad_to: int = 8, prune: bool = True) -> "BSR":
        """A BSR from computed tile payloads (the SpGEMM numeric phase), on
        the payloads' device. All-zero tiles are pruned on the device so
        ``nvals`` / ``fill_ratio`` report stored structure; only the (nt,)
        occupancy and the nnz scalar cross to the host. ``nnz`` counts the
        nonzero entries."""
        n, m = shape
        b_r = np.asarray(block_rows, dtype=np.int32)
        b_c = np.asarray(block_cols, dtype=np.int32)
        blocks = torch.as_tensor(blocks).to(torch.float32)
        if -(-n // block) == 0:
            return BSR._empty((n, m), block, 0, blocks.device)
        nnz = int(torch.count_nonzero(blocks)) if len(b_r) else 0
        if prune and len(b_r):
            occupied = (blocks != 0).flatten(1).any(dim=1)
            keep = occupied.cpu().numpy()
            b_r, b_c = b_r[keep], b_c[keep]
            blocks = blocks[occupied]
        return BSR._assemble(blocks, b_r, b_c, (n, m), block, nnz=nnz,
                             pad_to=pad_to)

    @staticmethod
    def from_blocks(block_rows, block_cols, blocks, shape, block: int,
                    pad_to: int = 8, prune: bool = True,
                    device="cuda") -> "BSR":
        """:meth:`from_blocks_device` for a host payload (numpy), placed on
        ``device`` first."""
        payload = torch.from_numpy(np.asarray(blocks, np.float32)).to(
            torch.device(device))
        return BSR.from_blocks_device(block_rows, block_cols, payload, shape,
                                      block, pad_to=pad_to, prune=prune)

    @staticmethod
    def from_dense(A, block: int = 128, device=None) -> "BSR":
        """Tiles of a dense matrix (tensor or numpy); on the tensor's device
        unless ``device`` is given (numpy input defaults to ``"cuda"``)."""
        if device is None:
            device = A.device if isinstance(A, torch.Tensor) else "cuda"
        A = A.cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
        r, c = np.nonzero(A)
        return BSR.from_coo(r, c, A[r, c], A.shape, block=block,
                            device=device)

    # -- views ---------------------------------------------------------------
    def _structure(self, lo: int, hi: int) -> torch.Tensor:
        """Stored entries of tiles lo..hi (bool): the emask where present,
        else nonzero payload; padding tiles store nothing."""
        s = (self.blocks[lo:hi] != 0) if self.emask is None \
            else self.emask[lo:hi].clone()
        s &= (self.valid[lo:hi] != 0)[:, None, None]
        return s

    def to_dense(self) -> torch.Tensor:
        xfer.record("bsr_densify")
        n, m = self.shape
        b = self.block
        out = torch.zeros((self.nbrows * b, self.nbcols * b),
                          dtype=torch.float32, device=self.device)
        v = torch.nonzero(self.valid, as_tuple=True)[0]
        tiles = out.view(self.nbrows, b, self.nbcols, b).permute(0, 2, 1, 3)
        tiles[self.block_rows[v].long(), self.block_cols[v].long()] = \
            self.blocks[v]
        return out[:n, :m]

    def transpose(self) -> "BSR":
        """Swap each valid tile's coordinates, transpose its payload (and
        emask) on the device, and reassemble: the JAX package's dense
        round trip, without the dense n x n."""
        v = torch.nonzero(self.valid, as_tuple=True)[0]
        tiles = self.blocks[v].transpose(1, 2)
        em = None if self.emask is None else self.emask[v].transpose(1, 2)
        s = (tiles != 0) if em is None else em
        keep = s.flatten(1).any(dim=1)
        nnz = int(s.sum())
        if em is not None and not bool((s & (tiles == 0)).any()):
            em = None    # no explicit zero survives: the JAX build drops it
        keep_np = keep.cpu().numpy()
        return BSR._assemble(
            tiles[keep], self.block_cols[v].cpu().numpy()[keep_np],
            self.block_rows[v].cpu().numpy()[keep_np],
            (self.shape[1], self.shape[0]), self.block, nnz,
            emask=None if em is None else em[keep])

    def valid_tiles(self):
        """Host-side (indices, block_rows, block_cols) of the valid tiles."""
        va = self.valid.cpu().numpy().astype(bool)
        idx = np.nonzero(va)[0].astype(np.int32)
        return (idx, self.block_rows.cpu().numpy()[idx],
                self.block_cols.cpu().numpy()[idx])

    def to_coo(self):
        """Host-side COO extraction, tiles in storage order and row-major
        inside a tile (the JAX order); the selection runs on the device."""
        xfer.record("bsr_to_coo")
        b = self.block
        step = max(1, _SCAN_ENTRIES // (b * b))
        rows, cols, vals = [], [], []
        for lo in range(0, self.nnzb, step):
            t, lr, lc = torch.nonzero(self._structure(lo, lo + step),
                                      as_tuple=True)
            t = t + lo
            vals.append(self.blocks[t, lr, lc].cpu())
            rows.append((self.block_rows[t].long() * b + lr).cpu())
            cols.append((self.block_cols[t].long() * b + lc).cpu())
        if not rows:
            return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.float32),)
        return (torch.cat(rows).numpy(), torch.cat(cols).numpy(),
                torch.cat(vals).numpy())


# ---------------------------------------------------------------------------
# SpGEMM: C<M> = A (x) B with both operands block-sparse
# ---------------------------------------------------------------------------
SPGEMM_MODES = ("dot", "dot_pair", "dot_indicator", "dot_first")


@dataclasses.dataclass
class SpGEMMPlan:
    """Output of the symbolic phase: the block-level multiply schedule.

    Task t multiplies A tile ``a_sel[t]`` by B tile ``b_sel[t]`` into output
    tile ``c_sel[t]``; tasks are sorted by c_sel so each output tile is one
    contiguous run (``first`` / ``last`` bound it). ``valid=0`` marks grid
    padding. ``mask_sel[j]`` is the mask tile backing output tile j (-1 =
    absent, an all-zero mask tile).
    """
    a_sel: np.ndarray     # (T,) i32 index into A.blocks
    b_sel: np.ndarray     # (T,) i32 index into B.blocks
    c_sel: np.ndarray     # (T,) i32 index into the output tile list
    first: np.ndarray     # (T,) i32 1 iff first task of its output tile
    last: np.ndarray      # (T,) i32 1 iff last task of its output tile
    valid: np.ndarray     # (T,) i32 0 for padding tasks
    c_rows: np.ndarray    # (nc,) i32 block-row per output tile
    c_cols: np.ndarray    # (nc,) i32 block-col per output tile
    mask_sel: Optional[np.ndarray]  # (nc,) i32 mask tile per output tile / -1

    @property
    def ntasks(self) -> int:
        return int(self.a_sel.shape[0])

    @property
    def nc(self) -> int:
        return int(self.c_rows.shape[0])


def _ragged_ranges(offsets: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """concat(range(offsets[i], offsets[i]+lens[i]) for i) vectorized."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lens)
    task_start = np.repeat(ends - lens, lens)
    return (np.arange(total, dtype=np.int64) - task_start
            + np.repeat(offsets, lens))


def spgemm_symbolic(A: BSR, B: BSR, mask: Optional[BSR] = None,
                    complement: bool = False, pad_to: int = 8) -> SpGEMMPlan:
    """Block-level pattern of C = A (x) B, optionally restricted to <M>
    (host numpy, the JAX package's code): pair every valid A tile (i, l)
    with every valid B tile (l, j) and group the tasks by output tile. A
    non-complemented mask prunes output tiles before any numeric work; a
    complemented one only annotates."""
    ia, bra, bca = A.valid_tiles()
    ib, brb, bcb = B.valid_tiles()
    nbc_out = B.nbcols

    order = np.argsort(brb, kind="stable")
    ib, brb, bcb = ib[order], brb[order], bcb[order]
    nbk = B.nbrows
    cnt = np.bincount(brb, minlength=nbk)
    ptr = np.concatenate([[0], np.cumsum(cnt)])

    lens = cnt[bca]
    a_rep = np.repeat(np.arange(len(ia), dtype=np.int64), lens)
    pos = _ragged_ranges(ptr[bca], lens)
    a_sel = ia[a_rep]
    b_sel = ib[pos]
    ckey = bra[a_rep].astype(np.int64) * nbc_out + bcb[pos]

    mkeys = midx = None
    if mask is not None:
        im, brm, bcm = mask.valid_tiles()
        mkeys = brm.astype(np.int64) * nbc_out + bcm
        morder = np.argsort(mkeys)
        mkeys, midx = mkeys[morder], im[morder]
        if not complement:
            keep = np.isin(ckey, mkeys)
            a_sel, b_sel, ckey = a_sel[keep], b_sel[keep], ckey[keep]

    order = np.argsort(ckey, kind="stable")
    a_sel, b_sel, ckey = a_sel[order], b_sel[order], ckey[order]
    ukey, c_sel = np.unique(ckey, return_inverse=True)
    c_sel = c_sel.reshape(-1)
    c_rows = (ukey // nbc_out).astype(np.int32)
    c_cols = (ukey % nbc_out).astype(np.int32)

    ntask = len(ckey)
    first = np.zeros(ntask, dtype=np.int32)
    last = np.zeros(ntask, dtype=np.int32)
    if ntask:
        first[0] = 1
        first[1:] = (ckey[1:] != ckey[:-1]).astype(np.int32)
        last[:-1] = first[1:]
        last[-1] = 1
    valid = np.ones(ntask, dtype=np.int32)

    mask_sel = None
    if mask is not None:
        if len(mkeys):
            j = np.clip(np.searchsorted(mkeys, ukey), 0, len(mkeys) - 1)
            mask_sel = np.where(mkeys[j] == ukey, midx[j], -1).astype(np.int32)
        else:
            mask_sel = np.full(len(ukey), -1, dtype=np.int32)

    pad = (-ntask) % pad_to if ntask else 0
    if pad:
        a_sel = np.concatenate([a_sel, np.full(pad, a_sel[-1])])
        b_sel = np.concatenate([b_sel, np.full(pad, b_sel[-1])])
        c_sel = np.concatenate([c_sel, np.full(pad, c_sel[-1])])
        first = np.concatenate([first, np.zeros(pad, np.int32)])
        last = np.concatenate([last, np.zeros(pad, np.int32)])
        valid = np.concatenate([valid, np.zeros(pad, np.int32)])

    return SpGEMMPlan(a_sel=a_sel.astype(np.int32),
                      b_sel=b_sel.astype(np.int32),
                      c_sel=c_sel.astype(np.int32), first=first, last=last,
                      valid=valid, c_rows=c_rows, c_cols=c_cols,
                      mask_sel=mask_sel)


def spgemm(A: BSR, B: BSR, sr, mask: Optional[BSR] = None,
           complement: bool = False) -> BSR:
    """Two-phase sparse-times-sparse mxm: C<M> = A (x) B, C stays BSR.

    The symbolic phase (host) plans the block schedule and applies a
    structural mask block-wise; the numeric phase runs
    ``kernels.bsr_spgemm.spgemm_blocks`` (the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors), folding the mask's element pattern
    into each output tile's epilogue. All-zero output tiles are pruned.
    """
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"spgemm inner dims: {A.shape} x {B.shape}")
    if mask is not None and mask.shape != (A.shape[0], B.shape[1]):
        raise ValueError(f"spgemm mask shape {mask.shape} != output "
                         f"{(A.shape[0], B.shape[1])}")
    if sr.mode not in SPGEMM_MODES:
        raise NotImplementedError(
            f"spgemm does not support mode {sr.mode!r} (semiring {sr.name})")
    B = reblock(B, A.block)
    if mask is not None:
        mask = reblock(mask, A.block)

    shape = (A.shape[0], B.shape[1])
    plan = spgemm_symbolic(A, B, mask=mask, complement=complement)
    if plan.ntasks == 0:
        return BSR.from_blocks_device(
            plan.c_rows, plan.c_cols,
            torch.zeros((0, A.block, A.block), dtype=torch.float32,
                        device=A.device), shape, A.block)

    from repro_torch.kernels import bsr_spgemm as _k  # kernels import core
    mask_blocks = None
    if mask is not None:
        sel = torch.from_numpy(np.clip(plan.mask_sel, 0, None).astype(
            np.int64)).to(A.device)
        present = torch.from_numpy(plan.mask_sel >= 0).to(A.device)
        mask_blocks = torch.where(present[:, None, None],
                                  mask.blocks.to(torch.float32)[sel], 0.0)
    cblocks = _k.spgemm_blocks(A.blocks, B.blocks, plan, sr,
                               mask_blocks=mask_blocks, complement=complement)
    return BSR.from_blocks_device(plan.c_rows, plan.c_cols, cblocks, shape,
                                  A.block)


def bsr_union(A: BSR, B: BSR) -> BSR:
    """Structural (boolean) union of two same-shape patterns through their
    host COO lists (the JAX package's route) — the OR the multi-hop
    reachability matrices need."""
    if A.shape != B.shape:
        raise ValueError(f"bsr_union shapes: {A.shape} vs {B.shape}")
    ra, ca, _ = A.to_coo()
    rb, cb, _ = B.to_coo()
    r = np.concatenate([ra, rb]).astype(np.int64)
    c = np.concatenate([ca, cb]).astype(np.int64)
    key = r * A.shape[1] + c
    _, idx = np.unique(key, return_index=True)
    return BSR.from_coo(r[idx], c[idx], None, A.shape, block=A.block,
                        device=A.device)


def reblock(A: BSR, block: int) -> BSR:
    """Rebuild at a different tile size (sparse: COO round trip)."""
    if A.block == block:
        return A
    return BSR.from_coo(*A.to_coo(), A.shape, block=block, device=A.device)


def as_bsr(store, block: int) -> BSR:
    """A BSR at ``block`` from a BSR at any tile size or from anything with
    ``to_coo`` (ELL), through the entry list, never a dense one."""
    if isinstance(store, BSR):
        return reblock(store, block)
    return BSR.from_coo(*store.to_coo(), store.shape, block=block,
                        device=store.device)

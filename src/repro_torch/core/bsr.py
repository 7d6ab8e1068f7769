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

The tile list (``_assemble_meta``) is laid out in torch on the device its
coordinates lie on: the host for a build from host arrays, the card for
an output whose coordinates a device plan made. SpGEMM's symbolic plan
(``spgemm_symbolic``) runs in torch on the operands' device and stays
there; only its two counts cross to the host. Tile payloads are built,
gathered and pruned on the storage's device. ``from_coo`` is one
vectorised scatter straight into the final tile order (the JAX build loops
over tiles on the host), and ``transpose`` transposes each tile on the
device (the JAX build goes through a dense n x n on the host).

The handle also caches, built once on the device by torch glue, its
stored entries in two forms: ``entry_form()`` (and ``payload_form()``,
which also keeps the tiles' -0.0s), a CSR per tile, which SpGEMM's and the
element-wise family's entry kernels read; and ``row_csr()``, one CSR over
the rows, which ``bsr_mxm``'s entry kernel reads. A handle that an
entry-level op produced holds entries only and builds its tiles on the
first ``.blocks`` read (``tile_builds()`` counts these builds); its tile
list, ``nnz`` and built tiles equal the JAX build's.

The element-wise family (``ewise_add`` ... ``extract_ranges``) plans its
output tiles on the host from the valid-tile key lists (the JAX package's
code) and runs the numeric phase on the device through
``kernels.bsr_ewise`` (entries or whole tiles, by the operands' fill); the
payloads never leave the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import xfer

# entries per device chunk of the structure scan in to_coo, so no single
# boolean scan exceeds 2^30 entries
_SCAN_ENTRIES = 1 << 30
# tile elements per chunk of the entry-form build (a 64 MB bool scan and at
# most 512 MB of int64 positions at a time)
_FORM_ENTRIES = 1 << 26
BANDS = 32            # row bands per tile in EntryForm.bands

_tile_builds = [0]
_densify_calls = [0]
_host_numeric = [0]
plan_tasks = 0        # SpGEMM tile tasks planned (before grid padding)
plan_host_copies = 0  # copies through core.xfer that SpGEMM plans made


def tile_builds() -> int:
    """Tiles materialised from entries so far: each first ``.blocks`` read
    of a handle that an entry-level op produced. Tests read deltas."""
    return _tile_builds[0]


def densify_calls() -> int:
    """``BSR.to_dense()`` materializations so far (monotonic), counted
    where the JAX package counts them: the sparse algorithm paths (SpGEMM
    triangles, k-truss) promise none on their hot loops."""
    return _densify_calls[0]


def host_numeric_calls() -> int:
    """Assemblies from a host payload (``BSR.from_blocks``) so far
    (monotonic); the element-wise family and SpGEMM's numeric phase keep
    their payloads on the device and add none."""
    return _host_numeric[0]


# ---------------------------------------------------------------------------
# stored entries: a per-tile CSR (EntryForm) and a global row CSR (RowCSR)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EntryForm:
    """The entries of a stack of (b x b) tiles as one CSR per tile. Tile
    t's row i holds entries ``base[t] + row_ptr[t, i]`` up to
    ``base[t] + row_ptr[t, i + 1]``, sorted by column. ``entry_form``
    drops zeros: they add nothing in any dot mode (for finite inputs). A
    payload form (``signed_zeros``) also keeps the tiles' -0.0s."""
    block: int
    base: torch.Tensor     # (nnzb + 1,) int64 first entry of each tile
    row_ptr: torch.Tensor  # (nnzb, b + 1) int32 offsets inside the tile
    rows: torch.Tensor     # (E,) uint8 row in the tile
    cols: torch.Tensor     # (E,) uint8 column in the tile
    vals: torch.Tensor     # (E,) float32
    bands: torch.Tensor    # (nnzb,) int32 bit q: band q of rows holds one
    entries: int           # E

    def tile_of(self) -> torch.Tensor:
        """(E,) int64: the tile of each entry."""
        n = self.base.shape[0] - 1
        return torch.repeat_interleave(
            torch.arange(n, device=self.base.device), self.base.diff(),
            output_size=self.entries)


def _chunk_tiles(b: int) -> int:
    return max(1, _FORM_ENTRIES // (b * b))


def _held(chunk: torch.Tensor, signed_zeros: bool) -> torch.Tensor:
    """The elements an entry form holds: nonzero, or (``signed_zeros``)
    every element whose bits are not +0.0."""
    return chunk.view(torch.int32) != 0 if signed_zeros else chunk != 0


def entry_counts(blocks: torch.Tensor,
                 signed_zeros: bool = False) -> torch.Tensor:
    """(nnzb, b) int32: the entries of each tile row, chunked."""
    nnzb, b = int(blocks.shape[0]), int(blocks.shape[1])
    if nnzb == 0:
        return torch.zeros((0, b), dtype=torch.int32, device=blocks.device)
    step = _chunk_tiles(b)
    return torch.cat([_held(blocks[lo:lo + step].to(torch.float32),
                            signed_zeros).sum(dim=2, dtype=torch.int32)
                      for lo in range(0, nnzb, step)])


def _occupancy(counts: torch.Tensor):
    """(entries, tiles holding any) of one operand's row counts."""
    per_tile = counts.sum(dim=1, dtype=torch.int64)
    return int(per_tile.sum()), int((per_tile > 0).sum())


def operand_fill(*counts: torch.Tensor) -> float:
    """The fill a dispatch reads: stored entries over the capacity of the
    tiles that hold any, over the distinct operands' row counts (for one
    BSR of distinct nonzero entries, ``BSR.fill_ratio``)."""
    b = int(counts[0].shape[1])
    occ = [_occupancy(c) for c in counts]
    return (sum(e for e, _ in occ)
            / max(sum(t for _, t in occ) * b * b, 1))


def _bands(counts: torch.Tensor) -> torch.Tensor:
    """(nnzb,) int32: bit q set iff band q of a tile's rows holds one."""
    nnzb, b = counts.shape
    dev = counts.device
    band_of = torch.arange(b, device=dev) * BANDS // b
    per_band = torch.zeros((nnzb, BANDS), dtype=torch.int32, device=dev)
    per_band.index_add_(1, band_of, counts)
    word = ((per_band > 0).to(torch.int64)
            << torch.arange(BANDS, device=dev)).sum(dim=1)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _form(counts, rows, cols, vals, b: int) -> EntryForm:
    """An EntryForm from its row counts and its entries, already grouped
    by tile and row-major inside each tile."""
    nnzb = int(counts.shape[0])
    dev = counts.device
    row_ptr = torch.zeros((nnzb, b + 1), dtype=torch.int32, device=dev)
    row_ptr[:, 1:] = torch.cumsum(counts, dim=1, dtype=torch.int32)
    base = torch.zeros(nnzb + 1, dtype=torch.int64, device=dev)
    base[1:] = torch.cumsum(row_ptr[:, -1].to(torch.int64), dim=0)
    return EntryForm(block=b, base=base, row_ptr=row_ptr, rows=rows,
                     cols=cols, vals=vals, bands=_bands(counts),
                     entries=int(vals.shape[0]))


def form_of_entries(tile, rows, cols, vals, ntiles: int, b: int) -> EntryForm:
    """An EntryForm of ``ntiles`` tiles from entries grouped by tile (in
    tile order) and row-major inside each tile; ``tile`` (E,) int64."""
    counts = torch.zeros(ntiles * b, dtype=torch.int32, device=vals.device)
    counts.index_add_(0, tile * b + rows.long(),
                      torch.ones_like(tile, dtype=torch.int32))
    return _form(counts.view(ntiles, b), rows, cols, vals, b)


def entry_form(blocks: torch.Tensor, counts: Optional[torch.Tensor] = None,
               signed_zeros: bool = False) -> EntryForm:
    """The per-tile CSR of ``blocks`` (nnzb, b, b), on their device: plain
    torch glue, a chunked ``nonzero`` in row-major order, which groups the
    entries by tile and row and sorts each row by column. ``counts``, when
    given, are ``entry_counts(blocks, signed_zeros)``."""
    nnzb, b = int(blocks.shape[0]), int(blocks.shape[1])
    if b > 256:
        raise ValueError(f"entry_form: tile side {b} > 256 does not fit "
                         f"uint8 coordinates")
    dev = blocks.device
    if counts is None:
        counts = entry_counts(blocks, signed_zeros)
    per_tile = counts.sum(dim=1, dtype=torch.int64)
    base_h = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(per_tile, dim=0)]).cpu().numpy()
    E = int(base_h[-1])
    rows = torch.empty(E, dtype=torch.uint8, device=dev)
    cols = torch.empty(E, dtype=torch.uint8, device=dev)
    vals = torch.empty(E, dtype=torch.float32, device=dev)
    flat = blocks.reshape(nnzb, b * b)
    step = _chunk_tiles(b)
    for lo in range(0, nnzb, step):
        hi = min(lo + step, nnzb)
        s, e = int(base_h[lo]), int(base_h[hi])
        if s == e:
            continue
        chunk = flat[lo:hi].to(torch.float32)
        t, p = torch.nonzero(_held(chunk, signed_zeros), as_tuple=True)
        rows[s:e] = torch.div(p, b, rounding_mode="floor").to(torch.uint8)
        cols[s:e] = (p % b).to(torch.uint8)
        vals[s:e] = chunk[t, p]
    return _form(counts, rows, cols, vals, b)


def _coords(a) -> torch.Tensor:
    """Tile coordinates as an int32 tensor: a tensor stays on its device,
    anything else (numpy, a list) becomes a host tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.int32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def stored_fill(*handles: "BSR") -> float:
    """The fill the dispatches read: stored entries over the capacity of
    the valid tiles, over the distinct handles given (for one handle,
    ``fill_ratio``)."""
    b = handles[0].block
    return (sum(X.nnz for X in handles)
            / max(sum(X.tiles_held for X in handles) * b * b, 1))


def drop_zeros(form: EntryForm) -> EntryForm:
    """``form`` without its zero-valued entries (the -0.0s a payload form
    keeps); the same object when it holds none."""
    keep = form.vals != 0
    if bool(keep.all()):
        return form
    nnzb = form.base.shape[0] - 1
    return form_of_entries(form.tile_of()[keep], form.rows[keep],
                           form.cols[keep], form.vals[keep], nnzb,
                           form.block)


@dataclasses.dataclass
class RowCSR:
    """A handle's stored entries as one CSR over its rows: row i holds
    entries ``indptr[i]`` up to ``indptr[i + 1]``, in ascending column
    order, which is the tile kernel's (tile, column) summation order
    because a block-row's tiles are sorted by block column. The emask's
    explicit zeros are kept (a 0-weight edge under min_plus / max_plus).
    ``order`` lists the rows longest first, the entry kernel's schedule."""
    indptr: torch.Tensor   # (n + 1,) int64
    cols: torch.Tensor     # (E,) int32 global column
    vals: torch.Tensor     # (E,) float32
    order: torch.Tensor    # (n,) int32 rows by descending length
    _at_least: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def entries(self) -> int:
        return int(self.cols.shape[0])

    def rows_at_least(self, k: int) -> int:
        """The rows holding k entries or more: the first ones of
        ``order``. Counted once per k."""
        if k not in self._at_least:
            self._at_least[k] = int((self.indptr.diff() >= k).sum())
        return self._at_least[k]


def _row_csr(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             shape) -> RowCSR:
    """A RowCSR from (row, col, value) entries in any order (int64)."""
    n, m = shape
    key, perm = torch.sort(rows * m + cols)
    lengths = torch.bincount(rows, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(lengths, dim=0)
    order = torch.argsort(lengths, descending=True, stable=True)
    return RowCSR(indptr=indptr, cols=(key % m).to(torch.int32),
                  vals=vals[perm].to(torch.float32),
                  order=order.to(torch.int32))


class BSR:
    """A block-sparse matrix handle (module docstring). Handles are
    immutable: the forms they cache (``payload_form``, ``entry_form``,
    ``row_csr``) assume it.

    A handle that an entry-level op produced holds its entries (a payload
    EntryForm over its tile list) and builds its ``(nnzb, b, b)`` tiles
    only when ``.blocks`` is read (``tile_builds()`` counts these builds);
    every other handle holds tiles."""

    def __init__(self, shape, block: int, blocks: Optional[torch.Tensor],
                 block_rows: torch.Tensor, block_cols: torch.Tensor,
                 first: torch.Tensor, last: torch.Tensor,
                 valid: torch.Tensor, row_ptr: torch.Tensor, nnz: int,
                 emask: Optional[torch.Tensor] = None,
                 entries: Optional[EntryForm] = None):
        if blocks is None and entries is None:
            raise ValueError("BSR: needs tiles or entries")
        self.shape: Tuple[int, int] = tuple(shape)
        self.block = block
        self._blocks = blocks     # (nnzb, block, block) float32 payloads
        self.block_rows = block_rows  # (nnzb,) int32 block-row of each tile
        self.block_cols = block_cols  # (nnzb,) int32 block-col of each tile
        self.first = first        # (nnzb,) int32 1 iff first tile of its row
        self.last = last          # (nnzb,) int32 1 iff last tile of its row
        self.valid = valid        # (nnzb,) int32 0 for padding tiles
        self.row_ptr = row_ptr    # (nbrows+1,) int32 pointers over tiles
        self.nnz = nnz            # element count (pre-blocking)
        # per-entry structure (nnzb, block, block) bool, present only when
        # the build saw explicit 0.0 entries, which the payload cannot tell
        # from absent; the tropical (bcast) product, to_coo and transpose
        # read it
        self.emask = emask
        self._payload = entries
        self._form = None
        self._csr = None
        self._tiles_held = None

    def __repr__(self) -> str:
        return (f"BSR(shape={self.shape}, block={self.block}, "
                f"nnzb={self.nnzb}, nnz={self.nnz}, "
                f"tiles={'lazy' if self._blocks is None else 'built'})")

    # -- properties ----------------------------------------------------------
    @property
    def blocks(self) -> torch.Tensor:
        """(nnzb, b, b) float32 tile payloads; an entry-produced handle
        scatters its entries into zeroed tiles on first read."""
        if self._blocks is None:
            _tile_builds[0] += 1
            E = self._payload
            b = self.block
            t = torch.zeros((self.nnzb, b, b), dtype=torch.float32,
                            device=self.device)
            t[E.tile_of(), E.rows.long(), E.cols.long()] = E.vals
            self._blocks = t
        return self._blocks

    @property
    def device(self) -> torch.device:
        return self.block_rows.device

    @property
    def nnzb(self) -> int:
        return self.block_rows.shape[0]

    @property
    def nbrows(self) -> int:
        return -(-self.shape[0] // self.block)

    @property
    def nbcols(self) -> int:
        return -(-self.shape[1] // self.block)

    @property
    def tiles_held(self) -> int:
        """The valid (non-padding) tiles."""
        if self._tiles_held is None:
            self._tiles_held = int(self.valid.sum())
        return self._tiles_held

    @property
    def fill_ratio(self) -> float:
        """nnz / stored-tile capacity."""
        cap = self.tiles_held * self.block * self.block
        return self.nnz / max(cap, 1)

    # -- the entry forms -----------------------------------------------------
    def payload_form(self) -> EntryForm:
        """Every tile element whose bits are not +0.0, -0.0 included: what
        the element-wise entry kernel reads, so it sees a tile's -0.0s as
        the tile kernel does. Built once, on the device."""
        if self._payload is None:
            self._payload = entry_form(self.blocks, signed_zeros=True)
        return self._payload

    def entry_form(self) -> EntryForm:
        """The per-tile CSR of the nonzero entries (SpGEMM's operand): the
        payload form without its -0.0s."""
        if self._form is None:
            self._form = drop_zeros(self.payload_form())
        return self._form

    def _stored_entries(self):
        """(row, col, value) of the stored entries on the device, int64
        coordinates, tiles in storage order and row-major inside a tile."""
        b = self.block
        if self._blocks is None:
            E = self._payload
            keep = E.vals != 0
            t = E.tile_of()[keep]
            return (self.block_rows[t].long() * b + E.rows[keep].long(),
                    self.block_cols[t].long() * b + E.cols[keep].long(),
                    E.vals[keep])
        step = max(1, _SCAN_ENTRIES // (b * b))
        rows, cols, vals = [], [], []
        for lo in range(0, self.nnzb, step):
            t, lr, lc = torch.nonzero(self._structure(lo, lo + step),
                                      as_tuple=True)
            t = t + lo
            vals.append(self.blocks[t, lr, lc])
            rows.append(self.block_rows[t].long() * b + lr)
            cols.append(self.block_cols[t].long() * b + lc)
        if not rows:
            z = torch.zeros(0, dtype=torch.int64, device=self.device)
            return z, z, torch.zeros(0, dtype=torch.float32,
                                     device=self.device)
        return torch.cat(rows), torch.cat(cols), torch.cat(vals)

    def row_csr(self) -> RowCSR:
        """The stored entries as one CSR over the rows (``bsr_mxm``'s entry
        kernel reads it). Built once, on the device."""
        if self._csr is None:
            self._csr = _row_csr(*self._stored_entries(), self.shape)
        return self._csr

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
        """Structural phase on coordinates only (the JAX package's numpy
        code, in torch on the coordinates' device: numpy input is laid out
        on the host). From unique, unsorted valid-tile coordinates returns
        int32 ``(a_r, a_c, valid, first, last, row_ptr, src)``, where
        ``src`` maps each output slot to its position in the caller's
        valid-tile list (-1 = an all-zero padding tile)."""
        b_r, b_c = _coords(b_r), _coords(b_c)
        dev = b_r.device
        i32 = dict(dtype=torch.int32, device=dev)
        nv = b_r.shape[0]

        present = torch.zeros(nbr, dtype=torch.bool, device=dev)
        present[b_r.long()] = True
        missing = torch.nonzero(~present).flatten().to(torch.int32)
        nm = missing.shape[0]
        tot = nv + nm

        a_r = torch.cat([b_r, missing])
        a_c = torch.cat([b_c, torch.zeros(nm, **i32)])
        valid = torch.cat([torch.ones(nv, **i32), torch.zeros(nm, **i32)])
        src = torch.cat([torch.arange(nv, **i32), torch.full((nm,), -1, **i32)])

        order = torch.sort(a_r.long() * nbc + a_c, stable=True).indices
        a_r, a_c, valid, src = a_r[order], a_c[order], valid[order], src[order]

        first = torch.ones(tot, **i32)
        first[1:] = (a_r[1:] != a_r[:-1]).to(torch.int32)
        last = torch.ones(tot, **i32)
        last[:-1] = first[1:]

        # a_r ascends: row r's tiles start at the first slot holding r or more
        row_ptr = torch.searchsorted(a_r, torch.arange(nbr + 1, **i32),
                                     out_int32=True)

        pad = (-tot) % pad_to
        if pad:
            def tail(a, fill=None):
                end = a[-1:] if fill is None else a.new_full((1,), fill)
                return torch.cat([a, end.expand(pad)])
            a_r, a_c, src = tail(a_r), tail(a_c), tail(src, -1)
            valid, first, last = tail(valid, 0), tail(first, 0), tail(last, 0)
        return a_r, a_c, valid, first, last, row_ptr, src

    @staticmethod
    def _from_meta(meta, payload, shape, block: int, nnz: int,
                   emask=None, entries: Optional[EntryForm] = None) -> "BSR":
        """A handle on ``meta``'s tile list holding ``payload`` tiles, or
        (``payload`` None) the ``entries`` of its tiles. A tile list laid
        out on the host is copied to the payload's device."""
        a_r, a_c, valid, first, last, row_ptr, _ = meta
        dev = (entries.vals if payload is None else payload).device

        def on(t):
            return t if t.device == dev else xfer.to_device(t, dev, "tiles")

        return BSR(shape=tuple(shape), block=block, blocks=payload,
                   block_rows=on(a_r), block_cols=on(a_c), first=on(first),
                   last=on(last), valid=on(valid), row_ptr=on(row_ptr),
                   nnz=nnz, emask=emask, entries=entries)

    @staticmethod
    def _assemble(tiles: torch.Tensor, b_r, b_c, shape, block: int, nnz: int,
                  pad_to: int = 8, emask=None) -> "BSR":
        """A BSR from a list of *valid* tiles (a tensor on the target
        device) with unique, unsorted coordinates (host arrays, or tensors
        on any device); the payload is gathered into the final order on
        the device. ``emask`` (same tile list, bool) rides the same
        gather."""
        n, m = shape
        nbr, nbc = -(-n // block), -(-m // block)
        if nbr == 0:
            return BSR._empty((n, m), block, nnz, tiles.device)
        meta = BSR._assemble_meta(b_r, b_c, nbr, nbc, pad_to)
        src = meta[-1].long()
        if src.device != tiles.device:
            src = xfer.to_device(src, tiles.device, "tiles")
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
        src = meta[-1].numpy()
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
        ``nvals`` / ``fill_ratio`` report stored structure. Coordinates on
        the payloads' device (a device plan's) stay there, and only the nnz
        scalar crosses to the host; host coordinates take the (nt,)
        occupancy down and the tile list up. ``nnz`` counts the nonzero
        entries."""
        n, m = shape
        b_r, b_c = _coords(block_rows), _coords(block_cols)
        blocks = torch.as_tensor(blocks).to(torch.float32)
        if -(-n // block) == 0:
            return BSR._empty((n, m), block, 0, blocks.device)
        nnz = int(torch.count_nonzero(blocks)) if len(b_r) else 0
        if prune and len(b_r):
            occupied = (blocks != 0).flatten(1).any(dim=1)
            keep = (occupied if b_r.device == occupied.device
                    else xfer.to_host(occupied, "tiles"))
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
        _host_numeric[0] += 1
        payload = torch.from_numpy(np.asarray(blocks, np.float32)).to(
            torch.device(device))
        return BSR.from_blocks_device(block_rows, block_cols, payload, shape,
                                      block, pad_to=pad_to, prune=prune)

    @staticmethod
    def from_entry_slots(block_rows, block_cols, base: torch.Tensor,
                         rows: torch.Tensor, cols: torch.Tensor,
                         vals: torch.Tensor, shape, block: int,
                         pad_to: int = 8) -> "BSR":
        """The handle of an entry-level op's output, holding entries (its
        tiles are built on first read). Output tile t, at ``block_rows[t]``
        / ``block_cols[t]`` in ascending key order, holds the results in
        slots ``base[t]`` .. ``base[t + 1]``, row-major; a slot whose value
        bits are +0.0 holds nothing. Every other result is kept, -0.0 too
        (the tile kernel writes its bits), and the tiles left with no
        nonzero value are pruned, as ``from_blocks_device`` prunes, so
        the tile list, ``nnz`` and the built tiles equal the tile route's.
        Only the (T,) occupancy and the nnz scalar cross to the host."""
        n, m = shape
        dev = vals.device
        nbr, nbc = -(-n // block), -(-m // block)
        if nbr == 0:
            return BSR._empty((n, m), block, 0, dev)
        b_r = np.asarray(block_rows, dtype=np.int32)
        b_c = np.asarray(block_cols, dtype=np.int32)
        T = len(b_r)
        slot = torch.nonzero(vals.view(torch.int32) != 0).flatten()
        tile = torch.searchsorted(base[1:], slot, right=True)
        v = vals[slot]
        nz = torch.bincount(tile[v != 0], minlength=T)
        nz_h = nz.cpu().numpy()
        occ = nz_h > 0
        nnz = int(nz_h.sum())
        keep = (nz > 0)[tile]
        tile, slot, v = tile[keep], slot[keep], v[keep]
        meta = BSR._assemble_meta(b_r[occ], b_c[occ], nbr, nbc, pad_to)
        src = meta[-1].numpy()
        pos = np.nonzero(src >= 0)[0]
        # the kept tiles ascend by key, so their slots keep the entries'
        # order: each entry only moves to its tile's slot number
        new_of = np.full(T, -1, dtype=np.int64)
        new_of[np.nonzero(occ)[0][src[pos]]] = pos
        form = form_of_entries(torch.from_numpy(new_of).to(dev)[tile],
                               rows[slot], cols[slot], v, len(src), block)
        return BSR._from_meta(meta, None, (n, m), block, nnz, entries=form)

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
        _densify_calls[0] += 1
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
        return BSR._assemble(
            tiles[keep], self.block_cols[v][keep], self.block_rows[v][keep],
            (self.shape[1], self.shape[0]), self.block, nnz,
            emask=None if em is None else em[keep])

    def valid_tiles(self):
        """Host-side (indices, block_rows, block_cols) of the valid tiles."""
        va = xfer.to_host(self.valid, "tiles").numpy().astype(bool)
        idx = np.nonzero(va)[0].astype(np.int32)
        return (idx, xfer.to_host(self.block_rows, "tiles").numpy()[idx],
                xfer.to_host(self.block_cols, "tiles").numpy()[idx])

    def to_coo(self):
        """Host-side COO extraction, tiles in storage order and row-major
        inside a tile (the JAX order); the selection runs on the device,
        from the entries where the handle holds no tiles."""
        xfer.record("bsr_to_coo")
        return tuple(x.cpu().numpy() for x in self._stored_entries())


# ---------------------------------------------------------------------------
# SpGEMM: C<M> = A (x) B with both operands block-sparse
# ---------------------------------------------------------------------------
SPGEMM_MODES = ("dot", "dot_pair", "dot_indicator", "dot_first")


@dataclasses.dataclass
class SpGEMMPlan:
    """Output of the symbolic phase: the block-level multiply schedule, as
    int32 tensors on the operands' device.

    Task t multiplies A tile ``a_sel[t]`` by B tile ``b_sel[t]`` into output
    tile j for ``cptr[j] <= t < cptr[j + 1]``: tasks are sorted by output
    tile, so each output tile is one contiguous run, in the JAX package's
    task order. ``valid=0`` marks grid padding, past ``cptr[nc]``.
    ``mask_sel[j]`` is the mask tile backing output tile j (-1 = absent, an
    all-zero mask tile).
    """
    a_sel: torch.Tensor     # (T,) i32 index into A.blocks
    b_sel: torch.Tensor     # (T,) i32 index into B.blocks
    valid: torch.Tensor     # (T,) i32 0 for padding tasks
    cptr: torch.Tensor      # (nc + 1,) i32 each output tile's run of tasks
    c_rows: torch.Tensor    # (nc,) i32 block-row per output tile
    c_cols: torch.Tensor    # (nc,) i32 block-col per output tile
    mask_sel: Optional[torch.Tensor]  # (nc,) i32 mask tile per output tile
    tasks: int              # tasks before grid padding (cptr[nc])

    @property
    def ntasks(self) -> int:
        return int(self.a_sel.shape[0])

    @property
    def nc(self) -> int:
        return int(self.c_rows.shape[0])

    def c_sel(self) -> torch.Tensor:
        """(T,) int64: each task's output tile, from the run pointer;
        padding tasks repeat the last task's."""
        dev = self.cptr.device
        c = torch.repeat_interleave(torch.arange(self.nc, device=dev),
                                    self.cptr.diff(), output_size=self.tasks)
        return torch.cat([c, c[-1:].expand(self.ntasks - self.tasks)])

    def mask_tiles(self, mask: BSR) -> torch.Tensor:
        """(nc, b, b) float32: the mask tile behind each output tile, all
        zero where the mask stores none."""
        sel = self.mask_sel.long()
        return torch.where((sel >= 0)[:, None, None],
                           mask.blocks.to(torch.float32)[sel.clamp(min=0)],
                           0.0)


_NO_KEY = torch.iinfo(torch.int64).max   # sorts after every tile key


def _lookup(keys: torch.Tensor, idx: torch.Tensor,
            wanted: torch.Tensor) -> torch.Tensor:
    """For each of ``wanted``, ``idx`` at its key in the ascending
    ``keys``, or -1 where no key equals it."""
    if keys.numel() == 0:
        return torch.full_like(wanted, -1)
    j = torch.searchsorted(keys, wanted).clamp_(max=keys.numel() - 1)
    return torch.where(keys[j] == wanted, idx[j], -1)


def _plan_to_host(t: torch.Tensor) -> torch.Tensor:
    """One of a plan's copies to the host, counted in plan_host_copies."""
    global plan_host_copies
    plan_host_copies += 1
    return xfer.to_host(t, "plan")


def spgemm_symbolic(A: BSR, B: BSR, mask: Optional[BSR] = None,
                    complement: bool = False, pad_to: int = 8) -> SpGEMMPlan:
    """Block-level pattern of C = A (x) B, optionally restricted to <M>, in
    torch on the operands' device: pair every valid A tile (i, l) with
    every valid B tile (l, j) and group the tasks by output tile, task for
    task the JAX package's numpy plan. A non-complemented mask prunes
    output tiles before any numeric work; a complemented one only
    annotates. Two small copies cross to the host: the pairs' count, then
    the tasks' and the output tiles' (``plan_host_copies``). Adds the tasks
    to ``plan_tasks``."""
    global plan_tasks
    with tracing.span("spgemm_plan") as sp:
        plan = _symbolic(A, B, mask, complement, pad_to)
        sp.set(tasks=plan.tasks, tiles=plan.nc)
    plan_tasks += plan.tasks
    return plan


def _symbolic(A: BSR, B: BSR, mask: Optional[BSR], complement: bool,
              pad_to: int) -> SpGEMMPlan:
    dev = A.device
    nbc = B.nbcols
    nbk = B.nbrows
    i32 = dict(dtype=torch.int32, device=dev)

    # B's valid tiles grouped by block row, in tile order (a stable sort;
    # padding tiles go to row nbk, which no valid A tile reaches)
    brow = torch.where(B.valid != 0, B.block_rows.long(), nbk)
    brow, ib = torch.sort(brow, stable=True)
    start = torch.searchsorted(brow, torch.arange(nbk + 2, device=dev))
    cnt = start.diff()

    # one task per (A tile, matching B tile) pair, A's tiles in order
    acol = A.block_cols.long()
    lens = torch.where(A.valid != 0, cnt[acol], 0)
    pairs = int(_plan_to_host(lens.sum()))
    a_sel = torch.repeat_interleave(torch.arange(A.nnzb, **i32), lens,
                                    output_size=pairs)
    ends = torch.cumsum(lens, 0)
    shift = start[acol] - (ends - lens)
    b_sel = ib[torch.arange(pairs, device=dev) + shift[a_sel]]
    del shift
    key = A.block_rows.long()[a_sel] * nbc + B.block_cols.long()[b_sel]

    mkey = midx = None
    if mask is not None:
        mkey = mask.block_rows.long() * nbc + mask.block_cols.long()
        mkey, midx = torch.sort(torch.where(mask.valid != 0, mkey, _NO_KEY),
                                stable=True)
        if not complement:
            # dropped pairs sort after every kept one
            key = torch.where(_lookup(mkey, midx, key) >= 0, key, _NO_KEY)

    # tasks by output tile; each tile's run keeps the pairs' order
    key, order = torch.sort(key, stable=True)
    new = torch.ones(pairs, dtype=torch.bool, device=dev)
    new[1:] = key[1:] != key[:-1]
    held = key != _NO_KEY
    counts = torch.stack([held.sum(), (new & held).sum()])
    ntask, nc = (int(v) for v in _plan_to_host(counts))

    order = order[:ntask]
    a_sel, b_sel = a_sel[order], b_sel[order].to(torch.int32)
    del order
    c_sel = torch.cumsum(new[:ntask], 0) - 1
    cptr = torch.searchsorted(c_sel, torch.arange(nc + 1, device=dev))
    ukey = key[cptr[:-1]]
    mask_sel = (None if mask is None
                else _lookup(mkey, midx, ukey).to(torch.int32))

    pad = (-ntask) % pad_to if ntask else 0
    return SpGEMMPlan(
        a_sel=torch.cat([a_sel, a_sel[-1:].expand(pad)]),
        b_sel=torch.cat([b_sel, b_sel[-1:].expand(pad)]),
        valid=torch.cat([torch.ones(ntask, **i32), torch.zeros(pad, **i32)]),
        cptr=cptr.to(torch.int32), c_rows=(ukey // nbc).to(torch.int32),
        c_cols=(ukey % nbc).to(torch.int32), mask_sel=mask_sel, tasks=ntask)


def spgemm(A: BSR, B: BSR, sr, mask: Optional[BSR] = None,
           complement: bool = False) -> BSR:
    """Two-phase sparse-times-sparse mxm: C<M> = A (x) B, C stays BSR.

    The symbolic phase (on the operands' device) plans the block schedule
    and applies a structural mask block-wise; the numeric phase runs
    ``kernels.bsr_spgemm.spgemm_blocks`` on the two handles and the plan as
    it lies (a CUDA kernel on CUDA tensors, reading the handles' cached
    entry forms or their tiles; the plain version on CPU tensors), folding
    the mask's element pattern into each output tile's epilogue. All-zero
    output tiles are pruned, and the output's tile list is laid out on the
    device from the plan's coordinates."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"spgemm inner dims: {A.shape} x {B.shape}")
    if mask is not None and mask.shape != (A.shape[0], B.shape[1]):
        raise ValueError(f"spgemm mask shape {mask.shape} != output "
                         f"{(A.shape[0], B.shape[1])}")
    if sr.mode not in SPGEMM_MODES:
        raise NotImplementedError(
            f"spgemm does not support mode {sr.mode!r} (semiring {sr.name})")
    with tracing.span("spgemm") as sp:
        B = reblock(B, A.block)
        if mask is not None:
            mask = reblock(mask, A.block)

        shape = (A.shape[0], B.shape[1])
        tasks0 = plan_tasks
        plan = spgemm_symbolic(A, B, mask=mask, complement=complement)
        sp.set(tasks=plan_tasks - tasks0, tiles=plan.nc)
        if plan.ntasks == 0:
            return BSR.from_blocks_device(
                plan.c_rows, plan.c_cols,
                torch.zeros((0, A.block, A.block), dtype=torch.float32,
                            device=A.device), shape, A.block)

        from repro_torch.kernels import bsr_spgemm as _k  # imports core
        mask_blocks = None if mask is None else plan.mask_tiles(mask)
        cblocks = _k.spgemm_blocks(A, B, plan, sr, mask_blocks=mask_blocks,
                                   complement=complement)
        return BSR.from_blocks_device(plan.c_rows, plan.c_cols, cblocks,
                                      shape, A.block)


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


# ---------------------------------------------------------------------------
# element-wise family: block-aligned sparse ops (GrB_eWiseAdd / eWiseMult /
# GrB_apply / GxB_select), never materializing a dense operand
# ---------------------------------------------------------------------------
# Stored == nonzero; an absent entry renders as 0. Each op is a host plan
# over tile keys (union / intersection of block coordinates, the
# element-wise analog of the SpGEMM symbolic phase) and a numeric phase on
# the device, ``kernels.bsr_ewise``. Results go through from_blocks_device,
# so tiles that end up all-zero (a select that empties a tile, a cancelled
# add) are pruned and nvals / fill_ratio stay truthful. Ops are named
# (``semiring.ewise`` or a Monoid): a bare callable raises TypeError.

def _check_same_shape(A: BSR, B: BSR, opname: str) -> None:
    if A.shape != B.shape:
        raise ValueError(f"{opname} shapes: {A.shape} vs {B.shape}")


def _tile_keys(brows: np.ndarray, bcols: np.ndarray, nbc: int) -> np.ndarray:
    return brows.astype(np.int64) * nbc + bcols.astype(np.int64)


def _key_select(wanted: np.ndarray, keys: np.ndarray,
                idx: np.ndarray) -> np.ndarray:
    """For each key in ``wanted``, the tile index in ``idx`` holding it, or
    -1 when no stored tile has that key. ``keys`` need not be sorted."""
    out = np.full(len(wanted), -1, dtype=np.int32)
    if len(keys) == 0 or len(wanted) == 0:
        return out
    order = np.argsort(keys)
    keys, idx = keys[order], idx[order]
    j = np.clip(np.searchsorted(keys, wanted), 0, len(keys) - 1)
    hit = keys[j] == wanted
    out[hit] = idx[j[hit]]
    return out


def ewise_plan(mode: str, A: BSR, B: Optional[BSR] = None):
    """The host plan of one element-wise op: ``(sel_a, sel_b, rows, cols,
    B)``, per output tile the A and B tile selectors (-1: absent), its
    block coordinates, and B reblocked to A's tile size (None for the unary
    modes, whose ``sel_b`` is None).

      union      the union of both valid-tile key lists
      intersect  their intersection: only tiles valid in both are gathered
      apply, select   A's valid tiles
      mask       A's tiles that have a mask tile (block-level prune)
      mask_c     all of A's tiles: an absent mask tile reads as all-zero,
                 which ``mask_c`` keeps whole
    """
    ia, ra, ca = A.valid_tiles()
    if mode in ("apply", "select"):
        return ia, None, ra, ca, None
    _check_same_shape(A, B, f"bsr.{mode}")
    B = reblock(B, A.block)
    ib, rb, cb = B.valid_tiles()
    nbc = A.nbcols
    ka = _tile_keys(ra, ca, nbc)
    kb = _tile_keys(rb, cb, nbc)
    if mode in ("mask", "mask_c"):
        sel_b = _key_select(ka, kb, ib)
        if mode == "mask":
            keep = sel_b >= 0
            ia, ra, ca, sel_b = ia[keep], ra[keep], ca[keep], sel_b[keep]
        return ia, sel_b, ra, ca, B
    keys = np.union1d(ka, kb) if mode == "union" else np.intersect1d(ka, kb)
    return (_key_select(keys, ka, ia), _key_select(keys, kb, ib),
            (keys // nbc).astype(np.int32), (keys % nbc).astype(np.int32), B)


def _ewise(mode: str, A: BSR, B: Optional[BSR], op) -> BSR:
    """Plan on the host; the operands' fill picks the numeric phase
    (``kernels.bsr_ewise.pick``): the entry kernel on the payload forms,
    whose output stays entries (a handle that builds its tiles on first
    read), or the tile kernel, whose output tiles are pruned."""
    from repro_torch.kernels import bsr_ewise as _k   # kernels import core
    sel_a, sel_b, rows, cols, B = ewise_plan(mode, A, B)
    if _k.pick(A, B) == "entry":
        out = _k.map_entries(A.payload_form(), sel_a,
                             None if B is None else B.payload_form(), sel_b,
                             mode, op)
        return BSR.from_entry_slots(rows, cols, *out, A.shape, A.block)
    res = _k.map_tiles(A.blocks, sel_a, None if B is None else B.blocks,
                       sel_b, mode, op)
    return BSR.from_blocks_device(rows, cols, res, A.shape, A.block)


def ewise_add(A: BSR, B: BSR, op) -> BSR:
    """C = A (+) B, GraphBLAS *union* semantics over stored entries:
    pattern(A) | pattern(B); op(a, b) where both store an entry, the stored
    value unchanged where one side does (the absent side is never fed to
    op)."""
    return _ewise("union", A, B, op)


def ewise_mult(A: BSR, B: BSR, op) -> BSR:
    """C = A (.*) B, GraphBLAS *intersection* semantics: pattern(A) &
    pattern(B), op(a, b) there."""
    return _ewise("intersect", A, B, op)


def apply_stored(A: BSR, f) -> BSR:
    """GrB_apply over stored entries only: f(A[i,j]) where stored; zero
    lanes inside a stored tile are absent and stay zero whatever f(0)."""
    return _ewise("apply", A, None, f)


def select_stored(A: BSR, pred) -> BSR:
    """GxB_select: keep stored entries where pred(value); tiles the
    predicate empties are pruned."""
    return _ewise("select", A, None, pred)


def mask_keep(A: BSR, M: BSR, complement: bool = False) -> BSR:
    """A restricted to M's stored pattern (<M>), or to its absent pattern
    (<!M>)."""
    return _ewise("mask_c" if complement else "mask", A, M, None)


def extract_ranges(A: BSR, r0: int, r1: int, c0: int, c1: int) -> BSR:
    """Block-aligned GrB_extract: A[r0:r1, c0:c1] with r0 / c0 on tile
    boundaries. Tile-list surgery on host coordinates; the payload gather
    and the crop of boundary tiles run on the device."""
    if r0 % A.block or c0 % A.block:
        raise ValueError("extract_ranges needs block-aligned starts "
                         f"(got {r0}, {c0} for block {A.block})")
    b = A.block
    br0, bc0 = r0 // b, c0 // b
    br1, bc1 = -(-r1 // b), -(-c1 // b)
    ia, ra, ca = A.valid_tiles()
    keep = (ra >= br0) & (ra < br1) & (ca >= bc0) & (ca < bc1)
    ia, ra, ca = ia[keep], ra[keep] - br0, ca[keep] - bc0
    out_n, out_m = r1 - r0, c1 - c0
    dev = A.device
    if len(ia):
        blk = A.blocks.to(torch.float32)[torch.from_numpy(
            ia.astype(np.int64)).to(dev)]
        # crop tiles that extend past the slice end (the crop pattern is
        # host structural metadata; the multiply runs on the device)
        rows_ok = torch.from_numpy(
            (ra[:, None] * b + np.arange(b)[None, :]) < out_n).to(dev)
        cols_ok = torch.from_numpy(
            (ca[:, None] * b + np.arange(b)[None, :]) < out_m).to(dev)
        blk = blk * (rows_ok[:, :, None] & cols_ok[:, None, :]).to(
            torch.float32)
    else:
        blk = torch.zeros((0, b, b), dtype=torch.float32, device=dev)
    return BSR.from_blocks_device(ra, ca, blk, (out_n, out_m), b)

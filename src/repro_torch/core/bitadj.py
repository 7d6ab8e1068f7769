"""BitELL: bit-packed structural adjacency.

Port of ``repro.core.bitadj``: BitELL and its mesh twin
``ShardedBitELL``. Rows are grouped into 32-row panels; each panel
keeps an ELL-style list of occupied 32-column tile slots, and one 32x32
tile of edges lives in 32 words:

    tiles  (P, S, 32) int32    bit b of tiles[p, s, r] <=> edge
                               (p*32 + r,  cols[p, s]*32 + b)
    cols   (P, S)     int32    column-tile id per slot (sentinel C = empty)

with P = ceil(n/32) panels and S the widest panel's slot count. The layout,
the slot order and the sentinel are the JAX package's; words hold the
uint32 bit pattern in int32 storage (see ``core.bitmap``).

The or_and product against a packed frontier is ``panels_mxm_words`` — the
plain version of the hand-written CUDA kernel ``kernels.bitadj_mxv``, which
reads the occupied slots through a ``SlotPlan`` (``BitELL.slot_plan``).
Weighted semirings take the cached materialize-to-ELL fallback
(``to_ell``), as in the JAX package.

``ShardedBitELL`` lays the panels over a ``distr.mesh.Mesh``'s "data"
axis, padded with all-sentinel panels; each position holds a shard-local
BitELL whose kernel forms (``occupied_first``, ``slot_plan``) are built
once, when it is distributed. ``sharded_mxm_words`` is its or_and product:
one word all-gather, then the word kernel on every shard.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitmap, xfer
from repro_torch.core import shard as _shard
from repro_torch.core.ell import ELL

TILE = bitmap.WORD_BITS     # 32-row panels x 32-column tiles, one word/row

# -- fmt="auto" crossover policy (copied from the JAX package, which
# measured it with benchmarks/calibrate.py::calibrate_bitadj_fill) -----------
AUTO_BITADJ_MIN_FILL = 0.02   # occupied-tile fill below this: ELL wins
AUTO_BITADJ_MAX_SLOTS = 64    # widest-panel slots above this: padding loses


def _tile_stats(rows, cols, shape):
    """(occupied-tile fill, widest-panel slot count) of a COO structure."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if rows.size == 0:
        return 0.0, 0
    n_ct = -(-int(shape[1]) // TILE)
    key = np.unique((rows // TILE) * n_ct + (cols // TILE))
    slots = int(np.bincount((key // n_ct).astype(np.int64)).max())
    fill = rows.size / (len(key) * TILE * TILE)
    return fill, slots


def auto_bitadj_ok(rows, cols, vals, shape) -> bool:
    """Construction-time side of the BitELL auto policy: a boolean relation
    whose occupied 32x32 tiles are dense enough (AUTO_BITADJ_MIN_FILL)
    without slot-padding blowup on skewed panels (AUTO_BITADJ_MAX_SLOTS)."""
    if vals is not None and not np.all(np.asarray(vals) == 1.0):
        return False
    if np.asarray(rows).size == 0:
        return False
    fill, slots = _tile_stats(rows, cols, shape)
    return fill >= AUTO_BITADJ_MIN_FILL and slots <= AUTO_BITADJ_MAX_SLOTS

# occupied slots per work item of the packed kernel (``BitELL.slot_plan``):
# 32 and 64 tie at the Graph500 scale-18 path shape and 128 or more is
# slower (tools/word_kernels.py --sweep on an H100); 64 splits fewer panels
ITEM_SLOTS = 64


@dataclasses.dataclass
class SlotPlan:
    """The packed kernel's work over ``occupied_first()`` storage: item i
    is ``items[i] = (panel, s0, s1, split)``, the panel's occupied slots
    ``[s0, s1)``. A panel of m occupied slots takes ``max(1, ceil(m / K))``
    items of near-equal ranges, so a hub panel is spread over many items
    and a panel with no occupied slot still has one (an empty range, whose
    rows it writes as 0). The rows of a split panel (more than one item)
    are OR-merged into the output, so they are zeroed first:
    ``zero_rows``."""
    K: int
    items: torch.Tensor       # (I, 4) int32: panel, s0, s1, split (0 / 1)
    zero_rows: torch.Tensor   # (z,) int32: every row < n of a split panel
    split_panels: int
    hub_slots: int            # the most occupied slots of one panel


def slot_plan(cols: torch.Tensor, n_rows: int, n_ctiles: int,
              K: int = ITEM_SLOTS) -> SlotPlan:
    """Split the occupied slots of occupied-first ``cols`` (P, S) into
    items of at most K (``SlotPlan``), on their device with no host
    loop."""
    if K < 1:
        raise ValueError(f"slot_plan: K must be positive, got {K}")
    dev = cols.device
    P = cols.shape[0]
    occ = (cols < n_ctiles).sum(dim=1)                 # (P,) occupied
    m = torch.clamp((occ + K - 1) // K, min=1)         # items per panel
    panel = torch.repeat_interleave(torch.arange(P, device=dev), m)
    first = torch.cumsum(m, dim=0) - m
    j = torch.arange(panel.shape[0], device=dev) - first[panel]
    mp, op = m[panel], occ[panel]
    split = m > 1
    items = torch.stack([panel, j * op // mp, (j + 1) * op // mp,
                         split[panel].long()], dim=1)
    sp = torch.nonzero(split).flatten()
    rows = (sp[:, None] * TILE + torch.arange(TILE, device=dev)).flatten()
    return SlotPlan(K=K, items=items.to(torch.int32).contiguous(),
                    zero_rows=rows[rows < n_rows].to(torch.int32).contiguous(),
                    split_panels=int(sp.shape[0]),
                    hub_slots=int(occ.max()) if P else 0)


@dataclasses.dataclass
class BitELL:
    shape: Tuple[int, int]
    tiles: torch.Tensor     # (P, S, 32) int32 bit-tiles (see module doc)
    cols: torch.Tensor      # (P, S) int32 column-tile per slot; sentinel C
    nnz: int
    # cached ELL materialization (the weighted-semiring fallback target)
    _ell: Optional[ELL] = dataclasses.field(
        default=None, repr=False, compare=False)
    # (tiles, cols) with each panel's occupied slots first: the kernel's
    # operands, cached per matrix
    _slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)
    # the packed kernel's slot plan over occupied_first()
    _plan: Optional[SlotPlan] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_panels(self) -> int:
        return self.tiles.shape[0]

    @property
    def n_slots(self) -> int:
        return self.tiles.shape[1]

    @property
    def n_ctiles(self) -> int:
        return -(-self.shape[1] // TILE)

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @property
    def payload_bytes(self) -> int:
        """Adjacency payload (tiles + slot index), as the JAX package
        accounts it."""
        return self.tiles.numel() * 4 + self.cols.numel() * 4

    @staticmethod
    def from_coo(rows, cols, vals, shape, pad_slots_to: int = 1,
                 device="cuda") -> "BitELL":
        """Structural build: every (row, col) pair is an edge. ``vals`` must
        be None or all-ones — BitELL stores no weights."""
        if vals is not None and not np.all(np.asarray(vals) == 1.0):
            raise TypeError(
                "BitELL is structural (boolean) storage and cannot carry "
                "edge weights; build fmt='ell' (or let fmt='auto' pick) for "
                "weighted relations")
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        n, k = int(shape[0]), int(shape[1])
        P = max(-(-n // TILE), 1)
        C = max(-(-k // TILE), 1)
        key = rows // TILE * C + cols // TILE          # global tile id
        order = np.argsort(key, kind="stable")
        rows, cols, key = rows[order], cols[order], key[order]
        ukey, inv = np.unique(key, return_inverse=True)
        up = (ukey // C).astype(np.int64)              # panel of each tile
        pdeg = np.bincount(up, minlength=P)
        S = int(pdeg.max()) if pdeg.size and pdeg.max() > 0 else 1
        S = S + (-S) % max(pad_slots_to, 1)
        starts = np.zeros(P + 1, dtype=np.int64)
        starts[1:] = np.cumsum(pdeg)
        slot = np.arange(len(ukey)) - starts[up]
        colsA = np.full((P, S), C, dtype=np.int32)     # sentinel = zero X tile
        colsA[up, slot] = (ukey % C).astype(np.int32)
        tiles = np.zeros(P * S * TILE, dtype=np.uint32)
        word = (up[inv] * S + slot[inv]) * TILE + rows % TILE
        np.bitwise_or.at(tiles, word,
                         np.uint32(1) << (cols % TILE).astype(np.uint32))
        # duplicate edges collapse into one bit, so the set-bit count (the
        # JAX package's popcount) is the number of distinct (row, col) pairs
        nnz = int(np.unique(rows * max(k, 1) + cols).size)
        dev = torch.device(device)
        return BitELL(shape=(n, k),
                      tiles=torch.from_numpy(
                          tiles.view(np.int32).reshape(P, S, TILE)).to(dev),
                      cols=torch.from_numpy(colsA).to(dev), nnz=nnz)

    @staticmethod
    def from_ell(e: ELL) -> "BitELL":
        """Structural view of an ELL's stored pattern (values dropped), on
        the ELL's device."""
        r, c, _ = e.to_coo()
        return BitELL.from_coo(r, c, None, e.shape, device=e.device)

    @staticmethod
    def from_dense(A, device=None) -> "BitELL":
        """The nonzero pattern of a dense matrix (tensor or numpy); on the
        tensor's device unless ``device`` is given (numpy input defaults to
        ``"cuda"``)."""
        if device is None:
            device = A.device if isinstance(A, torch.Tensor) else "cuda"
        A = A.cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
        r, c = np.nonzero(A)
        return BitELL.from_coo(r, c, None, A.shape, device=device)

    def occupied_first(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tiles, cols) with each panel's occupied slots before its
        sentinel slots, so a panel ends at its first sentinel. ``from_coo``
        already stores them so; other storage is reordered within its
        panels (OR does not depend on slot order). Built once, then
        cached."""
        if self._slots is None:
            tiles, cols = self.tiles, self.cols
            occ = cols < self.n_ctiles
            if bool((occ[:, 1:] & ~occ[:, :-1]).any()):
                order = torch.argsort((~occ).to(torch.int8), dim=1,
                                      stable=True)
                cols = cols.gather(1, order)
                tiles = tiles.gather(
                    1, order[:, :, None].expand(-1, -1, TILE))
            self._slots = (tiles.contiguous(), cols.contiguous())
        return self._slots

    def slot_plan(self) -> SlotPlan:
        """``slot_plan`` of ``occupied_first()``'s cols: items of at most
        ``ITEM_SLOTS`` slots. Built once, on the device."""
        if self._plan is None:
            self._plan = slot_plan(self.occupied_first()[1], self.shape[0],
                                   self.n_ctiles)
        return self._plan

    def to_coo(self):
        """Host-side COO of the stored structure (vals are unit weights);
        the bit scan runs on the storage's device."""
        t = self.tiles
        p, s, r = torch.nonzero(t, as_tuple=True)
        w = t[p, s, r]
        c = self.cols[p, s].to(torch.int64)
        rows, cols = [], []
        for b in range(TILE):
            hit = ((w >> b) & 1) != 0
            rows.append(p[hit] * TILE + r[hit])
            cols.append(c[hit] * TILE + b)
        rows = torch.cat(rows).cpu().numpy().astype(np.int64)
        cols = torch.cat(cols).cpu().numpy().astype(np.int64)
        return rows, cols, np.ones(len(rows), np.float32)

    def to_ell(self) -> ELL:
        """Cached ELL materialization — the fallback target for weighted
        semirings. Counted once: the bit-tiles leave the device to rebuild
        the padded neighbor lists."""
        if self._ell is None:
            xfer.record("bitadj_materialize")
            r, c, v = self.to_coo()
            self._ell = ELL.from_coo(r, c, v, self.shape, device=self.device)
        return self._ell

    def to_dense(self) -> torch.Tensor:
        return self.to_ell().to_dense()

    def transpose(self) -> "BitELL":
        r, c, _ = self.to_coo()
        return BitELL.from_coo(c, r, None, (self.shape[1], self.shape[0]),
                               device=self.device)


# ---------------------------------------------------------------------------
# or_and word product — the plain version of kernels.bitadj_mxv
# ---------------------------------------------------------------------------
def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR reduction over one dimension (torch has none): halve the
    dimension with ``|`` until one slice is left."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        rest = x[2 * h:]
        x = torch.cat([x[:h] | x[h:2 * h], rest]) if rest.numel() else \
            x[:h] | x[h:2 * h]
    return x[0]


def _pad_query_tiles(Xw: torch.Tensor, k: int) -> torch.Tensor:
    """(>=k, W) packed frontier words -> (C+1, 32, W) query tiles: rows
    squared up to the column-tile grid (truncated first) plus one all-zero
    sentinel tile that empty slots (cols == C) gather harmlessly."""
    C = max(-(-k // TILE), 1)
    Xw = Xw[:min(Xw.shape[0], C * TILE)]
    out = torch.zeros(((C + 1) * TILE, Xw.shape[1]), dtype=Xw.dtype,
                      device=Xw.device)
    out[:Xw.shape[0]] = Xw
    return out.reshape(C + 1, TILE, Xw.shape[1])


def panels_mxm_words(tiles: torch.Tensor, cols: torch.Tensor,
                     Xw: torch.Tensor, k: int,
                     slot_chunk: int = 8) -> torch.Tensor:
    """Yw[p*32+r] = OR over slots s and bits b with tiles[p,s,r] bit b set
    of Xw[cols[p,s]*32 + b]. Slot chunking bounds the (P, sc, 32, 32, W)
    bit-spread intermediate."""
    Pn, Sn, _ = tiles.shape
    W = Xw.shape[1]
    Xt = _pad_query_tiles(Xw, k)                       # (C+1, 32, W)
    shifts = torch.arange(TILE, dtype=torch.int32, device=tiles.device)
    acc = torch.zeros((Pn, TILE, W), dtype=torch.int32, device=tiles.device)
    for s0 in range(0, Sn, slot_chunk):
        tc = tiles[:, s0:s0 + slot_chunk]              # (P, sc, 32)
        cc = cols[:, s0:s0 + slot_chunk].long()        # (P, sc)
        G = Xt[cc]                                     # (P, sc, 32, W)
        bits = (tc[:, :, :, None] >> shifts) & 1       # (P, sc, 32r, 32b)
        term = G[:, :, None, :, :] & -bits[..., None]  # (P, sc, 32r, 32b, W)
        acc |= _or_reduce(_or_reduce(term, 3), 1)
    return acc.reshape(Pn * TILE, W)


def mxm_words(b: BitELL, Xw: torch.Tensor) -> torch.Tensor:
    """(k-rows, W) packed frontier words -> (n, W) result words."""
    return panels_mxm_words(b.tiles, b.cols, Xw, b.shape[1])[:b.shape[0]]


# ---------------------------------------------------------------------------
# reductions and triangles straight off the bit-tiles (XLA in the JAX
# package, no kernel there either)
# ---------------------------------------------------------------------------
_CHUNK_WORDS = 1 << 24    # words per chunk of the bit-spread intermediates


def reduce_stored(s: BitELL, monoid, axis,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """plus / or reduction over the stored structure (SWAR popcounts,
    counted in int64, never materialized); ``dtype`` out, float32 as in the
    JAX package. ``or`` is "any stored entry". Panels are counted a chunk
    at a time: the popcount's int64 temporaries over every tile at once
    (6.2 GB of them a Graph500 scale-18 handle) outgrow the card."""
    tiles, cols = s.tiles, s.cols
    n, k = s.shape
    C = -(-k // TILE)
    Pn, Sn, _ = tiles.shape
    if axis == 0:
        shifts = torch.arange(TILE, dtype=torch.int32, device=tiles.device)
        seg = torch.zeros((C + 1, TILE), dtype=torch.int64,
                          device=tiles.device)          # sentinel bucket C
        step = max(1, _CHUNK_WORDS // max(Sn * TILE * TILE, 1))
        for p0 in range(0, Pn, step):
            bits = (tiles[p0:p0 + step, :, :, None] >> shifts) & 1
            seg.index_add_(0, cols[p0:p0 + step].reshape(-1).long(),
                           bits.sum(dim=2).reshape(-1, TILE).long())
        out = seg[:C].reshape(-1)[:k]
    else:
        step = max(1, _CHUNK_WORDS // max(Sn * TILE, 1))
        per = torch.cat([bitmap.popcount(tiles[p0:p0 + step]).sum(dim=1)
                         for p0 in range(0, Pn, step)])  # (P, 32) rows
        out = per.reshape(-1)[:n] if axis == 1 else per.sum()
    return (out > 0).to(dtype) if monoid.name == "or" else out.to(dtype)


def triangle_count(s: BitELL, slot_chunk: int = 4) -> torch.Tensor:
    """Triangles of a symmetric structural adjacency as AND + popcount over
    tile pairs: for every stored edge bit (i, j) the common-neighbour count
    is the popcount of ``rowbits[i] & rowbits[j]`` summed over column tiles
    (the masked plus_pair product the float route runs), and the total
    divides by 6. Counts in int64; returns the float64 quotient, exact
    (the JAX package sums in float32)."""
    tiles, cols = s.tiles, s.cols
    n, k = s.shape
    if n != k:
        raise ValueError("triangle_count needs a square adjacency")
    dev = tiles.device
    Pn, Sn, _ = tiles.shape
    C = -(-k // TILE)
    # row bits: Brows[p, r, c] = the 32 column bits of row p*32+r in column
    # tile c (each panel holds a column tile in at most one slot; sentinel
    # slots land in the dropped bucket C)
    Brows = torch.zeros((Pn, C + 1, TILE), dtype=torch.int32, device=dev)
    Brows[torch.arange(Pn, device=dev)[:, None].expand(Pn, Sn),
          cols.long()] = tiles
    Brows = Brows[:, :C].transpose(1, 2).contiguous()     # (P, 32, C)
    # neighbour-row panels gather by the slot's column tile (square: column
    # tile c is row panel c); sentinel slots hit an all-zero panel
    Bpad = torch.cat([Brows, torch.zeros((max(C + 1 - Pn, 1), TILE, C),
                                         dtype=torch.int32, device=dev)])
    shifts = torch.arange(TILE, dtype=torch.int32, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    step = max(1, _CHUNK_WORDS // (slot_chunk * TILE * TILE * max(C, 1)))
    for p0 in range(0, Pn, step):
        rows = Brows[p0:p0 + step]
        for s0 in range(0, Sn, slot_chunk):
            tc = tiles[p0:p0 + step, s0:s0 + slot_chunk]     # (p, sc, 32)
            G = Bpad[cols[p0:p0 + step, s0:s0 + slot_chunk].long()]
            inter = bitmap.popcount(rows[:, None, :, None, :]
                                    & G[:, :, None, :, :]).sum(dim=-1)
            bits = (tc[:, :, :, None] >> shifts) & 1      # (p, sc, 32r, 32b)
            acc += (inter.long() * bits).sum()
    return acc.to(torch.float64) / 6.0


# ---------------------------------------------------------------------------
# ShardedBitELL — the mesh twin behind grb.distribute
# ---------------------------------------------------------------------------
class ShardedBitELL(_shard.OnMesh):
    """BitELL panels sharded over the mesh's "data" axis (see module doc).

    ``local`` holds one shard-local BitELL per position (``p_pad / data``
    panels, shape (panels * 32, k)); p_pad rounds the panel count up to a
    multiple of the "data" axis, the extra panels all-sentinel. Built by
    :meth:`from_bitell` (grb.distribute); transpose_a is always served from
    the linked twin grb.distribute builds: there is no transposed
    bit-scatter lowering. ``tiles`` / ``cols`` assemble the padded arrays
    on the mesh's first device."""
    __slots__ = ("shape", "mesh", "local", "nnz", "p_pad", "_ell2d")

    def __init__(self, shape, mesh, local, nnz):
        self.shape = tuple(shape)
        self.mesh = _shard._check_mesh(mesh)
        self.local = local
        self.nnz = int(nnz)
        self.p_pad = int(local[0].n_panels) * mesh.shape[_shard.ROW_AXIS]
        self._ell2d = None          # cached ShardedELL materialization

    @classmethod
    def from_bitell(cls, b: BitELL, mesh) -> "ShardedBitELL":
        """Pad the panels to the "data" axis (padding panels all-sentinel,
        cols = n_ctiles) and place them on the mesh; each shard's kernel
        forms are built here, once. Blocks on the BitELL's own device are
        views of it when no padding is needed."""
        from repro_torch.core import semiring as S
        _shard._check_mesh(mesh)
        dsz = mesh.shape[_shard.ROW_AXIS]
        Pn = b.tiles.shape[0]
        p_pad = Pn + (-Pn) % dsz
        t = _shard._pad_rows(b.tiles, p_pad)
        c = _shard._pad_rows(b.cols, p_pad, fill=b.n_ctiles)
        k = b.shape[1]

        def shard_of(tl, cl):
            sh = BitELL(shape=(tl.shape[0] * TILE, k), tiles=tl, cols=cl,
                        nnz=0)
            sh.nnz = int(reduce_stored(sh, S.PLUS, None, torch.float64))
            return sh

        local = _shard.local_map(shard_of, _shard.row_blocks(mesh, t),
                                 _shard.row_blocks(mesh, c))
        for sh in {id(x): x for x in local}.values():
            sh.slot_plan()                  # with occupied_first, cached
        return cls(b.shape, mesh, local, nnz=b.nnz)

    # -- mesh geometry (data_size, frontier_size, device: shard.OnMesh) -----
    @property
    def n_ctiles(self) -> int:
        return -(-self.shape[1] // TILE)

    @property
    def n_slots(self) -> int:
        return self.local[0].n_slots

    @property
    def payload_bytes(self) -> int:
        return self.p_pad * self.n_slots * (TILE + 1) * 4

    @property
    def tiles(self) -> torch.Tensor:
        return self._global("tiles")

    @property
    def cols(self) -> torch.Tensor:
        return self._global("cols")

    # -- gathering conversions (counted) -------------------------------------
    def to_bitell(self) -> BitELL:
        """Gather the panel shards back to one BitELL on the mesh's first
        device (drops padding panels). Counted like ShardedELL.to_ell."""
        xfer.record("bitadj_gather")
        Pn = max(-(-self.shape[0] // TILE), 1)
        return BitELL(shape=self.shape, tiles=self.tiles[:Pn].contiguous(),
                      cols=self.cols[:Pn].contiguous(), nnz=self.nnz)

    def to_ell(self) -> ELL:
        return self.to_bitell().to_ell()

    def to_dense(self) -> torch.Tensor:
        return self.to_ell().to_dense()

    def to_coo(self):
        return self.to_bitell().to_coo()

    def transpose(self) -> "ShardedBitELL":
        return ShardedBitELL.from_bitell(self.to_bitell().transpose(),
                                         self.mesh)

    def materialize_sharded(self):
        """Cached ShardedELL on the same mesh: the sharded fallback target
        for weighted semirings, ewise and assign / extract (one counted
        gather to rebuild neighbour lists, then on the mesh again)."""
        if self._ell2d is None:
            self._ell2d = _shard.ShardedELL.from_ell(self.to_ell(),
                                                     self.mesh)
        return self._ell2d

    def __repr__(self) -> str:
        n, k = self.shape
        axes = "x".join(f"{a}:{self.mesh.shape[a]}"
                        for a in self.mesh.axis_names)
        return (f"ShardedBitELL {n}x{k} mesh=({axes}) nnz={self.nnz} "
                f"slots={self.n_slots}")


def sharded_mxm_words(s: ShardedBitELL, Xw: torch.Tensor) -> torch.Tensor:
    """Row-form or_and mxm on the mesh with a packed frontier: one word
    all-gather of Xw over "data" per call, then the word product on each
    panel block (the ``bitadj_mxv_packed`` kernel on a CUDA shard). Words
    in, words out: what grb.mxm_words dispatches to."""
    from repro_torch.distr import graph2d
    n, k = s.shape
    Xp = _shard._pad_words(s, Xw, k)
    fn = graph2d.bit_mxm_2d(s.mesh, s.n_slots, k)
    Y = fn(s.local, Xp)
    return Y[:n, :Xw.shape[1]]


def sharded_reduce_stored(s: ShardedBitELL, monoid, axis,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """plus / or reduction over the sharded bit-tiles: each shard counts
    its panels (``reduce_stored``, float64), per-row counts are
    concatenated, full and per-column counts psum over "data"."""
    from repro_torch.core import semiring as S
    from repro_torch.distr import mesh as M
    parts = _shard.local_map(
        lambda b: reduce_stored(b, S.PLUS, axis, torch.float64), s.local)
    if axis == 1:
        out = M.unshard(s.mesh, parts, ("data",))[:s.shape[0]]
    else:
        out = M.unshard(s.mesh, M.psum(s.mesh, parts, "data"), ())
    return (out > 0).to(dtype) if monoid.name == "or" else out.to(dtype)

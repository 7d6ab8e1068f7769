"""Op lowerings for the row-sharded ELL / BitELL layouts, with explicit
collectives.

Port of the op half of ``repro.distr.graph2d``. Layout:

  * adjacency rows (ELL rows, BitELL panels) -> the "data" axis; the pods
    replicate the graph,
  * frontier / query columns F -> ("pod", "model"),
  * between hops each row shard owns the frontier rows it produced; an
    all-gather over "data" rebuilds the whole frontier for the next
    gather.

Each factory returns a callable over the shards' local handles (a list per
mesh position, ``core.shard.ShardedELL.local`` /
``core.bitadj.ShardedBitELL.local``) and a global operand on the mesh's
first device, and gives back the global result there. The body runs once
per position, on the position's device, between the ``distr.mesh``
collectives: the row form all-gathers the frontier and runs the local
gather-reduce; with ``packed=True`` (or_and) both sides of the collective
carry ``core.bitmap`` words and the local product is ``grb.mxm_words`` on
the shard-local handle, which launches the ``ell_mxv_packed`` /
``bitadj_mxv_packed`` kernel on a CUDA shard (the JAX package runs its XLA
references here, ``core.ops.ell_mxm_packed`` and
``core.bitadj.panels_mxm_words``). The transposed form scatters its
edges' contributions over all output rows and psum_scatters the row
blocks (pmin / pmax and a slice by ``axis_index`` for the tropical
semirings; summable nibble words when packed, up to
``bitmap.NIBBLE_MAX_SHARDS`` row shards, full float partials past it).
The float row form, the scatters, the reductions and the merges are plain
torch in both packages (XLA there, no Pallas kernel).

Factories are lru-cached per (mesh, semiring, direction, packing), as the
JAX package caches its jitted shard_maps; the per-shard handles and their
kernel forms are built once, when the storage is distributed. Inputs
arrive padded to the mesh (``core.shard`` owns that); a mis-padded
``out_rows`` or a packed call on a non-indicator semiring raise
ValueError / NotImplementedError.

The probes ``khop_counts_2d`` and ``pagerank_2d`` run a whole k-hop count
or PageRank loop over global (indices, mask) ELL rows, sharded by
``shardings_2d`` / ``pagerank_specs_2d``: per hop one all-gather of the
frontier over "data" and a local pull on each position. The packed k-hop
pull is ``grb.mxm_words`` on a shard-local ELL built once per call, so a
CUDA position launches ``ell_mxv_packed`` once a hop; the int8 pull and
PageRank's gather-sum are plain torch in row chunks, as in the JAX
package (XLA there). ``input_specs_2d`` / ``pagerank_specs_2d`` give the
inputs as meta tensors, which ``launch.dryrun`` shards for its layout
accounting. The JAX package's ``scan_host_transfers`` reads XLA HLO and
has no counterpart: the port holds its sharded loops to
``core.xfer.host_transfers()`` instead.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import bitmap
from repro_torch.core import ops as _core_ops
from repro_torch.core import semiring as S
from repro_torch.core.ell import ELL
from repro_torch.core.shard import frontier_spec as _fr_spec
from repro_torch.core.shard import local_map
from repro_torch.distr import mesh as M
from repro_torch.distr.mesh import Mesh


def ell_shard_inputs(A, sentinel: bool = False):
    """(indices, mask) host arrays of the row-sharded ELL layout.

    Accepts a Relation, a GBMatrix or raw ELL storage. A Relation resolves
    to its stored transpose (the pull layout); pass a GBMatrix (``rel.A`` /
    ``rel.A.T``) to pick a direction. With sentinel=True, padded slots
    index the all-zero row (id = shape[1]) instead of carrying the mask."""
    if hasattr(A, "A") and hasattr(A, "name"):   # Relation -> pull layout
        A = A.A.T
    store = getattr(A, "store", A)               # GBMatrix -> storage
    if not hasattr(store, "indices"):
        raise TypeError(f"2D sharding needs ELL rows, got "
                        f"{type(store).__name__}")
    idx = store.indices.cpu().numpy()
    msk = store.mask.cpu().numpy()
    if sentinel:
        idx = np.where(msk, idx, store.shape[1]).astype(np.int32)
    return idx, msk


def _words(local, xg):
    from repro_torch.core import grb                 # lazy: grb reads shard
    return grb.mxm_words(local, xg)


def _entries(e):
    """(rows, cols, values) of a shard's valid slots, row-major."""
    r, s = torch.nonzero(e.mask, as_tuple=True)
    return r, e.indices[r, s].long(), e.values[r, s]


# ---------------------------------------------------------------------------
# reusable op lowerings — what grb dispatches sharded GBMatrix ops to
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def mxm_2d(mesh: Mesh, sr: S.Semiring, transposed: bool = False,
           out_rows: int = 0, packed: bool = False):
    """One semiring matmul over the mesh: (local, x) -> y.

    Row form (transposed=False): y = A (x) x. ``local`` holds A's row
    blocks; x is the (col_pad, F_pad) frontier, rows over "data", F over
    pod x model. One all-gather of x over "data", then each position runs
    the local product on its rows: ``core.ops.ell_mxm``, or with
    packed=True the word product ``grb.mxm_words`` (the ``ell_mxv_packed``
    kernel on a CUDA shard).

    Transposed form: y = A^T (x) x with no stored transpose: x rides A's
    row shards, each position accumulates its edges' contributions over
    all ``out_rows`` output rows (A's column count, padded), and a
    psum_scatter over "data" hands every position its row block (pmin /
    pmax and a local slice for the min / max add monoids). Packed: the
    partial bits are re-packed into nibble words (8 lanes a word) so the
    psum_scatter carries 8x fewer bytes with no carries, while at most
    ``bitmap.NIBBLE_MAX_SHARDS`` shards add into a lane; past that the
    body psum_scatters the float partial counts instead (same word-in /
    word-out signature, same bits).
    """
    fr = _fr_spec(mesh)
    spec = ("data", fr)
    dsz = mesh.shape["data"]
    if packed and sr.mode != "dot_indicator":
        raise NotImplementedError(
            f"packed mxm_2d is or_and/any_pair only (mode dot_indicator); "
            f"got {sr.mode}")
    if transposed and (out_rows <= 0 or out_rows % dsz):
        raise ValueError(f"transposed mxm_2d needs out_rows padded to "
                         f"the data axis ({dsz}); got {out_rows}")

    if not transposed:
        def run(local, x):
            xg = M.all_gather(mesh, M.shard(mesh, x, spec), "data")
            if packed:
                ys = [_words(e, xi) for e, xi in zip(local, xg)]
            else:
                ys = [_core_ops.ell_mxm(e, xi, sr)
                      for e, xi in zip(local, xg)]
            return M.unshard(mesh, ys, spec)
        return run

    if packed:
        nibble_ok = dsz <= bitmap.NIBBLE_MAX_SHARDS

        def run(local, xw):
            # edge (i -> j) at local row i ORs x's words at row i into
            # output row j; the cross-shard combine rides an add
            # collective: local words -> per-bit partial counts -> bits
            # -> nibble words -> psum_scatter -> saturate
            parts = []
            for e, xw_l in zip(local, M.shard(mesh, xw, spec)):
                fl = xw_l.shape[1] * bitmap.WORD_BITS
                bits = bitmap.unpack(xw_l, fl)          # (rows_l, fl)
                r, c, _ = _entries(e)
                part = torch.zeros((out_rows, fl), dtype=torch.float32,
                                   device=bits.device)
                part.index_add_(0, c, bits[r])
                parts.append(part)
            if nibble_ok:
                nib = [bitmap.pack_nibbles(p > 0).to(torch.int64)
                       & 0xFFFFFFFF for p in parts]
                tot = M.psum_scatter(mesh, nib, "data")
                own = [bitmap.unpack_nibbles(t, p.shape[1])
                       for t, p in zip(tot, parts)]
            else:
                own = [t > 0 for t in M.psum_scatter(mesh, parts, "data")]
            return M.unshard(mesh, [bitmap._pack_words(o) for o in own],
                             spec)
        return run

    if sr.mode == "bcast":
        how = "amin" if sr.add.name == "min" else "amax"
        # an empty segment holds the dtype's extreme, as segment_min / max
        fill = np.inf if how == "amin" else -np.inf

    def run(local, x):
        parts = []
        for e, x_l in zip(local, M.shard(mesh, x, spec)):
            r, c, w = _entries(e)
            xg = x_l[r]                                # (entries, F_l)
            w = w[:, None]
            if sr.mode == "dot":
                term = w * xg
            elif sr.mode in ("dot_indicator", "dot_pair"):
                term = (xg != 0).to(torch.float32)
            elif sr.mode == "dot_first":
                term = torch.where(xg != 0, w, torch.zeros_like(xg))
            elif sr.mode == "bcast":
                term = sr.mul(w, xg).to(torch.float32)
            else:
                raise NotImplementedError(sr.mode)
            if sr.mode == "bcast":
                part = torch.full((out_rows, x_l.shape[1]), fill,
                                  dtype=torch.float32, device=x_l.device)
                part.scatter_reduce_(0, c[:, None].expand_as(term).contiguous(),
                                     term, reduce=how, include_self=True)
            else:
                part = torch.zeros((out_rows, x_l.shape[1]),
                                   dtype=torch.float32, device=x_l.device)
                part.index_add_(0, c, term)
            parts.append(part)
        if sr.mode == "bcast":
            full = (M.pmin if how == "amin" else M.pmax)(mesh, parts, "data")
            step = out_rows // dsz
            ys = [f.narrow(0, k * step, step)
                  for f, k in zip(full, M.axis_index(mesh, "data"))]
        else:
            ys = M.psum_scatter(mesh, parts, "data")
            if sr.mode == "dot_indicator":
                ys = [(y > 0).to(torch.float32) for y in ys]
        return M.unshard(mesh, ys, spec)
    return run


@functools.lru_cache(maxsize=None)
def bit_mxm_2d(mesh: Mesh, slots: int, k: int):
    """or_and matmul on ShardedBitELL panels: (local, xw) -> yw.

    Both the adjacency (32x32 bit tiles, panels over "data") and the
    frontier (words, rows over "data", words over pod x model) are packed:
    the per-hop all-gather over "data" carries words, and the local
    product is ``grb.mxm_words`` on the shard-local BitELL (the
    ``bitadj_mxv_packed`` kernel on a CUDA shard). ``k`` is A's logical
    column count; gathered rows past the column-tile grid are zero. The
    output is (p_pad * 32, W) words; padding panels are all-sentinel and
    render zero. Cached per (mesh, slot width, k)."""
    del slots, k     # cache key: the local handles carry their shapes
    fr = _fr_spec(mesh)
    spec = ("data", fr)

    def run(local, xw):
        xg = M.all_gather(mesh, M.shard(mesh, xw, spec), "data")
        return M.unshard(mesh, [_words(b, x) for b, x in zip(local, xg)],
                         spec)
    return run


@functools.lru_cache(maxsize=None)
def reduce_2d(mesh: Mesh, monoid_name: str, axis, ncols: int):
    """Stored-entry plus / or reduction over the mesh: local -> out,
    accumulated in float64 (the port's unsharded reduce does the same).

    axis=1 (per row) is collective-free: rows live whole on one shard.
    The full (axis=None) and per-column (axis=0) reductions psum partials
    over "data" and return the replicated result. "or" reduces indicator
    counts and renders any-stored (> 0)."""
    if monoid_name not in ("plus", "or"):
        raise NotImplementedError(monoid_name)

    def body(e):
        w = (e.values * e.mask).to(torch.float64)
        if monoid_name == "or":
            w = (w != 0).to(torch.float64)
        if axis == 1:
            return w.sum(dim=1)
        if axis is None:
            return w.sum()
        ids = torch.where(e.mask, e.indices, ncols).reshape(-1).long()
        out = torch.zeros(ncols + 1, dtype=torch.float64, device=w.device)
        return out.index_add_(0, ids, w.reshape(-1))[:ncols]

    def run(local):
        parts = local_map(body, local)
        if axis == 1:
            out = M.unshard(mesh, parts, ("data",))
        else:
            out = M.unshard(mesh, M.psum(mesh, parts, "data"), ())
        if monoid_name == "or":
            out = (out > 0).to(torch.float64)
        return out
    return run


# ---------------------------------------------------------------------------
# shard-local element-wise lowerings — the slot-aligned COO set algebra of
# grb's sharded ewise / assign / extract (no collectives: rows live whole on
# one shard, so union / intersect / mask surgery is row-local)
# ---------------------------------------------------------------------------
# sort key of invalid slots; real keys are col*2 + source, so this is out of
# reach for any column count below ~2^30 (the int32 indices cap columns first)
_MERGE_SENT = int(np.iinfo(np.int32).max)


def _ewise_merge(ia, ma, va, ib, mb, vb, mode, op):
    """Row-local merge of two ELL row blocks into one (idx, mask, val).

    The slot-alignment pass: concatenate the two slot layouts (width
    wa+wb), sort each row by (column, source) (source breaks ties, so an A
    entry always precedes its B partner at the same column) and pair
    adjacent equal columns. Each side stores at most one entry per (row,
    col), so runs of equal columns have length <= 2 and one shifted
    compare finds every pair.

    mode: "union"     op(a,b) where both, pass-through singletons (eWiseAdd)
          "intersect" op(a,b) where both, singletons dropped     (eWiseMult)
          "mask"      A entries where B stored (mask restrict)
          "mask_c"    A entries where B absent (complemented restrict)

    Zero results are dropped (stored == nonzero)."""
    rows, wa = ia.shape
    dev = ia.device
    col = torch.cat([ia, ib], dim=1).to(torch.int32)
    src = torch.cat([torch.zeros((rows, wa), dtype=torch.int32, device=dev),
                     torch.ones((rows, ib.shape[1]), dtype=torch.int32,
                                device=dev)], dim=1)
    valid_in = torch.cat([ma, mb], dim=1)
    val = torch.cat([va, vb], dim=1).to(torch.float32)
    key = torch.where(valid_in, col * 2 + src,
                      torch.full_like(col, _MERGE_SENT))
    key, order = torch.sort(key, dim=1, stable=True)
    col, src, val = col.gather(1, order), src.gather(1, order), \
        val.gather(1, order)
    valid = key != _MERGE_SENT
    same = valid[:, :-1] & valid[:, 1:] & (col[:, :-1] == col[:, 1:])
    no = torch.zeros((rows, 1), dtype=torch.bool, device=dev)
    pair_first = torch.cat([same, no], dim=1)      # slot i pairs with i+1
    pair_second = torch.cat([no, same], dim=1)
    val_nxt = torch.cat([val[:, 1:], torch.zeros((rows, 1),
                                                  dtype=val.dtype,
                                                  device=dev)], dim=1)
    if mode == "union":
        out_val = torch.where(pair_first, op(val, val_nxt), val)
        out_ok = valid & ~pair_second
    elif mode == "intersect":
        out_val = op(val, val_nxt)
        out_ok = pair_first
    elif mode == "mask":
        out_val = val
        out_ok = pair_first                        # slot i is the A entry
    elif mode == "mask_c":
        out_val = val
        out_ok = valid & (src == 0) & ~pair_first
    else:
        raise ValueError(f"unknown merge mode {mode!r}")
    out_val = torch.as_tensor(out_val, dtype=torch.float32, device=dev)
    out_ok = out_ok & (out_val != 0)
    return (torch.where(out_ok, col, torch.zeros_like(col)), out_ok,
            torch.where(out_ok, out_val, torch.zeros_like(out_val)))


@functools.lru_cache(maxsize=None)
def ewise_2d(mesh: Mesh, mode: str, op):
    """Shard-local element-wise merge over the mesh: (local_a, local_b) ->
    per-position (idx, mask, val) row blocks. No collectives. Cached per
    (mesh, mode, op)."""
    def run(la, lb):
        return local_map(
            lambda a, b: _ewise_merge(a.indices, a.mask, a.values,
                                      b.indices, b.mask, b.values, mode, op),
            la, lb)
    return run


@functools.lru_cache(maxsize=None)
def restrict_dense_2d(mesh: Mesh, complement: bool):
    """Keep stored entries where a dense (n_pad, m) mask row block is
    nonzero (or zero, complemented): one shard-local gather, the dense-mask
    side of the descriptor blend."""
    def body(e, dm_l):
        keep = (dm_l != 0).gather(1, e.indices.long())
        if complement:
            keep = ~keep
        m = e.mask & keep
        return (torch.where(m, e.indices, torch.zeros_like(e.indices)), m,
                torch.where(m, e.values, torch.zeros_like(e.values)))

    def run(local, dm):
        return local_map(body, local, M.shard(mesh, dm, ("data", None)))
    return run


@functools.lru_cache(maxsize=None)
def extract_cols_2d(mesh: Mesh):
    """Column-subset extract: relabel stored columns through a replicated
    (m,) LUT (new column id, or -1 to drop). Row-local."""
    def body(e, lut):
        nc = lut[e.indices.long()]
        m = e.mask & (nc >= 0)
        return (torch.where(m, nc, torch.zeros_like(nc)).to(torch.int32), m,
                torch.where(m, e.values, torch.zeros_like(e.values)))

    def run(local, lut):
        return local_map(body, local, M.shard(mesh, lut, (None,)))
    return run


@functools.lru_cache(maxsize=None)
def reduce_minmax_2d(mesh: Mesh, monoid_name: str, axis, nrows: int,
                     ncols: int):
    """min / max reduction with dense semantics on the mesh: absent
    entries render as 0 and take part. Stored entries reduce under a +/-inf
    identity; one stored-count compare folds the implicit zeros back in.
    axis=1 is collective-free; axis=0 / None combine the shards with pmin
    / pmax and a psum of stored counts. nrows / ncols are the logical
    shape: padded rows are all mask-false and give only the identity."""
    if monoid_name not in ("min", "max"):
        raise NotImplementedError(monoid_name)
    big = float(np.inf if monoid_name == "min" else -np.inf)
    comb = torch.minimum if monoid_name == "min" else torch.maximum
    how = "amin" if monoid_name == "min" else "amax"
    pcomb = M.pmin if monoid_name == "min" else M.pmax

    def red(w, dim=None):
        if monoid_name == "min":
            return w.amin() if dim is None else w.amin(dim=dim)
        return w.amax() if dim is None else w.amax(dim=dim)

    def stored(e):
        return torch.where(e.mask, e.values, torch.full_like(e.values, big))

    def body(e):
        w = stored(e)
        if axis == 1:
            st = red(w, 1) if w.shape[1] else torch.full(
                (w.shape[0],), big, device=w.device)
            absent = e.mask.sum(dim=1) < ncols
            return torch.where(absent, comb(st, torch.zeros_like(st)), st)
        if axis is None:
            return (red(w) if w.numel() else torch.tensor(big,
                                                          device=w.device),
                    e.mask.sum())
        ids = torch.where(e.mask, e.indices, ncols).reshape(-1).long()
        part = torch.full((ncols + 1,), big, dtype=torch.float32,
                          device=w.device)
        part.scatter_reduce_(0, ids, w.reshape(-1), reduce=how,
                             include_self=True)
        cnt = torch.zeros(ncols + 1, dtype=torch.int64, device=w.device)
        cnt.index_add_(0, ids, e.mask.reshape(-1).to(torch.int64))
        return part[:ncols], cnt[:ncols]

    def run(local):
        parts = local_map(body, local)
        if axis == 1:
            return M.unshard(mesh, parts, ("data",))
        st = M.unshard(mesh, pcomb(mesh, [p[0] for p in parts], "data"), ())
        total = M.unshard(mesh, M.psum(mesh, [p[1] for p in parts], "data"),
                          ())
        full = nrows * ncols if axis is None else nrows
        return torch.where(total < full, comb(st, torch.zeros_like(st)), st)
    return run


# ---------------------------------------------------------------------------
# the probes: whole k-hop / PageRank loops over the row-sharded ELL layout
# ---------------------------------------------------------------------------
_META = torch.device("meta")


def input_specs_2d(n: int, max_deg: int, f: int):
    """Meta stand-ins for the k-hop probe's inputs: indices (n, max_deg)
    int32, mask (n, max_deg) bool, one-hot seeds (n, f) int8."""
    return (torch.empty((n, max_deg), dtype=torch.int32, device=_META),
            torch.empty((n, max_deg), dtype=torch.bool, device=_META),
            torch.empty((n, f), dtype=torch.int8, device=_META))


def shardings_2d(mesh: Mesh, n: int, max_deg: int, f: int):
    """The k-hop probe's input specs (``distr.mesh.shard`` entries): rows
    over "data", the frontier's F over the frontier axes."""
    del n, max_deg, f
    return (("data", None), ("data", None), ("data", _fr_spec(mesh)))


def pagerank_specs_2d(mesh: Mesh, n: int, max_deg: int):
    """(specs, shardings) of the PageRank probe: the (n, max_deg) rows of
    A^T (each vertex's in-neighbours) and the (n,) float32 out-degrees,
    all over "data"."""
    del mesh
    specs = (torch.empty((n, max_deg), dtype=torch.int32, device=_META),
             torch.empty((n, max_deg), dtype=torch.bool, device=_META),
             torch.empty((n,), dtype=torch.float32, device=_META))
    return specs, (("data", None), ("data", None), ("data",))


def _row_chunk(deg: int, f: int) -> int:
    """Rows of one chunk of a gathered (rows, deg, f) block, bounded as
    ``core.ops.ell_mxm`` bounds its chunks."""
    return max(1, _core_ops._CHUNK_ENTRIES // max(deg * f, 1))


def _gather_max(idx, msk, x_full):
    """(rows, f) OR of ``x_full``'s 0/1 rows over each row's valid ids
    (``msk`` None: every id is valid), a chunk of rows at a time."""
    rows, deg = idx.shape
    out = torch.empty((rows, x_full.shape[1]), dtype=x_full.dtype,
                      device=x_full.device)
    step = _row_chunk(deg, x_full.shape[1])
    for r0 in range(0, rows, step):
        g = x_full[idx[r0:r0 + step].long()]            # (c, deg, f)
        if msk is not None:
            g.masked_fill_(~msk[r0:r0 + step, :, None], 0)
        out[r0:r0 + step] = g.amax(dim=1)
    return out


def _gather_sum(idx, msk, push):
    """(rows,) float32 sums of ``push`` over each row's valid ids, a chunk
    of rows at a time; a bfloat16 push converts inside the reduce."""
    rows, deg = idx.shape
    out = torch.empty((rows,), dtype=torch.float32, device=push.device)
    step = _row_chunk(deg, 1)
    for r0 in range(0, rows, step):
        g = push[idx[r0:r0 + step].long()]              # (c, deg)
        g.masked_fill_(~msk[r0:r0 + step], 0)
        out[r0:r0 + step] = g.sum(dim=1, dtype=torch.float32)
    return out


def _probe_ell(idx, msk, n: int, sentinel: bool):
    """A position's rows as a shard-local structural ELL over the gathered
    frontier's rows (n, and the zero row n with the sentinel)."""
    if sentinel:
        msk = idx < n
    return ELL(shape=(idx.shape[0], n + int(sentinel)), indices=idx,
               mask=msk, values=msk.to(torch.float32),
               nnz=int(msk.sum()))


def _zero_row(x):
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def int8_hop(idx, msk, x_full, visited):
    """One int8 k-hop step at a position: the rows' OR over the gathered
    frontier, and-not visited: (the next frontier, visited)."""
    nxt = _gather_max(idx, msk, x_full).masked_fill_(visited > 0, 0)
    return nxt, torch.maximum(visited, nxt)


def packed_hop(words, visited):
    """One packed k-hop step at a position, from the pull's words
    (``ell_mxv_packed``'s output): (the next frontier, visited)."""
    nxt = bitmap.word_andnot(words, visited)
    return nxt, bitmap.word_or(visited, nxt)


def column_counts(visited, packed: bool, f: int):
    """A position's visited rows counted a query (int32)."""
    if packed:
        return bitmap.reduce_or_columns(visited, f).to(torch.int32)
    return visited.sum(dim=0, dtype=torch.int32)


def pagerank_init(deg, n: int):
    """A position's (ranks, inverse out-degrees, dangling mask)."""
    r = torch.full(deg.shape, 1.0 / n, dtype=torch.float32,
                   device=deg.device)
    inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-30), 0.0)
    return r, inv, deg == 0


def pagerank_push(r, inv, push_dtype=None):
    push = r * inv
    return push if push_dtype is None else push.to(push_dtype)


def dangling_mass(dangling, r):
    return torch.where(dangling, r, 0.0).sum()


def pagerank_update(pulled, mass, alpha: float, n: int):
    return (1.0 - alpha) / n + alpha * (pulled + mass / n)


def khop_counts_2d(mesh: Mesh, n: int, k: int, packed: bool = False,
                   sentinel: bool = False):
    """``fn(indices, mask, frontier0) -> counts (F,)``: the vertices each
    query reaches in 1..k hops.

    indices / mask: the global (n, max_deg) ELL pull rows (each vertex's
    in-neighbours), sharded over "data"; frontier0: the (n, F) int8
    one-hot seeds, F over "pod" x "model" (``shardings_2d``). The counts
    land on ``mesh.home``.

    Per hop, as the JAX body: one all-gather of the frontier over "data",
    the local pull, and-not visited, or into visited; at the end a psum
    over "data" of each column's count, minus the seed. ``packed``: the
    frontier travels as ``core.bitmap`` words (32 queries a word) and the
    pull is ``grb.mxm_words`` on a shard-local ELL built once per call,
    which launches ``ell_mxv_packed`` on a CUDA position once a hop.
    ``sentinel``: padded slots hold id n, one all-zero row is appended to
    the gathered frontier, and the mask input is not read."""
    rows_spec, _, fr_spec = shardings_2d(mesh, n, 0, 0)
    out_spec = (fr_spec[1],)

    def run(indices, mask, frontier0):
        idx = M.shard(mesh, indices, rows_spec)
        msk = ([None] * mesh.size if sentinel
               else M.shard(mesh, mask, rows_spec))
        seeds = M.shard(mesh, frontier0, fr_spec)
        f_l = seeds[0].shape[1]
        if packed:
            local = local_map(lambda i, m: _probe_ell(i, m, n, sentinel),
                              idx, msk)
            frontier = [bitmap.pack(x) for x in seeds]
        else:
            frontier = seeds
        visited = frontier
        for _ in range(k):
            x_full = M.all_gather(mesh, frontier, "data")
            if sentinel:
                x_full = local_map(_zero_row, x_full)
            if packed:
                steps = [packed_hop(_words(e, x), v)
                         for e, x, v in zip(local, x_full, visited)]
            else:
                steps = [int8_hop(i, m, x, v)
                         for i, m, x, v in zip(idx, msk, x_full, visited)]
            frontier = [nxt for nxt, _ in steps]
            visited = [v for _, v in steps]
        counts = [column_counts(v, packed, f_l) for v in visited]
        counts = [c - 1 for c in M.psum(mesh, counts, "data")]
        return M.unshard(mesh, counts, out_spec)
    return run


def pagerank_2d(mesh: Mesh, n: int, iters: int, alpha: float = 0.85,
                push_dtype=None):
    """``fn(indices, mask, out_deg) -> ranks (n,)``: ``iters`` PageRank
    steps (plus_times) on the row-sharded pull layout
    (``pagerank_specs_2d``), the ranks on ``mesh.home``.

    Per iteration, as the JAX body: an all-gather over "data" of the push
    vector (rank over out-degree) in ``push_dtype`` (float32 when None),
    a masked gather-sum in float32 in row chunks, and a psum over "data"
    of the dangling vertices' mass. A bfloat16 push converts only inside
    the reduce, so the all-gather carries bfloat16."""
    def run(indices, mask, out_deg):
        idx = M.shard(mesh, indices, ("data", None))
        msk = M.shard(mesh, mask, ("data", None))
        deg = M.shard(mesh, out_deg, ("data",))
        r, inv, dangling = map(list, zip(*[pagerank_init(d, n)
                                           for d in deg]))
        for _ in range(iters):
            push = [pagerank_push(ri, vi, push_dtype)
                    for ri, vi in zip(r, inv)]
            full = M.all_gather(mesh, push, "data")
            pulled = [_gather_sum(i, m, p)
                      for i, m, p in zip(idx, msk, full)]
            mass = M.psum(mesh, [dangling_mass(dg, ri)
                                 for dg, ri in zip(dangling, r)], "data")
            r = [pagerank_update(pl, dm, alpha, n)
                 for pl, dm in zip(pulled, mass)]
        return M.unshard(mesh, r, ("data",))
    return run

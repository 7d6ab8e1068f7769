"""ShardedELL: row-sharded ELL storage behind the GBMatrix surface.

Port of ``repro.core.shard``. The same ELL (indices, mask, values) row
layout, laid out over a ``distr.mesh.Mesh`` instead of one device:

  * adjacency rows           -> the mesh's "data" axis (row blocks),
  * frontier/query columns F -> the "pod" x "model" axes,
  * padded rows (mask-false) square the row count up to a multiple of the
    "data" axis so every block divides evenly.

Each position of the mesh holds its row block as a shard-local ``ELL``
handle of shape (rows per block, columns padded to the "data" axis);
positions on one device with the same row block share one handle, so a
block replicated over "pod" x "model" is one set of tensors per device.
The handles built by ``from_ell`` carry their kernel forms
(``ELL.row_csr`` / ``ELL.item_plan``), built once here and read by the
``ell_mxv_packed`` kernel on every hop.

Storage lives here; the operations stay in ``grb``, which lowers them to
the explicit-collective bodies of ``distr.graph2d`` (one frontier
all-gather per hop in row form, a psum_scatter of row blocks in the
transposed form), so the algorithms and the executor run unchanged on a
mesh. ``apply`` / ``select`` are shard-local value maps; eWiseAdd / Mult,
mask restricts, column extract / assign and min / max reduce are
shard-local merges. Only cross-shard requests (row-subset extract /
assign, a mask on another mesh) gather, and every gather bumps
``core.xfer.host_transfers()``.

Construction needs a Mesh with a "data" axis (TypeError / ValueError
otherwise); ``to_ell`` / ``to_dense`` / ``to_coo`` / ``transpose`` gather
to the mesh's first device and are counted. The padded row block is an
internal detail: ``shape`` and ``nnz`` never include it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import bitmap, xfer
from repro_torch.core.ell import ELL
from repro_torch.distr import mesh as M
from repro_torch.distr.mesh import Mesh

ROW_AXIS = "data"                      # adjacency rows shard over this axis
FRONTIER_AXES = ("pod", "model")       # frontier columns shard over these


def frontier_axes(mesh: Mesh) -> tuple:
    """The mesh axes (in canonical order) that shard the frontier's F dim."""
    return tuple(a for a in FRONTIER_AXES if a in mesh.axis_names)


def frontier_spec(mesh: Mesh):
    """Spec entry for the frontier's F dimension on this mesh."""
    fr = frontier_axes(mesh)
    if not fr:
        return None
    return fr if len(fr) > 1 else fr[0]


def _check_mesh(mesh: Mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"ShardedELL needs a repro_torch.distr.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    if ROW_AXIS not in mesh.axis_names:
        raise ValueError(f"ShardedELL needs a mesh with a {ROW_AXIS!r} axis "
                         f"(rows shard over it); got axes {mesh.axis_names}")
    return mesh


def _padded(n: int, size: int) -> int:
    return n + (-n) % size


def _pad_rows(x: torch.Tensor, n_pad: int, fill=0) -> torch.Tensor:
    """x with its rows padded to n_pad by ``fill``; x itself (no copy)
    when it already has n_pad rows, so blocks on x's device are views."""
    if x.shape[0] == n_pad:
        return x.contiguous()
    out = torch.full((n_pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[:x.shape[0]] = x
    return out


def local_map(fn, *locals_: List) -> List:
    """``fn`` over per-position shard lists, once per distinct tuple of
    shards: positions that share their shards share the result."""
    cache: Dict[tuple, object] = {}
    out = []
    for objs in zip(*locals_):
        k = tuple(id(o) for o in objs)
        if k not in cache:
            cache[k] = fn(*objs)
        out.append(cache[k])
    return out


def row_blocks(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Per-position row blocks of a (n_pad, ...) tensor over "data",
    replicated over the other axes (one tensor per block and device)."""
    return M.shard(mesh, x, (ROW_AXIS,))


class OnMesh:
    """The mesh geometry the sharded stores share: ``mesh`` and ``local``
    (one shard-local handle per position, row blocks over "data")."""
    __slots__ = ()

    @property
    def data_size(self) -> int:
        return self.mesh.shape[ROW_AXIS]

    @property
    def frontier_size(self) -> int:
        """Number of shards the frontier's F dimension splits into."""
        return int(np.prod([self.mesh.shape[a]
                            for a in frontier_axes(self.mesh)] or [1]))

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def _global(self, attr: str) -> torch.Tensor:
        return M.unshard(self.mesh, [getattr(s, attr) for s in self.local],
                         (ROW_AXIS,))


class ShardedELL(OnMesh):
    """Row-sharded ELL storage over a mesh (see module doc).

    ``local`` holds one shard-local ELL per position (rows ``n_pad /
    data``, columns padded to the "data" axis); n_pad rounds the logical
    row count up to a multiple of the "data" axis size, the extra rows all
    mask-false. ``indices`` / ``mask`` / ``values`` assemble the padded
    (n_pad, max_deg) arrays on the mesh's first device."""
    __slots__ = ("shape", "mesh", "local", "nnz", "n_pad")

    def __init__(self, shape: Tuple[int, int], mesh: Mesh, local: List[ELL],
                 nnz: int):
        self.shape = tuple(shape)
        self.mesh = _check_mesh(mesh)
        self.local = local
        self.nnz = int(nnz)
        self.n_pad = int(local[0].shape[0]) * mesh.shape[ROW_AXIS]

    # -- construction --------------------------------------------------------
    @classmethod
    def from_blocks(cls, shape, mesh: Mesh, idx: List[torch.Tensor],
                    msk: List[torch.Tensor], val: List[torch.Tensor]
                    ) -> "ShardedELL":
        """From per-position row blocks (shared where the tensors are);
        nnz counts the mask of one block per row-block index."""
        local = _local_ells(mesh, shape, idx, msk, val)
        return cls(shape, mesh, local, nnz=_count(mesh, local))

    @classmethod
    def from_ell(cls, e: ELL, mesh: Mesh) -> "ShardedELL":
        """Pad the row block to the "data" axis and place it on the mesh;
        each shard's kernel forms are built here, once. Blocks on the
        ELL's own device are views of it when no padding is needed."""
        n_pad = _padded(e.shape[0], _check_mesh(mesh).shape[ROW_AXIS])
        local = _local_ells(mesh, e.shape, *(
            row_blocks(mesh, _pad_rows(x, n_pad))
            for x in (e.indices, e.mask, e.values)))
        for sh in {id(x): x for x in local}.values():
            sh.item_plan()                  # with its row_csr, cached
        return cls(e.shape, mesh, local, nnz=e.nnz)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, mesh: Mesh) -> "ShardedELL":
        return cls.from_ell(ELL.from_coo(rows, cols, vals, shape,
                                         device=_check_mesh(mesh).home), mesh)

    @classmethod
    def from_dense(cls, A, mesh: Mesh) -> "ShardedELL":
        A = A.cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
        r, c = np.nonzero(A)
        return cls.from_coo(r, c, A[r, c].astype(np.float32), A.shape, mesh)

    # -- mesh geometry -------------------------------------------------------
    @property
    def max_deg(self) -> int:
        return self.local[0].max_deg

    @property
    def indices(self) -> torch.Tensor:
        return self._global("indices")

    @property
    def mask(self) -> torch.Tensor:
        return self._global("mask")

    @property
    def values(self) -> torch.Tensor:
        return self._global("values")

    # -- gathering conversions (counted) -------------------------------------
    def to_ell(self) -> ELL:
        """Gather the row shards back to one ELL on the mesh's first
        device (drops padding). Counted: every conversion below routes
        through it, so each gather shows in grb.host_transfers()."""
        xfer.record("sharded_gather")
        n, m = self.shape
        return ELL(shape=(n, m), indices=self.indices[:n].contiguous(),
                   mask=self.mask[:n].contiguous(),
                   values=self.values[:n].contiguous(), nnz=self.nnz)

    def to_dense(self) -> torch.Tensor:
        return self.to_ell().to_dense()

    def to_coo(self):
        return self.to_ell().to_coo()

    def transpose(self) -> "ShardedELL":
        """Gathered transpose, re-sharded onto the same mesh. Relations
        link explicitly built transposes instead (grb.distribute), and the
        mxm path of an unlinked handle never calls this: the transposed
        (psum_scatter) lowering reads the forward rows."""
        return ShardedELL.from_ell(self.to_ell().transpose(), self.mesh)

    # -- local (collective-free) stored-entry ops ----------------------------
    def _with(self, fn) -> "ShardedELL":
        parts = local_map(lambda s: fn(s.indices, s.mask, s.values),
                          self.local)
        return ShardedELL.from_blocks(self.shape, self.mesh,
                                      [p[0] for p in parts],
                                      [p[1] for p in parts],
                                      [p[2] for p in parts])

    def apply_stored(self, f) -> "ShardedELL":
        """f over stored entries, zero results dropped, shard-local."""
        def body(idx, msk, val):
            v = torch.where(msk, f(val), torch.zeros_like(val))
            m = msk & (v != 0)
            return idx, m, torch.where(m, v, torch.zeros_like(v))
        return self._with(body)

    def select_stored(self, pred) -> "ShardedELL":
        """Stored entries passing pred, shard-local (mask surgery only)."""
        def body(idx, msk, val):
            m = msk & torch.as_tensor(pred(val), device=val.device) & \
                (val != 0)
            return idx, m, torch.where(m, val, torch.zeros_like(val))
        return self._with(body)

    def __repr__(self) -> str:
        n, m = self.shape
        axes = "x".join(f"{a}:{self.mesh.shape[a]}"
                        for a in self.mesh.axis_names)
        return (f"ShardedELL {n}x{m} mesh=({axes}) nnz={self.nnz} "
                f"max_deg={self.max_deg}")


def _local_ells(mesh: Mesh, shape, idx, msk, val) -> List[ELL]:
    """Shard-local ELL handles over per-position row blocks: rows of the
    block, columns padded to the "data" axis (the gathered frontier's
    rows in the row form, the output rows in the transposed form), each
    with its own stored-entry count."""
    ncols = _padded(int(shape[1]), mesh.shape[ROW_AXIS])
    return local_map(lambda i, m, v: ELL(shape=(i.shape[0], ncols),
                                         indices=i, mask=m, values=v,
                                         nnz=int(m.sum())),
                     idx, msk, val)


def _count(mesh: Mesh, local) -> int:
    """Stored entries: one shard per row-block index."""
    first = {}
    for i, d in enumerate(M.axis_index(mesh, ROW_AXIS)):
        first.setdefault(d, local[i])
    return sum(sh.nnz for sh in first.values())


# ---------------------------------------------------------------------------
# op execution: pad, run the graph2d lowering, slice — what grb dispatches to
# ---------------------------------------------------------------------------
def _pad2(x: torch.Tensor, r_pad: int, c_pad: int) -> torch.Tensor:
    if not (r_pad or c_pad):
        return x
    out = torch.zeros((x.shape[0] + r_pad, x.shape[1] + c_pad),
                      dtype=x.dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _pad_frontier(s: ShardedELL, X: torch.Tensor, x_rows: int):
    """Pad an (x_rows, F) frontier to the mesh-divisible (x_rows_pad, F_pad)
    float32 frontier on the mesh's first device."""
    X = X.to(device=s.mesh.home, dtype=torch.float32)
    return _pad2(X, (-x_rows) % s.data_size, (-X.shape[1]) % s.frontier_size)


def mxm(s: ShardedELL, X: torch.Tensor, sr, transposed: bool = False,
        packed: bool = False):
    """Y = A (x) X (or A^T (x) X) on the mesh. X: dense (k, F) global
    frontier (k = A's columns in row form, A's rows in transposed form);
    the result is the global (rows, F) tensor on the mesh's first device.

    packed=True (or_and only, set by grb's packing policy): X is packed
    and runs through :func:`mxm_words`, crossing the mesh as words, 32x
    fewer bytes in the row form's all-gather; the
    transposed form psum_scatters summable nibble words (8x) up to
    bitmap.NIBBLE_MAX_SHARDS row shards, past which graph2d.mxm_2d builds
    the unpacked psum_scatter body (same word signature)."""
    from repro_torch.distr import graph2d            # lazy: distr reads core
    if packed:
        if sr.mode != "dot_indicator":
            raise NotImplementedError(
                f"packed mxm_2d is or_and/any_pair only (mode "
                f"dot_indicator); got {sr.mode}")
        return bitmap.unpack(mxm_words(s, bitmap.pack(X.to(s.mesh.home)),
                                       transposed), X.shape[1])
    n, m = s.shape
    if transposed:
        fn = graph2d.mxm_2d(s.mesh, sr, transposed=True,
                            out_rows=_padded(m, s.data_size))
        Xp = _pad_frontier(s, X, n)                 # x rides A's row shards
        out_rows = m
    else:
        fn = graph2d.mxm_2d(s.mesh, sr)
        Xp = _pad_frontier(s, X, m)                 # x rows are A's columns
        out_rows = n
    Y = fn(s.local, Xp)
    return Y[:out_rows, :X.shape[1]]


def _pad_words(s, Xw: torch.Tensor, x_rows: int):
    """Pad an already-packed (x_rows, W) word frontier to the mesh: rows to
    the "data" axis, words to the frontier shard count (on the device)."""
    Xw = Xw.to(s.mesh.home)
    return _pad2(Xw, (-x_rows) % s.data_size, (-Xw.shape[1]) % s.frontier_size)


def mxm_words(s: ShardedELL, Xw: torch.Tensor, transposed: bool = False):
    """or_and mxm with the frontier already in words: words in, words out
    (grb.mxm_words dispatches here). Past bitmap.NIBBLE_MAX_SHARDS row
    shards the transposed lowering swaps the nibble psum for the unpacked
    psum_scatter body, so the contract holds at any shard count."""
    from repro_torch.core import semiring as S
    from repro_torch.distr import graph2d
    n, m = s.shape
    dsz = s.data_size
    if transposed:
        fn = graph2d.mxm_2d(s.mesh, S.OR_AND, transposed=True,
                            out_rows=_padded(m, dsz), packed=True)
        Xp = _pad_words(s, Xw, n)
        out_rows = m
    else:
        fn = graph2d.mxm_2d(s.mesh, S.OR_AND, packed=True)
        Xp = _pad_words(s, Xw, m)
        out_rows = n
    Y = fn(s.local, Xp)
    return Y[:out_rows, :Xw.shape[1]]


def reduce_stored(s: ShardedELL, monoid, axis):
    """plus / or stored-entry reduction through the graph2d psum lowering,
    in float64; min / max go through :func:`reduce_minmax`."""
    from repro_torch.distr import graph2d
    n, m = s.shape
    fn = graph2d.reduce_2d(s.mesh, monoid.name, axis, m)
    out = fn(s.local)
    if axis == 1:
        return out[:n]
    return out


def reduce_minmax(s: ShardedELL, monoid, axis):
    """min / max reduction with dense semantics (absent entries render 0),
    on the mesh: stored-entry pmin / pmax over "data" and a stored-count
    compare to fold the implicit zeros back in (graph2d.reduce_minmax_2d)."""
    from repro_torch.distr import graph2d
    n, m = s.shape
    fn = graph2d.reduce_minmax_2d(s.mesh, monoid.name, axis, n, m)
    out = fn(s.local)
    if axis == 1:
        return out[:n]
    return out


# ---------------------------------------------------------------------------
# shard-local element-wise family — the slot-aligned merge grb dispatches to
# ---------------------------------------------------------------------------
def _pair_check(a: ShardedELL, b: ShardedELL, what: str):
    if a.shape != b.shape:
        raise ValueError(f"{what}: shape mismatch {a.shape} vs {b.shape}")
    if a.mesh is not b.mesh and a.mesh != b.mesh:
        raise TypeError(f"{what}: operands live on different meshes")


def _from_parts(shape, mesh, parts) -> ShardedELL:
    return ShardedELL.from_blocks(shape, mesh, [p[0] for p in parts],
                                  [p[1] for p in parts],
                                  [p[2] for p in parts])


def merge_stored(a: ShardedELL, b: ShardedELL, op, mode: str) -> ShardedELL:
    """Shard-local merge of two identically meshed operands (see
    graph2d._ewise_merge for the slot-alignment pass and the modes). Same
    shape and mesh imply the same padded row count, so the row blocks
    align shard for shard; the merged layout is the concatenated slot
    width."""
    from repro_torch.distr import graph2d
    _pair_check(a, b, f"merge_stored[{mode}]")
    fn = graph2d.ewise_2d(a.mesh, mode, op)
    return _from_parts(a.shape, a.mesh, fn(a.local, b.local))


def restrict_dense(a: ShardedELL, dense_mask, complement: bool) -> ShardedELL:
    """Keep a's stored entries where a dense (n, m) mask is nonzero (or
    zero, complemented): a shard-local per-slot gather
    (graph2d.restrict_dense_2d). The mask's row block is padded to the
    mesh like every operand."""
    from repro_torch.distr import graph2d
    dm = torch.as_tensor(dense_mask).to(a.mesh.home)
    dm = _pad2(dm, a.n_pad - dm.shape[0], 0)
    fn = graph2d.restrict_dense_2d(a.mesh, bool(complement))
    return _from_parts(a.shape, a.mesh, fn(a.local, dm))


def extract_cols(a: ShardedELL, cols) -> ShardedELL:
    """Column-subset extract (rows stay put): relabel stored columns
    through a replicated LUT, shard-local. Row subsets re-partition the
    "data" axis and stay on the counted gather fallback in grb.extract."""
    from repro_torch.distr import graph2d
    cols = np.asarray(cols, np.int64)
    lut = np.full((a.shape[1],), -1, np.int32)
    lut[cols] = np.arange(len(cols), dtype=np.int32)
    fn = graph2d.extract_cols_2d(a.mesh)
    return _from_parts((a.shape[0], len(cols)), a.mesh,
                       fn(a.local, torch.from_numpy(lut)))


def relabel_cols(a: ShardedELL, new_cols, ncols_out: int) -> ShardedELL:
    """Map every stored column j -> new_cols[j] (all >= 0), giving an
    (n, ncols_out) operand: the inverse relabel assign(:, J) needs to put a
    region operand back into global coordinates. Shard-local LUT gather."""
    from repro_torch.distr import graph2d
    lut = torch.from_numpy(np.asarray(new_cols, np.int32))
    fn = graph2d.extract_cols_2d(a.mesh)
    return _from_parts((a.shape[0], ncols_out), a.mesh, fn(a.local, lut))

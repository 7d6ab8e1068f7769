"""The GraphBLAS operation surface ``C<M> accum= op(A, B, desc)``, over torch.

Port of ``repro.core.grb``:

  Descriptor / desc /     the write blend (mask, complement, accum,
  finalize                replace, transpose_a);
  packed_frontiers        the packing policy's override ("auto" / "on" /
                          "off");
  GBMatrix                one handle over dense, BSR, ELL, BitELL, delta,
                          sharded ELL or sharded BitELL storage, with a
                          linked stored transpose (``.T``); ``with_impl``
                          is a no-op kept for parity;
  distribute              an ELL or BitELL handle re-homed onto a mesh
                          (``distr.mesh.Mesh``), cached per mesh;
  mxm                     the semiring matmul on a dense (k, F) frontier:
                          BSR through ``kernels.bsr_mxm`` with a pure
                          masked write fused into its epilogue, ELL float
                          route, the bitmap-packed or_and route (ELL,
                          dense), the dense semiring product; BitELL under
                          a non-or_and semiring takes the cached
                          materialize-to-ELL fallback; a delta handle
                          composes its base's product with its patch's
                          (``_mxm_delta``); BSR x BSR (a sparse B handle)
                          through SpGEMM, staying BSR; any other sparse B
                          densified;
  mxm_words               packed words in, packed words out — the per-hop
                          call of word-resident hop loops (BSR and delta
                          detour through the float mxm on the device);
                          sharded handles lower to ``distr.graph2d``, the
                          word kernels running once per mesh position;
  words_route_ok          the gate for those loops;
  mxv / vxm               width-1 products through ``mxm``;
  ewise_add / ewise_mult  the element-wise family over stored entries
  apply / select          (union, intersection, GrB_apply, GxB_select),
  extract / assign        GrB_extract / GrB_assign and GrB_reduce, with
  reduce                  the descriptor blend on every operand kind.

Where the JAX package asks ``jax.default_backend() == "tpu"`` (and, for
BSR, its measured crossover) before taking a Pallas kernel, the port asks
where the tensors lie: CUDA tensors launch the hand-written kernels
(``kernels.ops``) at every width, CPU tensors take their plain versions;
for BSR the handle's fill picks between each kernel's entry and tile
variants (``MXM_ENTRY_MAX_FILL``, ``EWISE_ENTRY_MAX_FILL``, measured on
the card), on the CPU between their plain versions. The JAX package's ``grb`` runs its BSR element-wise plans
through XLA; the port's launch ``bsr_ewise`` on the card. Element-wise
ops on BSR operands are named (``semiring.ewise`` or a Monoid); dense
tensors and ELL take any callable. Dense handles hold a 2-D tensor and
compute in plain torch (the JAX package runs them through XLA, outside
any Pallas kernel); the element-wise family returns raw tensors for dense
operands. Delta handles (``core.delta``) compose the matmul family and
the plus / or reductions from their base and a row patch, and take a
materialization, folded per call, elsewhere. Sharded handles
(``core.shard.ShardedELL``, ``core.bitadj.ShardedBitELL``) stay on their
mesh through mxm, the element-wise family, column extract / assign and
reduce; only cross-shard requests gather, and each gather is counted
(``host_transfers``). A sharded operand pairs only with sharded operands
on the same mesh (TypeError otherwise), as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import bitadj as _bitadj
from repro_torch.core import bitmap as _bitmap
from repro_torch.core import bsr as _bsr
from repro_torch.core import coo as _coo
from repro_torch.core import ops as _ops
from repro_torch.core import semiring as S
from repro_torch.core import shard as _shard
from repro_torch.core import xfer as _xfer
from repro_torch.core.bitadj import BitELL, ShardedBitELL
from repro_torch.core.bsr import BSR, SPGEMM_MODES as _SPGEMM_MODES
from repro_torch.core.delta import DeltaMatrix
from repro_torch.core.ell import ELL
from repro_torch.core.shard import ShardedELL

Storage = Union[BSR, ELL, BitELL, DeltaMatrix, ShardedELL, ShardedBitELL,
                torch.Tensor]
_SHARDED = (ShardedELL, ShardedBitELL)


# ---------------------------------------------------------------------------
# Descriptor — GrB_Descriptor analog
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Descriptor:
    """Operation modifiers for one GraphBLAS call.

    mask        write mask M (same shape as the output): a dense tensor, or
                for BSR x BSR a sparse handle, applied block-wise
    complement  use !M instead of M (GrB_COMP)
    accum       accumulate monoid: C<M> accum= result
    replace     clear C entries outside the mask (GrB_REPLACE)
    transpose_a op reads A^T, served from the handle's stored transpose
    """
    mask: Optional[Union[torch.Tensor, "GBMatrix", BSR]] = None
    complement: bool = False
    accum: Optional[S.Monoid] = None
    replace: bool = False
    transpose_a: bool = False

    def with_(self, **kw) -> "Descriptor":
        return dataclasses.replace(self, **kw)

    @property
    def mask_only(self) -> bool:
        """True when the write is a pure masked overwrite (no accum, no
        replace)."""
        return self.accum is None and not self.replace


NULL = Descriptor()
TRANSPOSE_A = Descriptor(transpose_a=True)


def desc(mask=None, complement: bool = False,
         accum: Optional[S.Monoid] = None, replace: bool = False,
         transpose_a: bool = False) -> Descriptor:
    """Convenience constructor mirroring GrB_Descriptor_set."""
    return Descriptor(mask=mask, complement=complement, accum=accum,
                      replace=replace, transpose_a=transpose_a)


def finalize(d: Descriptor, result: torch.Tensor, out: Optional[torch.Tensor],
             identity: float) -> torch.Tensor:
    """Blend ``result`` into ``out`` under the descriptor:

      z       = accum(C, result)      if accum given and C given, else result
      C<M>    = z   inside the mask   (all-true when desc.mask is None)
      C<!M>   = identity              when C is None or desc.replace
              = C (old value)         otherwise
    """
    if d.accum is not None and out is not None:
        z = d.accum.op(out, result)
    else:
        z = result
    if d.mask is None:
        return z
    m = (d.mask == 0) if d.complement else (d.mask != 0)
    if out is None or d.replace:
        outside = torch.full_like(z, identity)
    else:
        outside = out
    return torch.where(m, z, outside)


# ---------------------------------------------------------------------------
# GBMatrix — GrB_Matrix analog
# ---------------------------------------------------------------------------
def _fmt_of(store) -> str:
    if isinstance(store, BSR):
        return "bsr"
    if isinstance(store, ELL):
        return "ell"
    if isinstance(store, BitELL):
        return "bitadj"
    if isinstance(store, ShardedELL):
        return "sharded"
    if isinstance(store, DeltaMatrix):
        return "delta"
    if isinstance(store, ShardedBitELL):
        return "bitshard"
    if isinstance(store, torch.Tensor) and store.dim() == 2:
        return "dense"
    raise NotImplementedError(
        f"storage {type(store).__name__} is not ported: the port holds "
        f"dense (a 2-D torch tensor), BSR, ELL, BitELL, delta, ShardedELL "
        f"and ShardedBitELL handles")


# -- the card's crossovers between the entry and tile kernels of bsr_mxm
# and bsr_ewise, by tile side: an operand (or pair) of side b whose fill
# (stored entries over the capacity of its valid tiles) is under the value
# of the smallest side listed >= b takes the entry kernel, else the tile
# kernel; the CPU's plain versions follow the same choice. Measured by the
# fill sweeps of chip_smoke.py on an NVIDIA H100 80GB HBM3 (PERF.md). They
# replace the JAX package's AUTO_MIN_GRID / AUTO_MAX_FILL / AUTO_MIN_WIDTH,
# measured there on XLA-CPU for a TPU, which the port never read. SpGEMM's
# table is kernels.bsr_spgemm.ENTRY_MAX_FILL.
#   bsr_mxm: uniform tiles cross at 15-25% (b = 128), 25-50% (64) and
#   50-100% (32); at 16 the entry kernel wins at every fill (1.01); the
#   planted-partition 128-tiles at 14-22%.
#   bsr_ewise: intersect crosses at 10-15% (128) and 15-25% (64), select
#   later; the planted-partition 128-tiles' intersect at 4.9-8.4%; at 16
#   and 32 the two tie within launch overhead below 25%, and the tile
#   kernel wins at 100% (16) and 50% (32).
# Each value is the geometric middle of the tightest bracket.
MXM_ENTRY_MAX_FILL = {16: 1.01, 32: 0.7, 64: 0.35, 128: 0.18}
EWISE_ENTRY_MAX_FILL = {16: 0.5, 32: 0.35, 64: 0.19, 128: 0.065}


def entry_max_fill(table, b: int) -> float:
    """``table``'s crossover for tiles of side ``b`` (past the largest side
    listed, that side's)."""
    sides = [s for s in table if s >= b]
    return table[min(sides) if sides else max(table)]


# -- bitmap-packed frontier policy (the JAX package's value, measured there
# by benchmarks/bench_khop.run_packed): an or_and mxm on ELL packs its
# frontier when it is at least this wide; BitELL always packs; BSR never
# does (its or_and route is the indicator tile product).
AUTO_PACK_MIN_WIDTH = 8

_PACK_MODE = "auto"   # "auto" (width threshold) | "on" | "off"


@contextlib.contextmanager
def packed_frontiers(mode: str):
    """Temporarily override the packing policy: "on" packs every
    or_and-eligible call whatever its width, "off" packs none (dense, ELL
    and sharded ELL take their float routes), "auto" restores the
    ``AUTO_PACK_MIN_WIDTH`` crossover. BitELL and ShardedBitELL keep their
    word route in every mode. Tests and benchmarks use this; production
    code leaves "auto"."""
    global _PACK_MODE
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"packed_frontiers mode {mode!r} not in "
                         f"('auto', 'on', 'off')")
    prev, _PACK_MODE = _PACK_MODE, mode
    try:
        yield
    finally:
        _PACK_MODE = prev


def _pack_wanted(f: int) -> bool:
    """Width side of the packed-frontier policy, under the mode of
    :func:`packed_frontiers`."""
    if _PACK_MODE == "off":
        return False
    return _PACK_MODE == "on" or f >= AUTO_PACK_MIN_WIDTH


class GBMatrix:
    """One matrix handle over dense / BSR / ELL / BitELL / delta / sharded
    storage, with a lazily built or explicitly linked stored transpose
    (``A.T``) and its distributed twins, cached per mesh
    (:func:`distribute`). The route is chosen by where the storage lies
    (CUDA kernel or plain version), so the handle carries no execution
    policy."""
    __slots__ = ("store", "fmt", "name", "_T", "_sharded")

    def __init__(self, store: Storage, name: str = ""):
        if isinstance(store, GBMatrix):
            store = store.store
        self.store = store
        self.fmt = _fmt_of(store)
        self.name = name
        self._T: Optional["GBMatrix"] = None
        # mesh -> distributed twin, filled by distribute (like the _T
        # cache: serving contexts re-resolve per query and must not re-pad
        # and re-place the whole graph each time)
        self._sharded: Optional[dict] = None

    @classmethod
    def wrap(cls, A) -> "GBMatrix":
        """Adopt an existing handle or wrap raw storage."""
        return A if isinstance(A, GBMatrix) else cls(A)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, fmt: str = "auto",
                 block: int = 128, name: str = "",
                 device="cuda") -> "GBMatrix":
        """A handle built from an entry list (numpy or sequences) in
        ``fmt`` ("dense", "bsr", "ell", "bitadj" or "auto"), on
        ``device``."""
        if fmt == "bsr":
            store = BSR.from_coo(rows, cols, vals, shape, block=block,
                                 device=device)
        elif fmt == "ell":
            store = ELL.from_coo(rows, cols, vals, shape, device=device)
        elif fmt == "bitadj":
            store = BitELL.from_coo(rows, cols, vals, shape, device=device)
        elif fmt == "dense":
            d = np.zeros(shape, dtype=np.float32)
            d[np.asarray(rows, np.int64), np.asarray(cols, np.int64)] = (
                1.0 if vals is None else np.asarray(vals, dtype=np.float32))
            store = torch.from_numpy(d).to(torch.device(device))
        else:
            store = _ops.auto_format(rows, cols, vals, shape, block=block,
                                     device=device)
        return cls(store, name=name)

    @classmethod
    def from_dense(cls, A, fmt: str = "dense", block: int = 128,
                   name: str = "", device=None) -> "GBMatrix":
        """A handle over a dense matrix (tensor or numpy), stored as
        ``fmt``; on the tensor's device unless ``device`` is given (numpy
        input defaults to ``"cuda"``)."""
        if device is None:
            device = A.device if isinstance(A, torch.Tensor) else "cuda"
        if fmt == "dense":
            return cls(torch.as_tensor(A).to(torch.device(device)), name=name)
        A = A.cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
        r, c = np.nonzero(A)
        return cls.from_coo(r, c, A[r, c], A.shape, fmt=fmt, block=block,
                            name=name, device=device)

    @property
    def shape(self):
        return tuple(self.store.shape)

    @property
    def nvals(self) -> int:
        """Stored-entry count (GrB_Matrix_nvals)."""
        if self.fmt == "dense":
            return int(torch.count_nonzero(self.store))
        return self.store.nnz

    @property
    def T(self) -> "GBMatrix":
        """Stored transpose, built once and cached; ``A.T.T is A``."""
        if self._T is None:
            t = (self.store.t().contiguous() if self.fmt == "dense"
                 else self.store.transpose())
            self.link_transpose(GBMatrix(t, name=self.name + "^T"))
        return self._T

    def link_transpose(self, other: "GBMatrix") -> "GBMatrix":
        """Install an explicitly-built transpose so ``.T`` never rebuilds
        it."""
        self._T = other
        other._T = self
        return self

    def with_impl(self, impl: str) -> "GBMatrix":
        """The JAX package's execution-policy switch, kept for parity. The
        port has one route per storage kind and device, so this returns
        self."""
        del impl
        return self

    def to_dense(self) -> torch.Tensor:
        if self.fmt == "dense":
            return self.store
        return self.store.to_dense()

    def __getattr__(self, attr: str):
        # forward storage introspection (nnz / to_coo / device / ...) so
        # the handle stands in for raw storage
        if attr.startswith("_") or attr in GBMatrix.__slots__:
            raise AttributeError(attr)
        return getattr(self.store, attr)

    def __repr__(self) -> str:
        n, m = self.shape
        tag = f" {self.name!r}" if self.name else ""
        return f"GBMatrix{tag} {n}x{m} fmt={self.fmt} nvals={self.nvals}"


def matrix(obj, rel: Optional[str] = None) -> GBMatrix:
    """Adjacency handle from a Graph (and relation name), a Relation, a
    GBMatrix or raw storage. Duck-typed, so ``core`` never imports
    ``graph``: a Graph has ``relation()`` / ``relations``, a Relation
    ``A`` / ``name``."""
    if hasattr(obj, "relation") and hasattr(obj, "relations"):   # Graph
        try:
            r = obj.relation(rel)
        except KeyError:
            r = None
        if r is None:
            raise ValueError(f"no relation {rel!r} in graph "
                             f"(have: {sorted(obj.relations)})")
        obj = r
    if hasattr(obj, "A") and hasattr(obj, "name"):               # Relation
        return GBMatrix.wrap(obj.A)
    return GBMatrix.wrap(obj)


def distribute(obj, mesh, rel: Optional[str] = None) -> GBMatrix:
    """Re-home an ELL or BitELL handle onto a mesh: the sharded-storage
    constructor.

    Takes anything :func:`matrix` takes. Returns a GBMatrix over a
    row-sharded ``core.shard.ShardedELL`` (or ``core.bitadj.ShardedBitELL``
    for bit-packed structural adjacency, whose transpose twin is built and
    linked here, since the bit route has no transposed scatter lowering);
    a linked transpose is sharded and linked too, so ``A.T`` and
    ``transpose_a`` keep resolving to stored transposes on the mesh. Every
    later ``grb`` call on the handle lowers to the mesh collectives.

    A sharded handle on another mesh is gathered and re-homed; a delta
    handle is compacted first (the mesh layout has no delta lowering).
    Other storage raises TypeError. Distributed twins are cached on the
    source handle per mesh, with each shard's kernel forms, so per-query
    contexts re-resolving a relation never re-pad or re-place the graph.
    """
    h = matrix(obj, rel)
    if h.fmt == "sharded":
        if h.store.mesh == mesh:
            return h
        hh = GBMatrix(h.store.to_ell(), name=h.name)  # re-home across meshes
        if h._T is not None and h._T.fmt == "sharded":
            hh.link_transpose(GBMatrix(h._T.store.to_ell(), name=h._T.name))
        h = hh
    if h.fmt == "bitshard":
        if h.store.mesh == mesh:
            return h
        hh = GBMatrix(h.store.to_bitell(), name=h.name)
        if h._T is not None and h._T.fmt == "bitshard":
            hh.link_transpose(GBMatrix(h._T.store.to_bitell(),
                                       name=h._T.name))
        h = hh
    if h.fmt == "delta":
        # compact into the base format first (engine.Database freezes
        # mesh-served graphs with compact=True so serving never pays this)
        hh = GBMatrix(h.store.materialize(), name=h.name)
        if h._T is not None and h._T.fmt == "delta":
            hh.link_transpose(GBMatrix(h._T.store.materialize(),
                                       name=h._T.name))
        h = hh
    if h.fmt == "bitadj":
        # transpose_a on the mesh is always served from a stored twin:
        # build and link it here, once
        cache = h._sharded if h._sharded is not None else {}
        m = cache.get(mesh)
        if m is None:
            hT = h.T
            m = GBMatrix(ShardedBitELL.from_bitell(h.store, mesh),
                         name=h.name)
            m.link_transpose(
                GBMatrix(ShardedBitELL.from_bitell(hT.store, mesh),
                         name=hT.name))
            cache[mesh] = m
            h._sharded = cache
        return m
    if h.fmt != "ell":
        raise TypeError(
            f"grb.distribute: sharded dispatch needs ELL or BitELL row "
            f"storage, got {h.fmt!r} — rebuild with fmt='ell' "
            f"(GBMatrix.from_dense(x, fmt='ell') / "
            f"GraphBuilder.build(fmt='ell')) before distributing onto a "
            f"mesh")
    cache = h._sharded if h._sharded is not None else {}
    m = cache.get(mesh)
    if m is None:
        m = GBMatrix(ShardedELL.from_ell(h.store, mesh), name=h.name)
        if h._T is not None and h._T.fmt == "ell":
            m.link_transpose(GBMatrix(ShardedELL.from_ell(h._T.store, mesh),
                                      name=h._T.name))
        cache[mesh] = m
        h._sharded = cache
    return m


# ---------------------------------------------------------------------------
# GrB_mxm
# ---------------------------------------------------------------------------
def _packed_route_ok(A: GBMatrix, B: torch.Tensor, sr: S.Semiring) -> bool:
    """Gate for the bitmap-packed or_and route: boolean semiring, and ELL
    or dense storage with a frontier wide enough, or BitELL at any width
    (BSR keeps its indicator tile product)."""
    if sr.mode != "dot_indicator" or B.dim() != 2:
        return False
    if A.fmt == "bitadj":
        return True                          # structural: words always win
    return A.fmt in ("dense", "ell") and _pack_wanted(B.shape[1])


def _mxm_packed(A: GBMatrix, B: torch.Tensor, sr: S.Semiring, d: Descriptor,
                out: Optional[torch.Tensor]) -> torch.Tensor:
    """or_and mxm with the frontier packed at the call boundary, a pure
    masked overwrite blended word-wise, and the result unpacked — exactly
    the float indicator route's values."""
    f = B.shape[1]
    Yw = mxm_words(A, _bitmap.pack(B))
    if d.mask is not None and d.mask_only and out is None:
        Mw = _bitmap.pack(d.mask)
        Yw = (_bitmap.word_andnot(Yw, Mw) if d.complement
              else _bitmap.word_and(Yw, Mw))
        return _bitmap.unpack(Yw, f)
    return finalize(d, _bitmap.unpack(Yw, f), out, sr.identity)


def _storage(x):
    """A handle's store, BitELL as its cached ELL, delta storage as its
    materialization (folded per call) and sharded storage gathered
    (counted); other operands as they are."""
    if isinstance(x, GBMatrix):
        x = x.store
    if isinstance(x, DeltaMatrix):
        x = x.materialize()
    return x.to_ell() if isinstance(x, (BitELL,) + _SHARDED) else x


def _mask_as_bsr(mask, block: int) -> Optional[BSR]:
    """Structural BSR view of a descriptor mask for the SpGEMM and sparse
    element-wise paths: sparse masks convert through their entry lists, a
    dense tensor is tiled."""
    mask = _storage(mask)
    if mask is None:
        return None
    if isinstance(mask, (BSR, ELL)):
        return _bsr.as_bsr(mask, block)
    return BSR.from_dense(mask, block=block)


def _dense_mask(mask):
    """A descriptor mask as the dense tensor a dense-B product blends with:
    handles and sparse stores densify (delta masks through their
    materialization)."""
    if mask is None or isinstance(mask, torch.Tensor):
        return mask
    m = _storage(mask)
    return m if isinstance(m, torch.Tensor) else m.to_dense()


# the values the dot route's products read (dot: both operands, dot_first:
# A); a non-finite one meets the absent zeros only the tile route multiplies
_DOT_VALUES_READ = {"dot": (True, True), "dot_first": (True, False)}
# the operands' stored fill under which a masked product takes the dot route
# (dot_route_ok)
DOT_MAX_FILL = 0.05


def dot_route_ok(A: BSR, B: BSR, sr: S.Semiring, mask: Optional[BSR],
                 complement: bool) -> bool:
    """The SpGEMM route rule: the masked dot route (``core.bsr.spgemm_dot``)
    takes a product under a structural, not complemented, mask whose
    operands' stored fill (``core.bsr.stored_fill``) lies under
    ``DOT_MAX_FILL`` and whose read values are finite; every other product
    takes the tile route (``core.bsr.spgemm``). A complemented mask keeps
    the tile route: its output is everything the mask does not hold, which
    the tile plan enumerates.

    The card's figures (NVIDIA H100 80GB HBM3, 700 W;
    ``tools/spgemm_routes.py``, PERF.md §6): ``C<A> = A plus_pair A``
    and its sum on the Graph Challenge's undirected Graph500 R-MAT (ids
    permuted), 128-tiles, the median of five products, dot route against
    tile route. Edge factor 16: scale 15 (fill 0.082%) 5.9 against 54.9
    ms, scale 14 (0.16%) 3.5 against 18.6, scale 12 (0.58%) 2.7 against
    5.5, scale 10 (2.0%) 2.1 against 2.6; at scale 16 (8.2 ms on the dot
    route) the tile route runs out of the card's memory, and at scale 18
    (39.3 ms) its (nc, 128, 128) float32 output stack alone would be
    199 GB. Fuller tiles, from edge factors up to 1,024: the two trade
    places between 5% and 16% (scale 10 at 5.5%: 2.65 against 2.49;
    scale 11 at 7.7%: 3.45 against 4.43; scale 8 at 15.5%: 2.59 against
    2.39), and at scale 11 and 16% the tile route takes half the dot
    route's time (3.21 against 6.33). The limit sits at the low end of
    that band, which keeps scale 8 at edge factor 16 (6.5%: 2.7 against
    3.1, both a few launches' time) on the tile route."""
    if mask is None or complement or sr.mode not in _SPGEMM_MODES:
        return False
    if _bsr.stored_fill(*{id(A): A, id(B): B}.values()) >= DOT_MAX_FILL:
        return False
    reads = _DOT_VALUES_READ.get(sr.mode, (False, False))
    return all(bool(torch.isfinite(X.row_csr().vals).all())
               for X, r in zip((A, B), reads) if r)


def _mxm_spgemm(A: GBMatrix, B: GBMatrix, sr: S.Semiring,
                d: Descriptor) -> GBMatrix:
    """Sparse-times-sparse dispatch: C<M> = A (x) B with C staying BSR, by
    the route rule of :func:`dot_route_ok`. The dot route reads B's columns
    from B's stored transpose where B has one linked. The tile route's
    mask prunes whole output tiles in the symbolic phase (not
    complemented) and applies element-wise in the kernel's epilogue."""
    mask = _mask_as_bsr(d.mask, A.store.block)
    if dot_route_ok(A.store, B.store, sr, mask, d.complement):
        T = B._T.store if B._T is not None else None
        C = _bsr.spgemm_dot(A.store, B.store, sr, mask,
                            Bt=T if isinstance(T, BSR) else None)
    else:
        C = _bsr.spgemm(A.store, B.store, sr, mask=mask,
                        complement=d.complement)
    name = f"({A.name}x{B.name})" if (A.name or B.name) else ""
    return GBMatrix(C, name=name)


def _mxm_delta(A: GBMatrix, B: torch.Tensor, sr: S.Semiring, d: Descriptor,
               out: Optional[torch.Tensor]) -> torch.Tensor:
    """Delta-composed semiring matmul, exact for every semiring with no
    rebuild: result row i depends only on A's row i, so the rows no delta
    touches come from the frozen base's product and the touched rows from
    the product of a small ELL patch holding their exact effective content.
    Rows past the base's extent (node growth) are the add identity unless
    patched. Both products recurse through :func:`mxm`, so each keeps its
    own route: the base's kernel (``bsr_mxm``, ``ell_mxv_packed``) and the
    patch's ELL route, on the base's device. Only the patch's t real rows
    scatter: its padding rows carry the out-of-bounds index n."""
    dm: DeltaMatrix = A.store
    baseh = GBMatrix(dm.base, name=A.name)
    bn, bm = baseh.shape
    n = dm.shape[0]
    patch, rows = dm.patch()
    if patch is None and n == bn:
        return mxm(baseh, B, sr, d, out=out)        # empty delta: base as is
    yb = mxm(baseh, B[:bm], sr)
    if n > bn:
        pad = torch.full((n - bn, yb.shape[1]), sr.identity, dtype=yb.dtype,
                         device=yb.device)
        yb = torch.cat([yb, pad], dim=0)
    if patch is not None:
        yp = mxm(GBMatrix(patch), B, sr)
        t = dm.touched
        yb = yb.index_copy(0, rows[:t].long(), yp[:t])
    return finalize(d, yb, out, sr.identity)


def _sharded_frontier(B):
    """B of a sharded product: a dense frontier tensor (a dense handle is
    one); a sparse operand raises the mesh's TypeError."""
    if isinstance(B, GBMatrix) and B.fmt == "dense":
        B = B.store
    if isinstance(B, (GBMatrix, BSR, ELL, BitELL, DeltaMatrix) + _SHARDED):
        kind = _operand_kind(B)[0]
        raise TypeError(
            f"grb.mxm: a sharded A multiplies a dense (k, F) frontier "
            f"array; got a sparse {kind} operand for B. Gather it "
            f"explicitly (B.to_dense()) or keep both sides unsharded for "
            f"the SpGEMM path.")
    return torch.as_tensor(B)


def _mxm_sharded(A: GBMatrix, B, sr: S.Semiring, d: Descriptor,
                 out: Optional[torch.Tensor]) -> torch.Tensor:
    """Mesh dispatch: C<M> accum= A (x) B with A's rows sharded over
    "data". transpose_a is served from a linked sharded transpose when
    there is one; otherwise the transposed (psum_scatter) lowering reads
    the forward row shards. The blend runs on the global result, as on
    one device."""
    B = _sharded_frontier(B)
    transposed = False
    if d.transpose_a:
        if A._T is not None:
            A = A.T
        else:
            transposed = True
        d = d.with_(transpose_a=False)
    d = d.with_(mask=_dense_mask(d.mask))
    # or_and frontiers ride the mesh as packed words: the per-hop
    # all-gather (row form) / psum_scatter (transposed form) payload cut
    packed = (sr.mode == "dot_indicator" and B.dim() == 2
              and _pack_wanted(B.shape[1]))
    y = _shard.mxm(A.store, B, sr, transposed=transposed, packed=packed)
    return finalize(d, y, out, sr.identity)


def _mxm_bitshard(A: GBMatrix, B, sr: S.Semiring, d: Descriptor,
                  out: Optional[torch.Tensor]) -> torch.Tensor:
    """Mesh dispatch for bit-packed adjacency: every or_and call runs bit
    level (pack at the boundary, ``bitadj.sharded_mxm_words``: one word
    all-gather, the word kernel on every shard). transpose_a always reads
    the linked twin distribute built. Other semirings take the cached
    ShardedELL materialization and the sharded ELL route."""
    B = _sharded_frontier(B)
    if d.transpose_a:
        if A._T is None or A._T.fmt != "bitshard":
            raise RuntimeError(
                "grb.mxm: transpose_a on bit-sharded storage needs the "
                "linked transpose twin grb.distribute builds — distribute "
                "the handle (not a hand-wrapped ShardedBitELL) first")
        A = A.T
        d = d.with_(transpose_a=False)
    d = d.with_(mask=_dense_mask(d.mask))
    if sr.mode == "dot_indicator" and B.dim() == 2:
        f = B.shape[1]
        Yw = _bitadj.sharded_mxm_words(A.store, _bitmap.pack(B))
        if d.mask is not None and d.mask_only and out is None:
            Mw = _bitmap.pack(d.mask)
            Yw = (_bitmap.word_andnot(Yw, Mw) if d.complement
                  else _bitmap.word_and(Yw, Mw))
            return _bitmap.unpack(Yw, f)
        return finalize(d, _bitmap.unpack(Yw, f), out, sr.identity)
    Ae = GBMatrix(A.store.materialize_sharded(), name=A.name)
    if A._T is not None and A._T.fmt == "bitshard":
        Ae.link_transpose(GBMatrix(A._T.store.materialize_sharded(),
                                   name=A._T.name))
    return _mxm_sharded(Ae, B, sr, d, out)


def mxm(A, B, sr: S.Semiring, d: Descriptor = NULL,
        out: Optional[torch.Tensor] = None):
    """C<M> accum= A (x) B over a semiring. A: GBMatrix (or raw storage).
    B: a dense (k, F) frontier or any matrix handle. BSR x BSR with out
    None under a dot mode is SpGEMM and returns a BSR handle; every other
    handle B is densified (``B.to_dense()``, as in the JAX package) and
    gives a dense C; delta operands against a handle B take their
    materialization. A sharded A multiplies a dense frontier
    on its mesh; a sharded B needs a sharded A. ``out`` is the existing C
    for accum/blend, None meaning replace-into-empty."""
    A = GBMatrix.wrap(A)
    if A.fmt == "sharded":
        return _mxm_sharded(A, B, sr, d, out)
    if A.fmt == "bitshard":
        return _mxm_bitshard(A, B, sr, d, out)
    if isinstance(B, _SHARDED) or (
            isinstance(B, GBMatrix) and B.fmt in ("sharded", "bitshard")):
        raise TypeError(
            "grb.mxm: B is sharded but A is not — operand kinds must match. "
            "Distribute A onto the same mesh (grb.distribute(A, mesh)) or "
            "gather B explicitly (B.to_dense()).")
    if d.transpose_a:
        A = A.T
        d = d.with_(transpose_a=False)
    if isinstance(B, (BSR, ELL, BitELL, DeltaMatrix)):
        B = GBMatrix(B)
    if isinstance(B, GBMatrix):
        # delta operands against a handle compose through their
        # materialization; against a dense frontier tensor, A stays delta
        # and takes the row-patch route below
        if A.fmt == "delta":
            A = GBMatrix(A.store.materialize(), name=A.name)
        if B.fmt == "delta":
            B = GBMatrix(B.store.materialize(), name=B.name)
        if (A.fmt == "bsr" and B.fmt == "bsr" and out is None
                and sr.mode in _SPGEMM_MODES):
            return _mxm_spgemm(A, B, sr, d)
        # every other sparse B densifies, as in the JAX package
        B = B.to_dense()
    if not isinstance(B, torch.Tensor) or B.dim() != 2:
        raise TypeError("grb.mxm: B must be a dense (k, F) frontier tensor "
                        "or a matrix handle")
    d = d.with_(mask=_dense_mask(d.mask))
    if A.fmt == "delta":
        return _mxm_delta(A, B, sr, d, out)
    if A.fmt == "bitadj" and not _packed_route_ok(A, B, sr):
        # weighted / non-indicator call on structural storage: the cached
        # materialize-to-ELL fallback
        A = GBMatrix(A.store.to_ell(), name=A.name)
    if _packed_route_ok(A, B, sr):
        return _mxm_packed(A, B, sr, d, out)
    if A.fmt == "bsr":
        from repro_torch.kernels import ops as kops  # kernels import core
        if d.mask is not None and out is None and d.mask_only:
            # a pure masked write: the kernel folds <M> / <!M> into its
            # epilogue, no separate masking pass
            return kops.bsr_mxm(A.store, B, sr, mask=d.mask,
                                complement=d.complement)
        y = kops.bsr_mxm(A.store, B, sr)
    elif A.fmt == "dense":
        y = S.dense_mxm(S.structural_dense(A.store, sr), B, sr)
    else:
        y = _ops.ell_mxm(A.store, B, sr)
    return finalize(d, y, out, sr.identity)


def host_transfers() -> int:
    """Device->host gathers inside op dispatch since process start
    (``core.xfer``)."""
    return _xfer.host_transfers()


def mxm_words(A, Bw: torch.Tensor, transpose_a: bool = False) -> torch.Tensor:
    """or_and mxm with the frontier already bitmap-packed: (k, W) words in,
    (rows, W) words out. No descriptor: callers blend masks word-wise. ELL
    goes to ``kernels.ops.ell_mxv_packed``, BitELL to
    ``kernels.ops.bitadj_mxv_packed``; each launches its CUDA kernel for
    CUDA tensors and runs its plain version for CPU tensors. Dense storage
    takes ``core.ops.dense_mxm_packed``. Sharded storage runs the mesh
    lowering, which calls this function on each shard-local handle (so a
    CUDA shard launches its word kernel). BSR and delta storage have no
    packed route: they detour through the float mxm (the ``bsr_mxm``
    kernel, or the delta composition) on the device and re-pack;
    ``words_route_ok`` keeps hop loops off that detour."""
    from repro_torch.kernels import ops as kops   # lazy: kernels import core
    A = GBMatrix.wrap(A)
    if A.fmt == "sharded":
        transposed = False
        if transpose_a:
            if A._T is not None:
                A = A.T
            else:
                transposed = True
        return _shard.mxm_words(A.store, Bw, transposed=transposed)
    if A.fmt == "bitshard":
        if transpose_a:
            if A._T is None or A._T.fmt != "bitshard":
                raise RuntimeError(
                    "grb.mxm_words: transpose_a on bit-sharded storage "
                    "needs the linked twin grb.distribute builds")
            A = A.T
        return _bitadj.sharded_mxm_words(A.store, Bw)
    if transpose_a:
        A = A.T
    if A.fmt == "bitadj":
        return kops.bitadj_mxv_packed(A.store, Bw)
    if A.fmt == "ell":
        return kops.ell_mxv_packed(A.store, Bw)
    if A.fmt == "dense":
        return _ops.dense_mxm_packed(A.store, Bw)
    f = Bw.shape[1] * _bitmap.WORD_BITS
    return _bitmap.pack(mxm(A, _bitmap.unpack(Bw, f), S.OR_AND))


def words_route_ok(A, f: int) -> bool:
    """Gate for word-resident hop loops: BitELL and ShardedBitELL always
    (the adjacency itself is packed), ELL, sharded ELL and dense when the
    packing policy wants a width-``f`` frontier packed, BSR and delta
    never (they keep the float hop loop)."""
    A = GBMatrix.wrap(A)
    if A.fmt in ("bitadj", "bitshard"):
        return True
    return A.fmt in ("dense", "ell", "sharded") and _pack_wanted(f)


def _columnize(v) -> Optional[torch.Tensor]:
    # (n,) vectors become width-1 columns; anything else passes through
    if v is not None and getattr(v, "ndim", None) == 1:
        return v[:, None]
    return v


def mxv(A, x: torch.Tensor, sr: S.Semiring, d: Descriptor = NULL,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y<m> accum= A (x) x: ``mxm`` on a width-1 frontier (on BSR the
    ``bsr_mxm`` kernel at F = 1)."""
    dm = d.with_(mask=_columnize(d.mask))
    y = mxm(A, x[:, None], sr, dm, out=_columnize(out))
    return y[:, 0]


def vxm(x: torch.Tensor, A, sr: S.Semiring, d: Descriptor = NULL,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x (x) A == A^T (x) x, served from the handle's stored
    transpose."""
    return mxv(A, x, sr, d.with_(transpose_a=not d.transpose_a), out=out)


# ---------------------------------------------------------------------------
# element-wise family — GrB_eWiseAdd / eWiseMult / apply / select
# ---------------------------------------------------------------------------
# Dense tensors keep array semantics (an entry is stored iff nonzero). For
# BSR / ELL operands:
#
#   ewise_add   pattern = union;        op(a, b) where both stored, the
#               stored value where only one side is (absent never fed to op)
#   ewise_mult  pattern = intersection; op(a, b) on the intersection
#   apply       pattern = stored(x);    f applied to stored entries only
#   select      stored entries passing pred, emptied tiles pruned
#
# and the descriptor blend writes *empty* (renders 0) outside the mask, not
# the monoid identity, with accum merging by union. Sparse operands stay
# sparse (block-aligned plans in core.bsr, COO set algebra in core.coo for
# ELL); mixing a sparse operand with a dense tensor raises TypeError.

def _operand_kind(x):
    """('bsr' | 'ell' | 'sharded' | 'dense', storage) of a handle, store
    or tensor. BitELL takes its cached ELL materialization, ShardedBitELL
    its cached ShardedELL and delta storage its materialization in the
    base's format (folded per call), so the whole element-wise / extract /
    assign family sees the exact post-write entries; storage the port
    does not hold raises NotImplementedError (``_fmt_of``)."""
    s = x.store if isinstance(x, GBMatrix) else x
    if isinstance(s, ShardedBitELL):
        return "sharded", s.materialize_sharded()
    if isinstance(s, ShardedELL):
        return "sharded", s
    x = _storage(x)
    if isinstance(x, BSR):
        return "bsr", x
    if isinstance(x, ELL):
        return "ell", x
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return "dense", torch.as_tensor(x)
    _fmt_of(x)


def _unshard(x):
    """The gathered view of a sharded operand (ELL, a handle staying a
    handle); other operands pass through."""
    if x is None:
        return None
    kind, s = _operand_kind(x)
    if kind != "sharded":
        return x
    e = s.to_ell()
    return GBMatrix(e, name=x.name) if isinstance(x, GBMatrix) else e


def _sharded_store(x):
    """x's sharded storage, or None (no materialization of other kinds)."""
    s = x.store if isinstance(x, GBMatrix) else x
    return s if isinstance(s, _SHARDED) else None


def _sharded_pair_mesh(fn: str, a, b, out=None):
    """Pairing contract of the element-wise family: both main operands
    sharded on one mesh (out sharded or None) -> that mesh; no sharded
    operand -> None; anything mixed -> TypeError naming the kinds."""
    given = [x for x in (a, b) if x is not None]
    shd = [s for s in map(_sharded_store, given) if s is not None]
    so = _sharded_store(out) if out is not None else None
    if not shd:
        if so is not None:
            raise TypeError(
                f"grb.{fn}: out= is sharded but the operands are not — "
                f"operand kinds must match; distribute the operands "
                f"(grb.distribute) or gather out (out.to_ell())")
        return None
    if len(shd) != len(given):
        got = " and ".join(_operand_kind(x)[0] for x in given)
        raise TypeError(
            f"grb.{fn}: operand kinds must match — a sharded matrix pairs "
            f"only with another sharded matrix on the same mesh; got {got}. "
            f"Distribute the unsharded side (grb.distribute(x, mesh)) or "
            f"gather the sharded one (x.to_ell() / x.to_dense()).")
    mesh = shd[0].mesh
    for s in shd[1:]:
        if s.mesh != mesh:
            raise TypeError(f"grb.{fn}: sharded operands live on different "
                            f"meshes — distribute both onto one mesh")
    if so is not None and so.mesh != mesh:
        raise TypeError(f"grb.{fn}: out= lives on a different mesh than the "
                        f"operands — distribute all three onto one mesh")
    return mesh


# stable-identity ops for the shard-local merge (graph2d.ewise_2d caches
# per (mesh, mode, op); module-level callables keep the cache warm)
def _take_second(a, b):           # mask restricts never consult the op
    del a
    return b


def _disjoint_concat(a, b):       # unions of provably disjoint patterns
    return a + b


def _sharded_restrict(res: ShardedELL, mask, complement: bool) -> ShardedELL:
    """Mask restrict on a sharded result, shard-local: a same-mesh sharded
    mask merges through the slot-aligned pass, any dense or unsharded mask
    takes the per-slot dense gather. Only a mask sharded on another mesh
    gathers (counted, through to_ell)."""
    m = mask.store if isinstance(mask, GBMatrix) else mask
    if isinstance(m, ShardedBitELL):
        m = m.materialize_sharded()
    if isinstance(m, ShardedELL) and m.mesh == res.mesh:
        if m.shape != res.shape:
            raise ValueError(f"descriptor mask shape {tuple(m.shape)} != "
                             f"result {tuple(res.shape)}")
        return _shard.merge_stored(res, m, _take_second,
                                   "mask_c" if complement else "mask")
    dense = _dense_mask(mask)
    if tuple(dense.shape) != tuple(res.shape):
        raise ValueError(f"descriptor mask shape {tuple(dense.shape)} != "
                         f"result {tuple(res.shape)}")
    return _shard.restrict_dense(res, dense, complement)


def _sharded_blend(d: Descriptor, res: ShardedELL,
                   out: Optional[ShardedELL]) -> ShardedELL:
    """The structural blend rule (union-accum, empty outside the mask) on
    ShardedELL storage, from shard-local merges only."""
    if d.accum is not None and out is not None:
        res = _shard.merge_stored(out, res, d.accum.op, "union")
    if d.mask is None:
        return res
    z_in = _sharded_restrict(res, d.mask, d.complement)
    if out is None or d.replace:
        return z_in
    old = _sharded_restrict(out, d.mask, not d.complement)
    return _shard.merge_stored(z_in, old, _disjoint_concat, "union")


def _sharded_out(out, fn: str, mesh, shape) -> Optional[ShardedELL]:
    """An out= operand for the shard-local blend: a same-mesh sharded out
    passes through, an unsharded sparse out is placed on the mesh, a
    dense out raises the family's TypeError."""
    if out is None:
        return None
    kind, store = _operand_kind(out)
    if kind == "dense":
        raise TypeError(f"grb.{fn}: sparse operands need a sparse out= "
                        f"(GBMatrix/BSR/ELL) or None (got a dense tensor); "
                        f"wrap it with GBMatrix.from_dense(out, fmt='ell')")
    if tuple(store.shape) != tuple(shape):
        raise ValueError(f"grb.{fn}: out shape {store.shape} != result "
                         f"{shape}")
    if kind == "sharded":
        return store                      # same mesh: _sharded_pair_mesh ran
    if kind == "bsr":
        store = ELL.from_coo(*store.to_coo(), store.shape,
                             device=store.device)
    return ShardedELL.from_ell(store, mesh)


def _ewise_pair(a, b, fn: str):
    """Classify an operand pair into one path, coercing only sparse to
    sparse (ELL joins a BSR partner through COO, never a dense one)."""
    ka, sa = _operand_kind(a)
    kb, sb = _operand_kind(b)
    if (ka == "dense") != (kb == "dense"):
        raise TypeError(
            f"grb.{fn}: operand kinds must match — both dense tensors or "
            f"both sparse matrices (GBMatrix/BSR/ELL); got {ka} and {kb}. "
            f"Convert explicitly: BSR.from_dense(x) for the dense side or "
            f"x.to_dense() for the sparse side.")
    if tuple(sa.shape) != tuple(sb.shape):
        raise ValueError(f"grb.{fn} shapes: {tuple(sa.shape)} vs "
                         f"{tuple(sb.shape)}")
    if ka == "dense":
        return "dense", sa, sb
    if "bsr" in (ka, kb):
        if isinstance(sa, ELL):
            sa = _bsr.as_bsr(sa, sb.block)
        if isinstance(sb, ELL):
            sb = _bsr.as_bsr(sb, sa.block)
        return "bsr", sa, sb
    return "ell", sa, sb


def _dense_out(out, fn: str) -> Optional[torch.Tensor]:
    if out is None:
        return None
    kind, store = _operand_kind(out)
    if kind != "dense":
        raise TypeError(f"grb.{fn}: dense operands need a dense out= tensor "
                        f"(got a sparse {kind} matrix); densify it "
                        f"explicitly with out.to_dense() if intended")
    return store


def _sparse_out_bsr(out, fn: str, block: int) -> Optional[BSR]:
    if out is None:
        return None
    kind, store = _operand_kind(out)
    if kind == "dense":
        raise TypeError(f"grb.{fn}: sparse operands need a sparse out= "
                        f"(GBMatrix/BSR/ELL) or None (got a dense tensor); "
                        f"tile it with BSR.from_dense(out)")
    return _bsr.as_bsr(store, block)


def _sparse_out_entries(out, fn: str, shape=None):
    """(keys, vals) of a sparse out= operand for the COO blend."""
    if out is None:
        return None, None
    kind, store = _operand_kind(out)
    if kind == "dense":
        raise TypeError(f"grb.{fn}: sparse operands need a sparse out= "
                        f"(GBMatrix/BSR/ELL) or None (got a dense tensor); "
                        f"tile it with BSR.from_dense(out)")
    if shape is not None and tuple(store.shape) != tuple(shape):
        raise ValueError(f"grb.{fn}: out shape {store.shape} != result "
                         f"{shape}")
    return _ell_entries(store)


def _mask_entry_keys(mask, shape) -> np.ndarray:
    """Stored-entry key set of a descriptor mask (dense or sparse), checked
    against the result shape."""
    m = _storage(mask)
    if tuple(m.shape) != tuple(shape):
        raise ValueError(f"descriptor mask shape {tuple(m.shape)} != "
                         f"result {tuple(shape)}")
    ncols = max(shape[1], 1)
    if isinstance(m, (BSR, ELL)):
        r, c, _ = m.to_coo()
    else:
        r, c = np.nonzero(torch.as_tensor(m).cpu().numpy())
    return _coo.keys_of(r, c, ncols)


def _dense_union(a: torch.Tensor, b: torch.Tensor, op) -> torch.Tensor:
    both = (a != 0) & (b != 0)
    # a + b is exactly "the stored value" where only one side stores one
    return torch.where(both, op(a, b), a + b)


def _structural_finalize_dense(d: Descriptor, result: torch.Tensor,
                               out: Optional[torch.Tensor]) -> torch.Tensor:
    """The blend rule with entry semantics on dense tensors: union-accum,
    and *empty* (0), not a monoid identity, outside the mask."""
    if d.accum is not None and out is not None:
        z = _dense_union(out, result, d.accum.op)
    else:
        z = result
    if d.mask is None:
        return z
    m = _storage(d.mask)
    mask = m.to_dense() if isinstance(m, (BSR, ELL)) else torch.as_tensor(m)
    keep = (mask == 0) if d.complement else (mask != 0)
    outside = torch.zeros_like(z) if (out is None or d.replace) else out
    return torch.where(keep, z, outside)


def _structural_finalize_bsr(d: Descriptor, res: BSR,
                             out: Optional[BSR]) -> BSR:
    """The same blend rule out of block-aligned sparse plans (union, mask,
    mask_c): the result never leaves tile-list form."""
    if d.accum is not None and out is not None:
        res = _bsr.ewise_add(out, res, d.accum)
    if d.mask is None:
        return res
    M = _mask_as_bsr(d.mask, res.block)
    z_in = _bsr.mask_keep(res, M, complement=d.complement)
    if out is None or d.replace:
        return z_in
    old = _bsr.mask_keep(out, M, complement=not d.complement)
    return _bsr.ewise_add(z_in, old, S.PLUS)            # disjoint patterns


def _structural_finalize_ell(d: Descriptor, keys, vals, out, fn: str,
                             shape, device) -> ELL:
    """The blend rule on COO entry sets, rebuilt into ELL on ``device``."""
    kc, vc = _sparse_out_entries(out, fn, shape)
    mk = None if d.mask is None else _mask_entry_keys(d.mask, shape)
    accum_op = None if d.accum is None else d.accum.op
    k, v = _coo.blend(keys, vals, kc, vc, mk, d.complement, accum_op,
                      d.replace)
    return ELL.from_entries(*_coo.nonzero(k, v), shape, device=device)


def _ell_entries(e) -> tuple:
    r, c, v = e.to_coo()
    return (_coo.keys_of(r, c, max(e.shape[1], 1)),
            np.asarray(v, np.float32))


def ewise_add(a, b, monoid, d: Descriptor = NULL, out=None):
    """C<M> accum= A (+) B — GrB_eWiseAdd, union semantics (see above).

    Both operands dense tensors -> a dense tensor; both sparse -> a sparse
    GBMatrix (BSR when either side is BSR, else ELL). Mixed kinds raise
    TypeError. ``monoid`` is a Monoid or a binary op (named, for BSR).
    """
    op = getattr(monoid, "op", monoid)
    mesh = _sharded_pair_mesh("ewise_add", a, b, out)
    if mesh is not None:                 # shard-local slot-aligned merge
        A, B = _operand_kind(a)[1], _operand_kind(b)[1]
        if A.shape != B.shape:
            raise ValueError(f"grb.ewise_add shapes: {A.shape} vs {B.shape}")
        res = _shard.merge_stored(A, B, op, "union")
        C = _sharded_out(out, "ewise_add", mesh, A.shape)
        return GBMatrix(_sharded_blend(d, res, C))
    kind, A, B = _ewise_pair(a, b, "ewise_add")
    if kind == "dense":
        return _structural_finalize_dense(
            d, _dense_union(A, B, op), _dense_out(out, "ewise_add"))
    if kind == "bsr":
        res = _bsr.ewise_add(A, B, op)
        C = _sparse_out_bsr(out, "ewise_add", A.block)
        return GBMatrix(_structural_finalize_bsr(d, res, C))
    k, v = _coo.nonzero(*_coo.union(*_ell_entries(A), *_ell_entries(B), op))
    return GBMatrix(_structural_finalize_ell(d, k, v, out, "ewise_add",
                                             A.shape, A.device))


def ewise_mult(a, b, op, d: Descriptor = NULL, out=None):
    """C<M> accum= A (.*) B — GrB_eWiseMult, intersection semantics. Same
    dispatch as :func:`ewise_add`; on BSR only tiles valid in both
    patterns are gathered. ``op`` is a binary op (named, for BSR) or a
    Monoid."""
    op = getattr(op, "op", op)
    mesh = _sharded_pair_mesh("ewise_mult", a, b, out)
    if mesh is not None:                 # shard-local slot-aligned merge
        A, B = _operand_kind(a)[1], _operand_kind(b)[1]
        if A.shape != B.shape:
            raise ValueError(f"grb.ewise_mult shapes: {A.shape} vs "
                             f"{B.shape}")
        res = _shard.merge_stored(A, B, op, "intersect")
        C = _sharded_out(out, "ewise_mult", mesh, A.shape)
        return GBMatrix(_sharded_blend(d, res, C))
    kind, A, B = _ewise_pair(a, b, "ewise_mult")
    if kind == "dense":
        both = (A != 0) & (B != 0)
        raw = torch.where(both, op(A, B), torch.zeros_like(A))
        return _structural_finalize_dense(d, raw,
                                          _dense_out(out, "ewise_mult"))
    if kind == "bsr":
        res = _bsr.ewise_mult(A, B, op)
        C = _sparse_out_bsr(out, "ewise_mult", A.block)
        return GBMatrix(_structural_finalize_bsr(d, res, C))
    k, v = _coo.nonzero(*_coo.intersect(*_ell_entries(A), *_ell_entries(B),
                                        op))
    return GBMatrix(_structural_finalize_ell(d, k, v, out, "ewise_mult",
                                             A.shape, A.device))


def apply(f: Callable, x, d: Descriptor = NULL, out=None):
    """C<M> accum= f(A) — GrB_apply over *stored* entries only: zero
    entries of a dense tensor (and zero lanes inside stored BSR tiles) are
    absent and stay zero whatever f(0). ``f`` is a unary op (named, for
    BSR). On a sharded operand the map runs on each row shard in place,
    and the descriptor blend composes shard-local merges."""
    _sharded_pair_mesh("apply", x, None, out)       # mixed-out contract
    kind, X = _operand_kind(x)
    if kind == "sharded":
        res = X.apply_stored(f)
        C = _sharded_out(out, "apply", X.mesh, X.shape)
        return GBMatrix(_sharded_blend(d, res, C))
    if kind == "dense":
        raw = torch.where(X != 0, f(X), torch.zeros_like(X))
        return _structural_finalize_dense(d, raw, _dense_out(out, "apply"))
    if kind == "bsr":
        res = _bsr.apply_stored(X, f)
        C = _sparse_out_bsr(out, "apply", X.block)
        return GBMatrix(_structural_finalize_bsr(d, res, C))
    k, v = _ell_entries(X)
    k, v = _coo.nonzero(k, _coo.call_op(f, v))
    return GBMatrix(_structural_finalize_ell(d, k, v, out, "apply", X.shape,
                                             X.device))


def select(pred: Callable, x, d: Descriptor = NULL, out=None):
    """C<M> accum= A where pred(A) — GxB_select over stored entries, with
    the descriptor semantics of :func:`apply`; sparse results prune tiles
    the predicate emptied. ``pred`` is a predicate (named, for BSR).
    Sharded operands stay on their mesh, as in :func:`apply`."""
    _sharded_pair_mesh("select", x, None, out)      # mixed-out contract
    kind, X = _operand_kind(x)
    if kind == "sharded":
        res = X.select_stored(pred)
        C = _sharded_out(out, "select", X.mesh, X.shape)
        return GBMatrix(_sharded_blend(d, res, C))
    if kind == "dense":
        raw = torch.where((X != 0) & pred(X), X, torch.zeros_like(X))
        return _structural_finalize_dense(d, raw, _dense_out(out, "select"))
    if kind == "bsr":
        res = _bsr.select_stored(X, pred)
        C = _sparse_out_bsr(out, "select", X.block)
        return GBMatrix(_structural_finalize_bsr(d, res, C))
    k, v = _ell_entries(X)
    keep = _coo.call_op(pred, v) != 0
    return GBMatrix(_structural_finalize_ell(d, k[keep], v[keep], out,
                                             "select", X.shape, X.device))


# ---------------------------------------------------------------------------
# reduce — GrB_reduce
# ---------------------------------------------------------------------------
# plus / or over stored entries accumulate in float64 (exact for integer
# sums below 2^53; the JAX package sums in float32, which is not exact
# past 2^24) and return ``dtype``, float32 by default as in the JAX package.

def _finish(out: torch.Tensor, monoid: S.Monoid, dtype) -> torch.Tensor:
    return (out > 0).to(dtype) if monoid.name == "or" else out.to(dtype)


def _reduce_bsr(s: BSR, monoid: S.Monoid, axis, dtype) -> torch.Tensor:
    if monoid.name not in ("plus", "or") or axis not in (None, 0, 1):
        # min / max need the absent entries (dense zeros) to take part
        return monoid.reduce(s.to_dense(), dim=axis).to(dtype)
    if not s.holds_tiles:
        # an entry-held handle sums its entries and builds no tiles
        csr = s.row_csr()
        v = csr.vals.to(torch.float64)
        if monoid.name == "or":
            v = (v != 0).to(torch.float64)
        if axis is None:
            return _finish(v.sum(), monoid, dtype)
        idx = _bsr.csr_rows(csr) if axis == 1 else csr.cols.long()
        out = torch.zeros(s.shape[0] if axis == 1 else s.shape[1],
                          dtype=torch.float64, device=s.device)
        out.index_add_(0, idx, v)
        return _finish(out, monoid, dtype)
    v = s.blocks if monoid.name == "plus" else (s.blocks != 0)
    valid = s.valid.to(torch.float64)
    if axis is None:
        tot = (torch.sum(v, dim=(1, 2), dtype=torch.float64) * valid).sum()
        return _finish(tot, monoid, dtype)
    per = torch.sum(v, dim=2 if axis == 1 else 1, dtype=torch.float64)
    per = per * valid[:, None]                              # (nnzb, block)
    seg = s.block_rows if axis == 1 else s.block_cols
    nseg = s.nbrows if axis == 1 else s.nbcols
    out = torch.zeros((nseg, s.block), dtype=torch.float64, device=s.device)
    out.index_add_(0, seg.long(), per)
    out = out.reshape(-1)[:s.shape[0] if axis == 1 else s.shape[1]]
    return _finish(out, monoid, dtype)


def _reduce_ell(e: ELL, monoid: S.Monoid, axis, dtype) -> torch.Tensor:
    if monoid.name not in ("plus", "or") or axis not in (None, 0, 1):
        return monoid.reduce(e.to_dense(), dim=axis).to(dtype)
    w = (e.values * e.mask).to(torch.float64)
    if monoid.name == "or":
        w = (w != 0).to(torch.float64)
    if axis is None:
        return _finish(w.sum(), monoid, dtype)
    if axis == 1:
        return _finish(w.sum(dim=1), monoid, dtype)
    m = e.shape[1]
    ids = torch.where(e.mask, e.indices, m).reshape(-1).long()
    out = torch.zeros(m + 1, dtype=torch.float64, device=e.device)
    out.index_add_(0, ids, w.reshape(-1))
    return _finish(out[:m], monoid, dtype)


def _reduce_delta(h: GBMatrix, monoid: S.Monoid, axis, dtype) -> torch.Tensor:
    """Delta-composed reduce for plus / or, no rebuild: per row (axis 1)
    the base's reduce with the patch's rows scattered over it (the row
    decomposition of ``_mxm_delta``); per column (axis 0) the per-row
    reduce of the linked transpose twin; the full reduction folds the
    per-row vector. min / max, and axis 0 without a delta twin, take a
    materialization."""
    dm: DeltaMatrix = h.store
    if monoid.name in ("plus", "or"):
        if axis == 1:
            rb = reduce(dm.base, monoid, axis=1, dtype=dtype)
            if monoid.name == "or":
                # "any stored entry" for every base (a dense base's raw
                # max would leak non-indicator values)
                rb = (rb != 0).to(dtype)
            n, bn = dm.shape[0], dm.base.shape[0]
            if n > bn:
                rb = torch.cat([rb, torch.zeros(n - bn, dtype=rb.dtype,
                                                device=rb.device)])
            patch, rows = dm.patch()
            if patch is None:
                return rb
            t = dm.touched
            rp = _reduce_ell(patch, monoid, 1, dtype)
            return rb.index_copy(0, rows[:t].long(), rp[:t])
        if axis == 0 and h._T is not None and h._T.fmt == "delta":
            return _reduce_delta(h._T, monoid, 1, dtype)
        if axis is None:
            tot = _reduce_delta(h, monoid, 1, torch.float64).sum()
            return _finish(tot, monoid, dtype)
    return reduce(dm.materialize(), monoid, axis=axis, dtype=dtype)


def reduce(x, monoid: S.Monoid, axis=None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Monoid reduction (GrB_reduce). Sparse operands reduce over *stored*
    entries without densifying for plus and or — full (axis None), per
    column (0) and per row (1); "or" means "any stored entry", right for
    negative values. min / max need the absent entries and go through
    to_dense(). BitELL counts straight off its bit-tiles; delta operands
    compose plus / or from their base and patch (``_reduce_delta``). Sharded
    operands reduce on the mesh: plus / or with per-row sums shard-local
    and full / per-column sums a psum over "data", min / max with a
    stored-entry pmin / pmax and a stored-count compare
    (``graph2d.reduce_minmax_2d``). Sparse plus sums accumulate in
    float64; the result has ``dtype``."""
    s = x.store if isinstance(x, GBMatrix) else x
    if isinstance(s, DeltaMatrix):
        return _reduce_delta(x if isinstance(x, GBMatrix) else GBMatrix(s),
                             monoid, axis, dtype)
    if monoid.name in ("plus", "or") and axis in (None, 0, 1):
        if isinstance(s, BitELL):
            return _bitadj.reduce_stored(s, monoid, axis, dtype)
        if isinstance(s, ShardedBitELL):
            return _bitadj.sharded_reduce_stored(s, monoid, axis, dtype)
    kind, X = _operand_kind(s)
    if kind == "bsr":
        return _reduce_bsr(X, monoid, axis, dtype)
    if kind == "ell":
        return _reduce_ell(X, monoid, axis, dtype)
    if kind == "sharded":
        if axis in (None, 0, 1):
            if monoid.name in ("plus", "or"):
                return _shard.reduce_stored(X, monoid, axis).to(dtype)
            if monoid.name in ("min", "max"):
                return _shard.reduce_minmax(X, monoid, axis).to(dtype)
        return monoid.reduce(X.to_dense(), dim=axis).to(dtype)  # counted
    return monoid.reduce(X.to(dtype), dim=axis)


# ---------------------------------------------------------------------------
# extract / assign — GrB_extract / GrB_assign
# ---------------------------------------------------------------------------
def _norm_index(idx, n: int, fn: str) -> np.ndarray:
    """A rows= / cols= argument as a unique int64 index vector."""
    if idx is None:
        return np.arange(n, dtype=np.int64)
    if isinstance(idx, slice):
        idx = range(*idx.indices(n))
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    idx = np.asarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        raise TypeError(f"grb.{fn}: indices must be 1-D (got ndim={idx.ndim})")
    if len(idx) and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"grb.{fn}: index out of range for extent {n}")
    if len(np.unique(idx)) != len(idx):
        raise ValueError(f"grb.{fn}: duplicate indices are not supported")
    return idx


def _is_aligned_range(idx: np.ndarray, block: int) -> bool:
    return (len(idx) > 0 and idx[0] % block == 0
            and bool(np.all(np.diff(idx) == 1)))


def extract(A, rows=None, cols=None, d: Descriptor = NULL, out=None):
    """C<M> accum= A[rows, cols] — GrB_extract. rows / cols: None (all), a
    slice or range, or a unique index vector. Dense tensors give dense
    tensors; sparse operands stay sparse (BSR by tile surgery when both
    ranges are contiguous and block-aligned, COO relabeling otherwise).
    The descriptor applies to the (len(rows), len(cols)) result. Sharded
    operands stay on their mesh for column subsets (rows=None: a
    shard-local LUT relabel); row subsets re-partition the "data" axis and
    take the counted gather."""
    mesh = _sharded_pair_mesh("extract", A, None, out)
    if mesh is not None:
        SA = _operand_kind(A)[1]
        n, m = SA.shape
        I = _norm_index(rows, n, "extract")
        J = _norm_index(cols, m, "extract")
        if rows is None or (len(I) == n and np.array_equal(I, np.arange(n))):
            sub = _shard.extract_cols(SA, J)
            C = _sharded_out(out, "extract", mesh, sub.shape)
            return GBMatrix(_sharded_blend(d, sub, C))
        return distribute(extract(_unshard(A), rows, cols, d, _unshard(out)),
                          mesh)
    kind, SA = _operand_kind(A)
    n, m = SA.shape
    I = _norm_index(rows, n, "extract")
    J = _norm_index(cols, m, "extract")
    if kind == "dense":
        dev = SA.device
        raw = SA[torch.from_numpy(I).to(dev)][:, torch.from_numpy(J).to(dev)]
        return _structural_finalize_dense(d, raw, _dense_out(out, "extract"))
    if kind == "bsr":
        if _is_aligned_range(I, SA.block) and _is_aligned_range(J, SA.block):
            sub = _bsr.extract_ranges(SA, int(I[0]), int(I[-1]) + 1,
                                      int(J[0]), int(J[-1]) + 1)
        else:
            rr, cc, vv = _coo.extract_entries(*SA.to_coo(), I, J, n, m)
            sub = BSR.from_coo(rr, cc, vv, (len(I), len(J)), block=SA.block,
                               device=SA.device)
        C = _sparse_out_bsr(out, "extract", sub.block)
        return GBMatrix(_structural_finalize_bsr(d, sub, C))
    rr, cc, vv = _coo.extract_entries(*SA.to_coo(), I, J, n, m)
    k = _coo.keys_of(rr, cc, max(len(J), 1))
    return GBMatrix(_structural_finalize_ell(d, k, vv, out, "extract",
                                             (len(I), len(J)), SA.device))


def _assign_sharded_cols(C, sc: ShardedELL, A, J: np.ndarray,
                         d: Descriptor):
    """C(:, J)<M> accum= A with C sharded, on the mesh: the region (all
    rows x J) splits from the rest of C by shard-local column LUTs, the
    blend runs on the (n, len(J)) region in local coordinates, and the
    result relabels back into global columns and unions with the
    untouched entries (disjoint patterns: the merge never consults the
    op)."""
    n, m = sc.shape
    ka, sa = _operand_kind(A)
    if tuple(sa.shape) != (n, len(J)):
        raise ValueError(f"grb.assign: A shape {tuple(sa.shape)} != region "
                         f"{(n, len(J))}")
    if len(J) == 0:
        return C if isinstance(C, GBMatrix) else sc
    if ka == "sharded":
        if sa.mesh != sc.mesh:
            raise TypeError("grb.assign: sharded operands live on different "
                            "meshes — distribute both onto one mesh")
    else:
        # place the region operand on C's mesh (a put, not a gather)
        if ka == "dense":
            e = ELL.from_dense(sa, device=sc.device)
        elif isinstance(sa, ELL):
            e = sa
        else:
            e = ELL.from_coo(*sa.to_coo(), sa.shape, device=sa.device)
        sa = ShardedELL.from_ell(e, sc.mesh)
    lut_out = np.arange(m, dtype=np.int32)
    lut_out[J] = -1
    c_out = _shard.relabel_cols(sc, lut_out, m)     # entries outside region
    c_in = _shard.extract_cols(sc, J)               # region, local coords
    blended = _sharded_blend(d, sa, c_in)
    back = _shard.relabel_cols(blended, np.asarray(J, np.int32), m)
    return GBMatrix(_shard.merge_stored(c_out, back, _disjoint_concat,
                                        "union"))


def assign(C, A, rows=None, cols=None, d: Descriptor = NULL):
    """C(rows, cols)<M> accum= A — GrB_assign, functional (C is not
    mutated; a new handle or tensor of C's kind is returned).

    A is (len(rows), len(cols)), and so is the descriptor mask. Without
    accum or mask the region's pattern is *replaced* by A's. Sparse C stays
    sparse: its entries split by region on the host and the blend runs on
    COO entry sets. Sharded C stays on its mesh for column regions
    (rows=None: LUT relabels and merges, shard-local); row subsets
    re-partition the "data" axis and take the counted gather. A may be
    sharded beside C (same mesh) or unsharded (placed on the mesh)."""
    if _sharded_store(C) is not None or _sharded_store(A) is not None:
        kc, sc = _operand_kind(C)
        if kc != "sharded":
            raise TypeError(
                "grb.assign: A is sharded but C is not — operand kinds must "
                "match; distribute C (grb.distribute) or gather A "
                "(A.to_ell())")
        n, m = sc.shape
        I = _norm_index(rows, n, "assign")
        J = _norm_index(cols, m, "assign")
        if rows is None or (len(I) == n and np.array_equal(I, np.arange(n))):
            return _assign_sharded_cols(C, sc, A, J, d)
        return distribute(assign(_unshard(C), _unshard(A), rows, cols, d),
                          sc.mesh)
    kindC, SC = _operand_kind(C)
    n, m = SC.shape
    I = _norm_index(rows, n, "assign")
    J = _norm_index(cols, m, "assign")
    kindA, SA = _operand_kind(A)
    if tuple(SA.shape) != (len(I), len(J)):
        raise ValueError(f"grb.assign: A shape {tuple(SA.shape)} != region "
                         f"{(len(I), len(J))}")
    if len(I) == 0 or len(J) == 0:
        return C if isinstance(C, GBMatrix) else SC
    if kindC == "dense":
        subA = SA if kindA == "dense" else SA.to_dense()
        Ij = torch.from_numpy(I).to(SC.device)
        Jj = torch.from_numpy(J).to(SC.device)
        blended = _structural_finalize_dense(d, subA, SC[Ij][:, Jj])
        res = SC.clone()
        res[Ij[:, None], Jj[None, :]] = blended
        return res
    # sparse C: split stored entries by region, blend the local entry set,
    # reassemble — COO set algebra end to end
    r, c, v = SC.to_coo()
    lutr = np.full(n, -1, dtype=np.int64)
    lutr[I] = np.arange(len(I))
    lutc = np.full(m, -1, dtype=np.int64)
    lutc[J] = np.arange(len(J))
    inreg = (lutr[r] >= 0) & (lutc[c] >= 0)
    w = len(J)
    kc = _coo.keys_of(lutr[r[inreg]], lutc[c[inreg]], w)
    vc = np.asarray(v[inreg], np.float32)
    if kindA == "dense":
        dense = SA.cpu().numpy()
        ar, ac = np.nonzero(dense)
        ka = _coo.keys_of(ar, ac, w)
        va = dense[ar, ac].astype(np.float32)
    else:
        ka, va = _ell_entries(SA)
    mk = None if d.mask is None else _mask_entry_keys(d.mask,
                                                      (len(I), len(J)))
    accum_op = None if d.accum is None else d.accum.op
    k, val = _coo.blend(ka, va, kc, vc, mk, d.complement, accum_op,
                        d.replace)
    k, val = _coo.nonzero(k, val)
    gr = np.concatenate([r[~inreg], I[k // w]])
    gc = np.concatenate([c[~inreg], J[k % w]])
    gv = np.concatenate([np.asarray(v[~inreg], np.float32), val])
    if kindC == "bsr":
        store = BSR.from_coo(gr, gc, gv, (n, m), block=SC.block,
                             device=SC.device)
    else:
        store = ELL.from_coo(gr, gc, gv, (n, m), device=SC.device)
    return GBMatrix(store)

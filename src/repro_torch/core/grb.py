"""The GraphBLAS operation surface ``C<M> accum= op(A, B, desc)``, over torch.

Port of ``repro.core.grb``, cut to what the k-hop MATCH path reaches:

  Descriptor / finalize   the write blend (mask, complement, accum,
                          replace, transpose_a);
  GBMatrix                one handle over BSR, ELL or BitELL storage, with
                          a linked stored transpose (``.T``); ``with_impl``
                          is a no-op kept for parity;
  mxm                     the semiring matmul on a dense (k, F) frontier:
                          BSR through ``kernels.bsr_mxm`` with a pure
                          masked write fused into its epilogue, ELL float
                          route, or the bitmap-packed or_and route; BitELL
                          under a non-or_and semiring takes the cached
                          materialize-to-ELL fallback; BSR x BSR (a sparse
                          B handle) through SpGEMM, staying BSR;
  mxm_words               packed words in, packed words out — the per-hop
                          call of word-resident hop loops (BSR detours
                          through the float mxm on the device);
  words_route_ok          the gate for those loops.

Where the JAX package asks ``jax.default_backend() == "tpu"`` (and, for
BSR, its measured crossover) before taking a Pallas kernel, the port asks
where the tensors lie: CUDA tensors launch the hand-written kernels
(``kernels.ops``) at every width and fill, CPU tensors take their plain
versions. Dense, delta and sharded storage and the element-wise family
are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import bitmap as _bitmap
from repro_torch.core import bsr as _bsr
from repro_torch.core import ops as _ops
from repro_torch.core import semiring as S
from repro_torch.core import xfer as _xfer
from repro_torch.core.bitadj import BitELL
from repro_torch.core.bsr import BSR, SPGEMM_MODES as _SPGEMM_MODES
from repro_torch.core.ell import ELL

Storage = Union[BSR, ELL, BitELL]


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
    raise NotImplementedError(
        f"storage {type(store).__name__} is not ported yet: the port holds "
        f"BSR, ELL and BitELL (ROADMAP 'Modules to port' lists dense, delta "
        f"and sharded storage)")


# -- the JAX package's BSR crossover (measured there on XLA-CPU for a TPU by
# benchmarks/bench_triangles.py), kept for parity. The port does not read
# them: every BSR mxm / spgemm on CUDA tensors launches its kernel, at any
# width and fill; a crossover measured on the card is open (ROADMAP).
AUTO_MIN_GRID = 4     # block-rows/-cols below this: one dense matmul wins
AUTO_MAX_FILL = 0.25  # stored-tile fill above this: effectively dense
AUTO_MIN_WIDTH = 8    # B frontier narrower than this: XLA (auto handles only)


# -- bitmap-packed frontier policy (the JAX package's value, measured there
# by benchmarks/bench_khop.run_packed): an or_and mxm on ELL packs its
# frontier when it is at least this wide; BitELL always packs; BSR never
# does (its or_and route is the indicator tile product).
AUTO_PACK_MIN_WIDTH = 8


def _pack_wanted(f: int) -> bool:
    """Width side of the packed-frontier policy."""
    return f >= AUTO_PACK_MIN_WIDTH


class GBMatrix:
    """One matrix handle over BSR / ELL / BitELL storage, with a lazily
    built or explicitly linked stored transpose (``A.T``). The route is
    chosen by where the storage lies (CUDA kernel or plain version), so the
    handle carries no execution policy."""
    __slots__ = ("store", "fmt", "name", "_T")

    def __init__(self, store: Storage, name: str = ""):
        if isinstance(store, GBMatrix):
            store = store.store
        self.store = store
        self.fmt = _fmt_of(store)
        self.name = name
        self._T: Optional["GBMatrix"] = None

    @classmethod
    def wrap(cls, A) -> "GBMatrix":
        """Adopt an existing handle or wrap raw storage."""
        return A if isinstance(A, GBMatrix) else cls(A)

    @property
    def shape(self):
        return self.store.shape

    @property
    def nvals(self) -> int:
        """Stored-entry count (GrB_Matrix_nvals)."""
        return self.store.nnz

    @property
    def T(self) -> "GBMatrix":
        """Stored transpose, built once and cached; ``A.T.T is A``."""
        if self._T is None:
            self.link_transpose(GBMatrix(self.store.transpose(),
                                         name=self.name + "^T"))
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

    def __repr__(self) -> str:
        n, m = self.shape
        tag = f" {self.name!r}" if self.name else ""
        return f"GBMatrix{tag} {n}x{m} fmt={self.fmt} nvals={self.nvals}"


# ---------------------------------------------------------------------------
# GrB_mxm
# ---------------------------------------------------------------------------
def _packed_route_ok(A: GBMatrix, B: torch.Tensor, sr: S.Semiring) -> bool:
    """Gate for the bitmap-packed or_and route: boolean semiring, and ELL
    with a frontier wide enough, or BitELL at any width (BSR keeps its
    indicator tile product)."""
    if sr.mode != "dot_indicator" or B.dim() != 2:
        return False
    if A.fmt == "bitadj":
        return True                          # structural: words always win
    return A.fmt == "ell" and _pack_wanted(B.shape[1])


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


def _mask_as_bsr(mask, block: int) -> Optional[BSR]:
    """Structural BSR view of a descriptor mask for the SpGEMM path: a
    handle is unwrapped, sparse masks convert through their entry lists
    (BitELL by way of ELL), a dense tensor is tiled."""
    if isinstance(mask, GBMatrix):
        mask = mask.store
    if mask is None:
        return None
    if isinstance(mask, BitELL):
        mask = mask.to_ell()
    if isinstance(mask, (BSR, ELL)):
        return _bsr.as_bsr(mask, block)
    return BSR.from_dense(mask, block=block)


def _mxm_spgemm(A: GBMatrix, B: GBMatrix, sr: S.Semiring,
                d: Descriptor) -> GBMatrix:
    """Sparse-times-sparse dispatch: C<M> = A (x) B with C staying BSR. The
    mask prunes whole output tiles in the symbolic phase (not
    complemented) and applies element-wise in the kernel's epilogue."""
    mask = _mask_as_bsr(d.mask, A.store.block)
    C = _bsr.spgemm(A.store, B.store, sr, mask=mask, complement=d.complement)
    name = f"({A.name}x{B.name})" if (A.name or B.name) else ""
    return GBMatrix(C, name=name)


def mxm(A, B, sr: S.Semiring, d: Descriptor = NULL,
        out: Optional[torch.Tensor] = None):
    """C<M> accum= A (x) B over a semiring. A: GBMatrix (or raw BSR / ELL /
    BitELL). B: a dense (k, F) frontier (returns a dense C), or a BSR
    handle when A is BSR (SpGEMM, returns a BSR handle; out must be None
    and the semiring a dot mode). ``out`` is the existing C for
    accum/blend, None meaning replace-into-empty."""
    A = GBMatrix.wrap(A)
    if d.transpose_a:
        A = A.T
        d = d.with_(transpose_a=False)
    if isinstance(B, BSR):
        B = GBMatrix(B)
    if isinstance(B, GBMatrix):
        if (A.fmt == "bsr" and B.fmt == "bsr" and out is None
                and sr.mode in _SPGEMM_MODES):
            return _mxm_spgemm(A, B, sr, d)
        raise TypeError(
            f"grb.mxm: a sparse B multiplies only as BSR x BSR under a dot "
            f"semiring with out=None (got {A.fmt} x {B.fmt}, {sr.name}); "
            f"other sparse B operands are not ported yet")
    if not isinstance(B, torch.Tensor) or B.dim() != 2:
        raise TypeError("grb.mxm: B must be a dense (k, F) frontier tensor "
                        "or a BSR handle")
    if d.mask is not None and not isinstance(d.mask, torch.Tensor):
        raise TypeError("grb.mxm: with a dense B the port takes dense "
                        "tensor masks only")
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
    CUDA tensors and runs its plain version for CPU tensors. BSR has no
    packed route: it detours through the float mxm (the ``bsr_mxm``
    kernel) on the device and re-packs; ``words_route_ok`` keeps hop loops
    off that detour."""
    from repro_torch.kernels import ops as kops   # lazy: kernels import core
    A = GBMatrix.wrap(A)
    if transpose_a:
        A = A.T
    if A.fmt == "bitadj":
        return kops.bitadj_mxv_packed(A.store, Bw)
    if A.fmt == "ell":
        return kops.ell_mxv_packed(A.store, Bw)
    f = Bw.shape[1] * _bitmap.WORD_BITS
    return _bitmap.pack(mxm(A, _bitmap.unpack(Bw, f), S.OR_AND))


def words_route_ok(A, f: int) -> bool:
    """Gate for word-resident hop loops: BitELL always (the adjacency
    itself is packed), ELL when the packing policy wants a width-``f``
    frontier packed, BSR never (it keeps the float hop loop)."""
    A = GBMatrix.wrap(A)
    if A.fmt == "bitadj":
        return True
    return A.fmt == "ell" and _pack_wanted(f)

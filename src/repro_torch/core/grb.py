"""The GraphBLAS operation surface ``C<M> accum= op(A, B, desc)``, over torch.

Port of ``repro.core.grb``, cut to what the k-hop MATCH path reaches:

  Descriptor / finalize   the write blend (mask, complement, accum,
                          replace, transpose_a);
  GBMatrix                one handle over ELL or BitELL storage, with a
                          linked stored transpose (``.T``); ``with_impl``
                          is a no-op kept for parity;
  mxm                     the semiring matmul on a dense (k, F) frontier:
                          ELL float route, or the bitmap-packed or_and
                          route; BitELL under a non-or_and semiring takes
                          the cached materialize-to-ELL fallback;
  mxm_words               packed words in, packed words out — the per-hop
                          call of word-resident hop loops;
  words_route_ok          the gate for those loops.

Where the JAX package asks ``jax.default_backend() == "tpu"`` before taking
a Pallas kernel, the port asks where the tensors lie: CUDA tensors launch
the hand-written kernels (``kernels.ops``), CPU tensors take their plain
versions. Dense, BSR, delta and sharded storage and the element-wise family
are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import bitadj as _bitadj
from repro_torch.core import bitmap as _bitmap
from repro_torch.core import ops as _ops
from repro_torch.core import semiring as S
from repro_torch.core import xfer as _xfer
from repro_torch.core.bitadj import BitELL
from repro_torch.core.ell import ELL

Storage = Union[ELL, BitELL]


# ---------------------------------------------------------------------------
# Descriptor — GrB_Descriptor analog
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Descriptor:
    """Operation modifiers for one GraphBLAS call.

    mask        dense write mask M (same shape as the output)
    complement  use !M instead of M (GrB_COMP)
    accum       accumulate monoid: C<M> accum= result
    replace     clear C entries outside the mask (GrB_REPLACE)
    transpose_a op reads A^T, served from the handle's stored transpose
    """
    mask: Optional[torch.Tensor] = None
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
    if isinstance(store, ELL):
        return "ell"
    if isinstance(store, BitELL):
        return "bitadj"
    raise NotImplementedError(
        f"storage {type(store).__name__} is not ported yet: the port holds "
        f"ELL and BitELL (ROADMAP 'Modules to port' lists dense, BSR, delta "
        f"and sharded storage)")


# -- bitmap-packed frontier policy (the JAX package's value, measured there
# by benchmarks/bench_khop.run_packed): an or_and mxm on ELL packs its
# frontier when it is at least this wide; BitELL always packs.
AUTO_PACK_MIN_WIDTH = 8


def _pack_wanted(f: int) -> bool:
    """Width side of the packed-frontier policy."""
    return f >= AUTO_PACK_MIN_WIDTH


class GBMatrix:
    """One matrix handle over ELL / BitELL storage, with a lazily built or
    explicitly linked stored transpose (``A.T``). The route is chosen by
    where the storage lies (CUDA kernel or plain version), so the handle
    carries no execution policy."""
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
    with a frontier wide enough, or BitELL at any width."""
    if sr.mode != "dot_indicator" or B.dim() != 2:
        return False
    if A.fmt == "bitadj":
        return True                          # structural: words always win
    return _pack_wanted(B.shape[1])


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


def mxm(A, B: torch.Tensor, sr: S.Semiring, d: Descriptor = NULL,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C<M> accum= A (x) B over a semiring. A: GBMatrix (or raw ELL /
    BitELL); B: a dense (k, F) frontier; ``out`` is the existing C for
    accum/blend, None meaning replace-into-empty."""
    A = GBMatrix.wrap(A)
    if not isinstance(B, torch.Tensor) or B.dim() != 2:
        raise TypeError("grb.mxm: B must be a dense (k, F) frontier tensor "
                        "(sparse B operands are not ported yet)")
    if d.mask is not None and not isinstance(d.mask, torch.Tensor):
        raise TypeError("grb.mxm: the port takes dense tensor masks only")
    if d.transpose_a:
        A = A.T
        d = d.with_(transpose_a=False)
    if A.fmt == "bitadj" and not _packed_route_ok(A, B, sr):
        # weighted / non-indicator call on structural storage: the cached
        # materialize-to-ELL fallback
        A = GBMatrix(A.store.to_ell(), name=A.name)
    if _packed_route_ok(A, B, sr):
        return _mxm_packed(A, B, sr, d, out)
    return finalize(d, _ops.ell_mxm(A.store, B, sr), out, sr.identity)


def host_transfers() -> int:
    """Device->host gathers inside op dispatch since process start
    (``core.xfer``)."""
    return _xfer.host_transfers()


def mxm_words(A, Bw: torch.Tensor, transpose_a: bool = False) -> torch.Tensor:
    """or_and mxm with the frontier already bitmap-packed: (k, W) words in,
    (rows, W) words out. No descriptor: callers blend masks word-wise. ELL
    goes to ``kernels.ops.ell_mxv_packed``, BitELL to
    ``kernels.ops.bitadj_mxv_packed``; each launches its CUDA kernel for
    CUDA tensors and runs its plain version for CPU tensors."""
    from repro_torch.kernels import ops as kops   # lazy: kernels import core
    A = GBMatrix.wrap(A)
    if transpose_a:
        A = A.T
    if A.fmt == "bitadj":
        return kops.bitadj_mxv_packed(A.store, Bw)
    return kops.ell_mxv_packed(A.store, Bw)


def words_route_ok(A, f: int) -> bool:
    """Gate for word-resident hop loops: BitELL always (the adjacency
    itself is packed), ELL when the packing policy wants a width-``f``
    frontier packed."""
    A = GBMatrix.wrap(A)
    if A.fmt == "bitadj":
        return True
    return _pack_wanted(f)

"""GraphBLAS semirings over torch tensors.

Port of ``repro.core.semiring``. A semiring is (add monoid, multiply op);
``mode`` names how a matmul computes it, as in the JAX package:

  dot            plus_times  acc += A @ X
  dot_indicator  or_and      acc |= (A != 0) @ (X != 0) > 0
  dot_pair       plus_pair   acc += (A != 0) @ (X != 0)
  dot_first      plus_first  acc += A @ (X != 0)
  bcast          min_plus / max_plus, a broadcast-reduce (not a product)

``dense_mxm`` is the dense oracle every sparse route is held against, and
``structural_dense`` encodes absent entries for it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Monoid:
    name: str
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    identity: float

    def reduce(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.name == "plus":
            return torch.sum(x, dim=dim)
        if self.name in ("or", "max"):
            return torch.amax(x, dim=dim)
        if self.name == "min":
            return torch.amin(x, dim=dim)
        raise NotImplementedError(self.name)


PLUS = Monoid("plus", lambda a, b: a + b, 0.0)
MIN = Monoid("min", torch.minimum, float("inf"))
MAX = Monoid("max", torch.maximum, float("-inf"))
OR = Monoid("or", torch.maximum, 0.0)  # over {0,1} indicators


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    add: Monoid
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    mode: str           # dot | dot_indicator | dot_pair | dot_first | bcast

    @property
    def identity(self) -> float:
        return self.add.identity


def _pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a != 0) & (b != 0)).to(torch.float32)


def _first(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    del b
    return a


PLUS_TIMES = Semiring("plus_times", PLUS, lambda a, b: a * b, mode="dot")
OR_AND = Semiring("or_and", OR, _pair, mode="dot_indicator")
PLUS_PAIR = Semiring("plus_pair", PLUS, _pair, mode="dot_pair")
MIN_PLUS = Semiring("min_plus", MIN, lambda a, b: a + b, mode="bcast")
MAX_PLUS = Semiring("max_plus", MAX, lambda a, b: a + b, mode="bcast")
PLUS_FIRST = Semiring("plus_first", PLUS, _first, mode="dot_first")

SEMIRINGS = {s.name: s for s in [PLUS_TIMES, OR_AND, PLUS_PAIR, MIN_PLUS,
                                 MAX_PLUS, PLUS_FIRST]}


def get(name: str) -> Semiring:
    return SEMIRINGS[name]


def _ind(x: torch.Tensor) -> torch.Tensor:
    return (x != 0).to(torch.float32)


def dense_mxm(A: torch.Tensor, B: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Reference semiring matmul on dense operands:
    Y[i,f] = add_j mul(A[i,j], B[j,f]).

    Structural semantics: an entry of A is stored iff nonzero (for bcast,
    iff not the add identity: encode with ``structural_dense``). B is a
    dense operand; in bcast every entry of it participates."""
    A = A.to(torch.float32)
    B = B.to(torch.float32)
    if sr.mode == "dot":
        return A @ B
    if sr.mode == "dot_indicator":
        return ((_ind(A) @ _ind(B)) > 0).to(torch.float32)
    if sr.mode == "dot_pair":
        return _ind(A) @ _ind(B)
    if sr.mode == "dot_first":
        return A @ _ind(B)
    if sr.mode == "bcast":
        # chunk the inner dimension to bound the (n, chunk, f) intermediate
        n, k = A.shape
        f = B.shape[1]
        acc = torch.full((n, f), sr.identity, dtype=torch.float32,
                         device=A.device)
        chunk = max(1, min(k, 4096 // max(1, f // 64 or 1)))
        for start in range(0, k, chunk):
            a = A[:, start:start + chunk]
            b = B[start:start + chunk, :]
            part = sr.add.reduce(sr.mul(a[:, :, None], b[None, :, :]), dim=1)
            acc = sr.add.op(acc, part)
        return acc
    raise NotImplementedError(sr.mode)


def structural_dense(A: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Encode a 0/weight dense matrix for ``dense_mxm``: tropical semirings
    need absent entries to be the add identity, not 0."""
    if sr.mode == "bcast":
        return torch.where(A != 0, A.to(torch.float32),
                           torch.tensor(sr.identity, dtype=torch.float32,
                                        device=A.device))
    return A

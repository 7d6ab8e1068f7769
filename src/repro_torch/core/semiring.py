"""GraphBLAS semirings over torch tensors.

Port of ``repro.core.semiring``. A semiring is (add monoid, multiply op);
``mode`` names how a matmul computes it, as in the JAX package:

  dot            plus_times  acc += A @ X
  dot_indicator  or_and      acc |= (A != 0) @ (X != 0) > 0
                 any_pair    the same ("pick any witness": an alias of
                             or_and on structure, taking its routes)
  dot_pair       plus_pair   acc += (A != 0) @ (X != 0)
  dot_first      plus_first  acc += A @ (X != 0)
  bcast          min_plus / max_plus, a broadcast-reduce (not a product)

``dense_mxm`` is the dense oracle every sparse route is held against, and
``structural_dense`` encodes absent entries for it.

Element-wise ops are named (``ewise``): the BSR element-wise kernel cannot
call a Python function, so it takes an op code and one float32 scalar. An
``EwiseOp`` is also a plain callable on tensors, so the same object serves
dense and ELL operands, and each ``Monoid``'s op is one (``or`` is ``max``
over 0/1 indicators, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


# name -> (kind, kernel code, function of the operands and the scalar). The
# codes are ``csrc/bsr_ewise.cu``'s.
_EWISE = {
    "plus": ("binary", 0, lambda a, b, s: a + b),
    "times": ("binary", 1, lambda a, b, s: a * b),
    "min": ("binary", 2, lambda a, b, s: torch.minimum(a, b)),
    "max": ("binary", 3, lambda a, b, s: torch.maximum(a, b)),
    "first": ("binary", 4, lambda a, b, s: a),
    "second": ("binary", 5, lambda a, b, s: b),
    "pair": ("binary", 6, lambda a, b, s: torch.ones_like(a)),
    "minus": ("binary", 7, lambda a, b, s: a - b),
    "identity": ("unary", 8, lambda a, s: a),
    "ainv": ("unary", 9, lambda a, s: -a),
    "abs": ("unary", 10, lambda a, s: torch.abs(a)),
    "one": ("unary", 11, lambda a, s: torch.ones_like(a)),
    "mul": ("unary", 12, lambda a, s: a * s),
    "add": ("unary", 13, lambda a, s: a + s),
    "ge": ("predicate", 14, lambda a, s: a >= s),
    "gt": ("predicate", 15, lambda a, s: a > s),
    "le": ("predicate", 16, lambda a, s: a <= s),
    "lt": ("predicate", 17, lambda a, s: a < s),
    "eq": ("predicate", 18, lambda a, s: a == s),
    "ne": ("predicate", 19, lambda a, s: a != s),
}
_SCALAR_OPS = ("mul", "add", "ge", "gt", "le", "lt", "eq", "ne")


@dataclasses.dataclass(frozen=True)
class EwiseOp:
    """A named element-wise op: ``kind`` is "binary", "unary" or
    "predicate", ``scalar`` the float32 operand of mul / add and of the
    comparisons. Calling it applies its torch function."""
    name: str
    scalar: float = 0.0

    @property
    def kind(self) -> str:
        return _EWISE[self.name][0]

    @property
    def code(self) -> int:
        return _EWISE[self.name][1]

    def __call__(self, *operands):
        return _EWISE[self.name][2](*operands, self.scalar)

    def __str__(self) -> str:
        return (f"{self.name}({self.scalar:g})" if self.name in _SCALAR_OPS
                else self.name)


def ewise(name: str, scalar=None) -> EwiseOp:
    """The named op ``name`` (``ewise_names()``); mul, add and the
    comparisons take a scalar, rounded to float32 as the kernel reads it."""
    if name not in _EWISE:
        raise ValueError(f"unknown element-wise op {name!r}; "
                         f"named ops: {ewise_names()}")
    if (scalar is None) == (name in _SCALAR_OPS):
        raise ValueError(f"element-wise op {name!r} "
                         + ("needs a scalar" if scalar is None
                            else "takes no scalar"))
    return EwiseOp(name, 0.0 if scalar is None else
                   float(np.float32(scalar)))


def ewise_names() -> str:
    """The named ops by kind, for messages."""
    kinds = {}
    for name, (kind, _, _) in _EWISE.items():
        kinds.setdefault(kind, []).append(
            f"{name}(s)" if name in _SCALAR_OPS else name)
    return "; ".join(f"{k}: {', '.join(v)}" for k, v in kinds.items())


def named_op(op, kinds, where: str) -> EwiseOp:
    """``op`` as a named op of one of ``kinds``: an ``EwiseOp`` as it is, a
    ``Monoid`` by its op. A bare callable raises TypeError: the BSR
    element-wise kernel takes named ops only."""
    op = getattr(op, "op", op) if isinstance(op, Monoid) else op
    if not isinstance(op, EwiseOp):
        raise TypeError(
            f"{where}: BSR operands take a named element-wise op "
            f"(semiring.ewise(name[, scalar]) or a Monoid), not "
            f"{getattr(op, '__name__', type(op).__name__)}; named ops: "
            f"{ewise_names()}")
    if op.kind not in kinds:
        raise TypeError(f"{where}: needs a {' or '.join(kinds)} op, got "
                        f"{op.name} ({op.kind})")
    return op


@dataclasses.dataclass(frozen=True)
class Monoid:
    name: str
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    identity: float

    def reduce(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        """Reduce over ``dim`` (None: every entry)."""
        dims = () if dim is None else dim
        if self.name == "plus":
            return torch.sum(x, dim=dim)
        if self.name in ("or", "max"):
            return torch.amax(x, dim=dims)
        if self.name == "min":
            return torch.amin(x, dim=dims)
        raise NotImplementedError(self.name)


PLUS = Monoid("plus", ewise("plus"), 0.0)
MIN = Monoid("min", ewise("min"), float("inf"))
MAX = Monoid("max", ewise("max"), float("-inf"))
OR = Monoid("or", ewise("max"), 0.0)  # over {0,1} indicators


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
ANY_PAIR = Semiring("any_pair", OR, _pair, mode="dot_indicator")
PLUS_PAIR = Semiring("plus_pair", PLUS, _pair, mode="dot_pair")
MIN_PLUS = Semiring("min_plus", MIN, lambda a, b: a + b, mode="bcast")
MAX_PLUS = Semiring("max_plus", MAX, lambda a, b: a + b, mode="bcast")
PLUS_FIRST = Semiring("plus_first", PLUS, _first, mode="dot_first")

SEMIRINGS = {s.name: s for s in [PLUS_TIMES, OR_AND, ANY_PAIR, PLUS_PAIR,
                                 MIN_PLUS, MAX_PLUS, PLUS_FIRST]}


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

"""GraphBLAS semirings over torch tensors.

Port of ``repro.core.semiring``, cut to the two semirings the planner emits
for MATCH (``planner.plan``): ``or_and`` (distinct reachability) and
``plus_times`` (walk counts). ``mode`` names how a matmul computes the
semiring, as in the JAX package.
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
        if self.name == "or":
            return torch.amax(x, dim=dim)
        raise NotImplementedError(self.name)


PLUS = Monoid("plus", lambda a, b: a + b, 0.0)
OR = Monoid("or", torch.maximum, 0.0)  # over {0,1} indicators


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    add: Monoid
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    mode: str           # "dot" | "dot_indicator"

    @property
    def identity(self) -> float:
        return self.add.identity


def _pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a != 0) & (b != 0)).to(torch.float32)


PLUS_TIMES = Semiring("plus_times", PLUS, lambda a, b: a * b, mode="dot")
OR_AND = Semiring("or_and", OR, _pair, mode="dot_indicator")

SEMIRINGS = {s.name: s for s in [PLUS_TIMES, OR_AND]}


def get(name: str) -> Semiring:
    return SEMIRINGS[name]

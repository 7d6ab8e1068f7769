"""The cells' graphs, made from a configuration and the run's seed.

``rmat_edges`` is Graph500 kernel 0's R-MAT generator, the same arithmetic
and the same numpy calls as the port's ``graph.datagen.rmat_edges``, copied
so that a change to the program cannot move the benchmark's inputs. A
configuration fixes the generator's seed, so every run holds one graph; the
run's seed relabels its vertices by a uniform permutation, as Graph500's
generator does, so each seed serves the same graph under other vertex ids.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def rmat_edges(scale: int, edge_factor: int, seed: int, a: float, b: float,
               c: float):
    """(src, dst, n): ``edge_factor * 2**scale`` R-MAT edges, duplicates and
    self-loops included, as the generator makes them."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        u = rng.uniform(size=m)
        src_bit = (u >= ab).astype(np.int64)
        dst_bit = (((u >= a) & (u < ab)) | (u >= abc)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src, dst, n


@dataclasses.dataclass
class Edges:
    """A cell's graph: the edge list handed to the program (duplicates kept,
    for its builder to merge) and its vertex count."""
    src: np.ndarray
    dst: np.ndarray
    n: int


def make_graph(cfg: dict, rng: np.random.Generator) -> Edges:
    """The edge list of configuration ``cfg``, its vertices relabeled by a
    uniform permutation drawn from ``rng`` (from the run's seed)."""
    gen = cfg["generator"]
    if gen["kind"] != "rmat":
        raise ValueError(f"unknown generator {gen['kind']!r}")
    src, dst, n = rmat_edges(cfg["scale"], gen["edge_factor"], gen["seed"],
                             gen["a"], gen["b"], gen["c"])
    if not cfg["directed"]:
        loop = src == dst
        src, dst = (np.concatenate([src[~loop], dst[~loop]]),
                    np.concatenate([dst[~loop], src[~loop]]))
    perm = rng.permutation(n).astype(np.int64)
    return Edges(perm[src], perm[dst], n)

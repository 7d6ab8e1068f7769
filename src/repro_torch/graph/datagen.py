"""Graph generators: Graph500 R-MAT (the paper's dataset generator), a
Twitter-like power-law sampler, and a labeled "social" graph for query tests.

Port of ``repro.graph.datagen``: the same numpy RNG calls in the same order,
so both packages generate identical edge lists from one seed. Each graph
builder takes a ``device`` (default ``"cuda"``)."""
from __future__ import annotations

import numpy as np

from repro_torch.graph.graph import GraphBuilder

# Graph500 R-MAT parameters
RMAT_A, RMAT_B, RMAT_C = 0.57, 0.19, 0.19


def rmat_edges(scale: int, edge_factor: int = 16, seed: int = 0,
               a: float = RMAT_A, b: float = RMAT_B, c: float = RMAT_C):
    """Vectorized R-MAT: the Graph500 kernel-0 generator."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        u = rng.uniform(size=m)
        src_bit = (u >= ab).astype(np.int64)
        dst_bit = (((u >= a) & (u < ab)) | (u >= abc)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    # Graph500 post-processing: random vertex relabeling kills locality; we
    # keep *both* orderings available — `relabel=True` is the adversarial
    # (hypersparse/ELL) case, False keeps RMAT block locality (BSR case).
    return src, dst, n


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 0,
               relabel: bool = False, fmt: str = "auto",
               block: int = 128, rel: str = "KNOWS", device="cuda"):
    src, dst, n = rmat_edges(scale, edge_factor, seed)
    if relabel:
        rng = np.random.default_rng(seed + 1)
        perm = rng.permutation(n)
        src, dst = perm[src], perm[dst]
    g = GraphBuilder(n).add_edges(rel, src, dst).build(fmt=fmt, block=block,
                                                       device=device)
    return g


def twitter_like_graph(n: int = 4096, avg_deg: int = 16, seed: int = 0,
                       fmt: str = "auto", block: int = 128, rel: str = "FOLLOWS",
                       device="cuda"):
    """Power-law in-degree sampler (preferential-attachment flavor)."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    # zipf-ish destination popularity
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    dst = rng.choice(n, size=m, p=p)
    src = rng.integers(0, n, size=m)
    return GraphBuilder(n).add_edges(rel, src, dst).build(fmt=fmt, block=block,
                                                          device=device)


def social_graph(n: int = 512, seed: int = 0, fmt: str = "auto", block: int = 64,
                 device="cuda"):
    """Labeled property graph for Cypher tests: Person-KNOWS-Person,
    Person-VISITS-City, with an `age` property."""
    rng = np.random.default_rng(seed)
    n_city = max(8, n // 16)
    n_person = n - n_city
    person = np.arange(n_person)
    city = np.arange(n_person, n)
    b = GraphBuilder(n)
    b.add_label("Person", person)
    b.add_label("City", city)
    b.set_prop("age", person, rng.integers(10, 80, size=n_person))
    ks = rng.integers(0, n_person, size=n_person * 8)
    kd = rng.integers(0, n_person, size=n_person * 8)
    keep = ks != kd
    b.add_edges("KNOWS", ks[keep], kd[keep])
    vs = rng.integers(0, n_person, size=n_person * 2)
    vd = rng.integers(n_person, n, size=n_person * 2)
    b.add_edges("VISITS", vs, vd)
    return b.build(fmt=fmt, block=block, device=device)

"""Plain PyTorch references for the port's tests, independent of the code
under test: no kernel or module of the port and nothing of JAX.

``triangle_count_dense`` counts the triangles of an undirected simple graph
as the Graph Challenge defines them: with A the symmetric 0/1 adjacency
(diagonal dropped), entry (i, j) of ``(A @ A) * A`` is the number of common
neighbours of the edge (i, j), and every triangle is counted at each of its
six directed edges. The product is dense float32 with TF32 off, so every
common-neighbour count below 2^24 is exact; the sum is float64.
"""
import numpy as np
import torch

MAX_N = 4096        # the dense product's side: 64 MB a float32 matrix


def triangle_count_dense(src, dst, n: int) -> int:
    """The triangles of the undirected graph with edges ``src -> dst``
    (either or both directions given; loops and repeats ignored)."""
    if n > MAX_N:
        raise ValueError(f"triangle_count_dense: n = {n} > {MAX_N}")
    src = torch.as_tensor(np.asarray(src, np.int64))
    dst = torch.as_tensor(np.asarray(dst, np.int64))
    A = torch.zeros((n, n), dtype=torch.float32)
    A[src, dst] = 1.0
    A[dst, src] = 1.0
    A.fill_diagonal_(0.0)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        support = (A @ A) * A
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    total = int(support.to(torch.float64).sum().item())
    assert total % 6 == 0, total
    return total // 6

"""The simple graph of an edge list: duplicates merged, as a SciPy CSR."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def simple_csr(src: np.ndarray, dst: np.ndarray, n: int) -> sp.csr_matrix:
    """The 0/1 adjacency (row = source) of the distinct ``(src, dst)``
    pairs, as float64 CSR with sorted indices."""
    keys = np.unique(np.asarray(src, np.int64) * n + np.asarray(dst, np.int64))
    rows, cols = keys // n, keys % n
    return sp.csr_matrix((np.ones(len(keys)), (rows, cols)), shape=(n, n))

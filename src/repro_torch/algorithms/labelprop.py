"""Label-propagation community detection on label-indicator frontiers.
Port of ``repro.algorithms.labelprop``.

Synchronous CDLP (the LDBC Graphalytics rule): every vertex adopts the
most frequent label among its neighbours' current labels, in both edge
directions, plus its own vote; ties go to the smallest label; rounds
repeat until no label moves (or ``max_iter``). A bare 2-clique trades
labels forever and exits at ``max_iter``, as the rule allows.

As in ``wcc`` the labels live on the host and the graph work is batched
column sweeps: the columns are label indicators and the per-sweep op is a
plus_pair vote count,

  votes[v, c] = |{w : (v,w) or (w,v) stored, label(w) = c}|,

``batch`` labels a chunk (a host one-hot of (n, batch), uploaded), two
``grb.mxm`` a chunk (on BSR two ``bsr_mxm`` launches at F = batch), with a
running (best count, best label) fold across chunks on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import grb, semiring as S


def label_propagation(A, max_iter: int = 50, rel=None,
                      batch: int = 256) -> torch.Tensor:
    """Community labels (n,) int32 on the graph's device; the initial label
    is the vertex id, so a surviving label is the id of some member of its
    community. Deterministic: synchronous updates, min-label tie-break."""
    A = grb.matrix(A, rel)
    n = A.shape[0]
    dev = A.store.device
    labels = np.arange(n, dtype=np.int64)
    if A.nvals == 0 or n == 0:
        # zero-edge adjacency: nobody receives a vote
        return torch.from_numpy(labels.astype(np.int32)).to(dev)
    for _ in range(max_iter):
        uniq, inv = np.unique(labels, return_inverse=True)
        best_cnt = np.zeros(n, dtype=np.float64)
        best_lab = labels.copy()            # no votes at all -> keep own
        for c0 in range(0, len(uniq), batch):
            width = min(batch, len(uniq) - c0)
            onehot = np.zeros((n, width), dtype=np.float32)
            sel = (inv >= c0) & (inv < c0 + width)
            onehot[np.nonzero(sel)[0], inv[sel] - c0] = 1.0
            L = torch.from_numpy(onehot).to(dev)
            V = grb.mxm(A, L, S.PLUS_PAIR, grb.TRANSPOSE_A)
            V = V + grb.mxm(A, L, S.PLUS_PAIR)
            Vn = V.cpu().numpy() + onehot   # + self-vote
            cmax = Vn.max(axis=1)
            # uniq is sorted, so the first argmax column is the smallest
            # label with the chunk's top count
            lab = uniq[c0 + np.argmax(Vn >= cmax[:, None], axis=1)]
            better = (cmax > best_cnt) | ((cmax == best_cnt) & (cmax > 0)
                                          & (lab < best_lab))
            best_lab = np.where(better, lab, best_lab)
            best_cnt = np.maximum(best_cnt, cmax)
        if np.array_equal(best_lab, labels):
            break
        labels = best_lab
    return torch.from_numpy(labels.astype(np.int32)).to(dev)

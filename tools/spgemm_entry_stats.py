#!/usr/bin/env python3
"""Host counts (numpy and scipy, no card) of the work the Graph500 R-MAT
scale-14 hop matrix (the transpose handle squared, 128-tiles) gives the
entry kernel of ``bsr_spgemm`` (``csrc/bsr_spgemm_entry.cu``): tasks,
A-entry visits, products, the share of visits whose B row is empty, and
how unevenly the visits of one output tile fall on its row bands (the
busiest band's visits summed over tiles, over the mean band's). Prints one
JSON line. Run from the repository root:

    python3 tools/spgemm_entry_stats.py
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

BLOCK = 128


def hop_stats(scale=14, b=BLOCK):
    """Host counts for C = AT x AT, AT the transpose handle of R-MAT."""
    from repro_torch.graph.datagen import rmat_edges
    src, dst, n = rmat_edges(scale)
    key = np.unique(src * n + dst)
    r, c = key % n, key // n                 # the transpose handle
    nb = -(-n // b)
    tile = (r // b) * nb + c // b
    tiles, t_of = np.unique(tile, return_inverse=True)
    entries = np.bincount(t_of)
    ti, tk = tiles // nb, tiles % nb        # A tile (I, K); B = A
    per_row = np.bincount(ti, minlength=nb)     # B tiles of each block-row
    tasks = int(per_row[tk].sum())
    visits = int((entries * per_row[tk]).sum())
    colcnt = np.bincount(c, minlength=n).astype(np.int64)
    rowcnt = np.bincount(r, minlength=n).astype(np.int64)
    products = int((colcnt * rowcnt).sum())
    # a visit a(i,k) in tile (I, K) meets each B tile (K, J); B's row k of
    # that tile is empty unless row k has an entry in column tile J
    kj = np.unique(r.astype(np.int64) * nb + c // b)
    live_tiles_of_row = np.bincount(kj // nb, minlength=n)
    nonempty = int((colcnt * live_tiles_of_row).sum())
    # visits per (output tile, band): sum over K of A(I,K)'s band entries,
    # for each B tile (K, J)
    import scipy.sparse as sp
    out = {}
    for bands in (16, 32):
        band = (r % b) * bands // b
        ma = sp.coo_matrix((np.ones(len(r)), ((r // b) * bands + band,
                                              c // b)),
                           shape=(nb * bands, nb)).tocsr()
        mb = sp.coo_matrix((np.ones(len(tiles)), (ti, tk)),
                           shape=(nb, nb)).tocsr()
        v = (ma @ mb).toarray().reshape(nb, bands, nb)     # (I, band, J)
        busiest = v.max(axis=1).sum()
        out[f"band_imbalance_{bands}"] = float(busiest / (v.sum() / bands))
    return dict(shape=f"scale-{scale} transpose handle "
                f"squared", tiles=int(len(tiles)), entries=int(len(r)),
                tasks=tasks, visits=visits, products=products,
                empty_row_visit_share=1.0 - nonempty / visits, **out)


if __name__ == "__main__":
    print(json.dumps(hop_stats()), flush=True)

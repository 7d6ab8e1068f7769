"""Graph algorithms over the ``grb`` surface — port of ``repro.algorithms``,
the same ``__all__``: traversal (``bfs_levels``, ``khop_counts``),
``sssp``, ``pagerank``, ``wcc``, centrality (batched Brandes
``betweenness`` / ``brandes_parts``, ``closeness``), ``label_propagation``,
and the GraphChallenge analytics (``triangle_count``, ``ktruss``,
``similarity`` / ``similarity_matrix``). Each takes a Graph (and relation
name), a Relation, a GBMatrix or raw storage, and returns tensors on the
graph's device."""
from repro_torch.algorithms.traverse import bfs_levels, khop_counts
from repro_torch.algorithms.centrality import (betweenness, brandes_parts,
                                               closeness,
                                               closeness_from_levels)
from repro_torch.algorithms.ktruss import ktruss
from repro_torch.algorithms.labelprop import label_propagation
from repro_torch.algorithms.pagerank import pagerank
from repro_torch.algorithms.similarity import similarity, similarity_matrix
from repro_torch.algorithms.sssp import sssp
from repro_torch.algorithms.wcc import wcc
from repro_torch.algorithms.triangles import triangle_count

__all__ = ["bfs_levels", "betweenness", "brandes_parts", "closeness",
           "closeness_from_levels", "khop_counts", "ktruss",
           "label_propagation", "pagerank", "similarity",
           "similarity_matrix", "sssp", "wcc", "triangle_count"]

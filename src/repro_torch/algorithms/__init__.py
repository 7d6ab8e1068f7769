"""Graph algorithms over the ``grb`` surface — port of ``repro.algorithms``,
cut to what is ported: the GraphChallenge analytics (triangle counting,
k-truss) and neighbourhood similarity. The traversal loops, centrality,
label propagation, pagerank, sssp and wcc wait (ROADMAP item 7)."""
from repro_torch.algorithms.ktruss import ktruss
from repro_torch.algorithms.similarity import similarity, similarity_matrix
from repro_torch.algorithms.triangles import triangle_count

__all__ = ["ktruss", "similarity", "similarity_matrix", "triangle_count"]

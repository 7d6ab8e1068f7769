"""Graph model and generators — the port of ``repro.graph``."""
from repro_torch.graph import datagen
from repro_torch.graph.graph import Graph, GraphBuilder, Relation, from_arrays

__all__ = ["Graph", "GraphBuilder", "Relation", "datagen", "from_arrays"]

"""The engine: the port of ``repro.engine`` (``Database``, ``MutableGraph``,
AOF and snapshot persistence, the ``QueryServer``)."""
from repro_torch.engine.database import Database, MutableGraph
from repro_torch.engine.persistence import load_snapshot, save_snapshot
from repro_torch.engine.server import QueryServer

__all__ = ["Database", "MutableGraph", "QueryServer",
           "load_snapshot", "save_snapshot"]

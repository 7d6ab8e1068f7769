"""Serving — the port of ``repro.engine`` (the ``QueryServer``;
``Database``, ``MutableGraph`` and persistence come in a later slice)."""
from repro_torch.engine.server import QueryServer

__all__ = ["QueryServer"]

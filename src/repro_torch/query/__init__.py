"""Cypher-lite query layer — the port of ``repro.query``: parser, planner,
executor (MATCH) and the reference oracle."""
from repro_torch.query.executor import ExecutionContext, Result, execute, explain
from repro_torch.query.parser import parse
from repro_torch.query.planner import plan

__all__ = ["ExecutionContext", "Result", "execute", "explain", "parse",
           "plan"]

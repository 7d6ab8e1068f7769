"""Spans at the port's layer boundaries, and Python's collections beside them.

Off by default. Off, ``span`` returns one shared no-op context manager: no
clock read, no record and no profiler call. ``enable()`` turns recording
on for the process, ``disable()`` turns it off again; both leave the
records where they are (``clear()`` empties them).

On, each span records its name, its start and end on
``time.perf_counter_ns()`` (the clock of ``Submitted.t_submit``), the index
of the span open around it (its parent, -1 for none), its request id and
its attributes. A span given no ``rid`` takes its parent's: the
``QueryServer`` opens ``launch`` and ``finish`` with the batch id, so every
span of a sweep carries it, and ``launch``'s ``qids`` names the queries
the sweep answers. Records go to an in-memory list of at most ``CAPACITY``
entries; spans past it are counted in ``dropped()`` and not recorded.
Nothing is written to disk.

While tracing is on, a ``gc.callbacks`` hook records each collection as a
``gc`` span (attribute ``generation``) whose parent is the span in which
it struck. While a torch profiler is recording, each span is also opened
as ``record_function("repro.<name>")``, so the spans sit in the profiler's
trace on its own clock and each kernel falls inside the innermost span its
launch was made in (``gc`` spans are not: the collector may strike inside
the profiler itself).

The spans are recorded for one thread, the one that serves.

Span names and their attributes:

  pump                          launched, finished (batch ids, or None)
  launch                        batch, width, qids
  finish                        batch
  project                       batch, members
  traverse                      -
  expand                        route: "words", "float" or "spgemm_hop"
  hop                           hop (1-based)
  call_device, call_project     procedure, rows
  spgemm, spgemm_plan           tasks (before padding), tiles (output)
  d2h, h2d                      tag, bytes (``core.xfer``'s counted copies)
  gc                            generation
"""
from __future__ import annotations

import gc
import time
from typing import List, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 20      # records kept; a khop2 sweep opens about 15

_on = False
_records: List["Record"] = []
_stack: List[int] = []          # indices of the open spans, innermost last
_dropped = 0
_gc_t0 = 0


class Record:
    """One span: ``t0`` / ``t1`` in ``perf_counter_ns``; ``t1`` is 0 while
    the span is open."""
    __slots__ = ("name", "t0", "t1", "parent", "rid", "attrs")

    def __init__(self, name, t0, parent, rid, attrs):
        self.name = name
        self.t0 = t0
        self.t1 = 0
        self.parent = parent
        self.rid = rid
        self.attrs = attrs

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, {self.t0}, {self.t1}, "
                f"parent={self.parent}, rid={self.rid}, {self.attrs})")


class _Noop:
    """The span handed out while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


def _open(name: str, rid, attrs: dict) -> int:
    """Append an open record; its index, or -1 past ``CAPACITY``."""
    global _dropped
    if len(_records) >= CAPACITY:
        _dropped += 1
        return -1
    parent = _stack[-1] if _stack else -1
    if rid is None and parent >= 0:
        rid = _records[parent].rid
    _records.append(Record(name, time.perf_counter_ns(), parent, rid, attrs))
    return len(_records) - 1


class _Span:
    __slots__ = ("name", "rid", "attrs", "rec", "rf")

    def __init__(self, name: str, rid, attrs: dict):
        self.name = name
        self.rid = rid
        self.attrs = attrs
        self.rec = None
        self.rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function("repro." + self.name)
            self.rf.__enter__()
        i = _open(self.name, self.rid, self.attrs)
        if i >= 0:
            self.rec = _records[i]
            _stack.append(i)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.t1 = time.perf_counter_ns()
            # a clear() since the span opened took its record away
            if _stack and _records[_stack[-1]] is self.rec:
                _stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work is done."""
        self.attrs.update(attrs)


def span(name: str, rid: Optional[int] = None, **attrs):
    """A context manager recording ``name`` while tracing is on."""
    if not _on:
        return _NOOP
    return _Span(name, rid, attrs)


def _on_gc(phase: str, info: dict) -> None:
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.perf_counter_ns()
        return
    i = _open("gc", None, {"generation": info["generation"]})
    if i >= 0:
        _records[i].t0 = _gc_t0
        _records[i].t1 = time.perf_counter_ns()


def enable() -> None:
    """Record spans, and Python's collections, from now on."""
    global _on
    _on = True
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def disable() -> None:
    """Stop recording; the records stay."""
    global _on
    _on = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def enabled() -> bool:
    return _on


def records() -> List[Record]:
    """Every span recorded since the last ``clear()``, in opening order
    (a ``gc`` span is appended when its collection ends)."""
    return _records


def dropped() -> int:
    """Spans not recorded since the last ``clear()``: the list was full."""
    return _dropped


def clear() -> None:
    """Forget every record; spans still open record nothing more."""
    global _dropped
    _records.clear()
    _stack.clear()
    _dropped = 0

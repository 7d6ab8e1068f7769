"""The program's own spans and copy counters, for the metrics' readers.

Importing this module turns the program's tracing on
(``repro_torch.tracing.enable()``). Only the readers of program spans and
counters import it, and ``run.py`` loads a cell's per-layer readers only in
the traced run (before the window, to collect their ``SPANS``), so the
program's tracing is on in traced runs and off in the untraced runs that
give the end-to-end metrics. Against a program without
``repro_torch.tracing``, or without a counter in ``QueryServer.stats``,
these readers find nothing and return None.
"""
try:
    from repro_torch import tracing
except ImportError:             # a program from before its spans
    tracing = None
else:
    tracing.enable()


def spans(r, name: str):
    """Seconds in each of the program's closed spans ``name`` that opened
    inside the window; None if the program recorded no ``pump`` span there
    (its tracing off or absent), so a broken switch reads as a missing
    metric and not as a zero."""
    if tracing is None or not tracing.enabled():
        return None
    t0, t1 = r.window.t0 * 1e9, r.window.t1 * 1e9
    inside = [s for s in tracing.records() if t0 <= s.t0 < t1 and s.t1]
    if not any(s.name == "pump" for s in inside):
        return None
    return [(s.t1 - s.t0) * 1e-9 for s in inside if s.name == name]


def counter(r, key: str):
    """``QueryServer.stats[key]``'s change over the window, or None where
    the program keeps no such counter."""
    return r.delta(key) if key in r.window.stats0 else None

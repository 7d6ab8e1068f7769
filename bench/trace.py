"""Spans around the program's methods, and the reading of a profiler trace.

In the traced run only, ``Spans`` wraps methods of the program (named as
``"module:Class.method"`` or ``"module:function"``) so that each call is a
``torch.profiler.record_function`` range named ``bench.<span>``; the
program itself is not edited. ``read_trace`` takes the exported Chrome
trace of the window and gives the device's intervals, each with the span
its launch was made in (by the profiler's launch correlation), and the
spans' host intervals on the same clock.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import json
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _resolve(target: str):
    mod, _, attr = target.partition(":")
    owner = importlib.import_module(mod)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


class Spans:
    """Wraps each ``target`` in a ``bench.<span>`` range; ``restore``
    undoes it."""

    def __init__(self, targets: Dict[str, str]):
        from torch.profiler import record_function
        self._saved = []
        for span, target in targets.items():
            owner, name = _resolve(target)
            fn = getattr(owner, name)

            def wrapped(*a, _fn=fn, _tag=f"bench.{span}", **k):
                with record_function(_tag):
                    return _fn(*a, **k)
            functools.update_wrapper(wrapped, fn)
            self._saved.append((owner, name, owner.__dict__[name]))
            setattr(owner, name, wrapped)

    def restore(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []


@dataclasses.dataclass
class DeviceOp:
    name: str
    ts: float                   # microseconds, trace clock
    dur: float
    span: Optional[str]         # the innermost bench span of its launch


@dataclasses.dataclass
class Trace:
    t0: float                   # the window, microseconds
    t1: float
    spans: Dict[str, List[Tuple[float, float]]]   # span -> [(ts, dur)]
    ops: List[DeviceOp]         # device intervals inside the window

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which something ran on the device: the union of the
        device intervals, clipped to the window."""
        return sum(b - a for a, b in self._union()) * 1e-6

    def _union(self):
        out = []
        for op in sorted(self.ops, key=lambda o: o.ts):
            a, b = max(op.ts, self.t0), min(op.ts + op.dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def span_s(self, span: str) -> float:
        """Host seconds inside ``span`` ranges within the window."""
        return sum(d for _, d in self.spans.get(span, ())) * 1e-6

    def span_count(self, span: str) -> int:
        return len(self.spans.get(span, ()))

    def device_s(self, span: str) -> float:
        """Device seconds of the operations launched inside ``span``."""
        return sum(o.dur for o in self.ops if o.span == span) * 1e-6

    def top_ops(self, k: int = 10):
        tot: Dict[str, float] = {}
        for o in self.ops:
            tot[o.name] = tot.get(o.name, 0.0) + o.dur * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The ``k`` longest stretches with nothing on the device, each
        named by the innermost bench span the host was in as it began."""
        segs = self._union()
        edges = [self.t0] + [x for s in segs for x in s] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_span(a) or "client", (b - a) * 1e-6]
                for a, b in gaps[:k]]

    def _host_span(self, t: float) -> Optional[str]:
        best = None
        for name, ivs in self.spans.items():
            for ts, dur in ivs:
                if ts <= t < ts + dur and (best is None or dur < best[1]):
                    best = (name, dur)
        return best[0] if best else None


def read_trace(path: str) -> Trace:
    """Read an exported Chrome trace of one window (``bench.window``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans: Dict[str, List[Tuple[float, float]]] = {}
    launches = {}
    device = []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and e["name"].startswith("bench."):
            spans.setdefault(e["name"][6:], []).append(
                (float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
    win = spans.pop("window", None)
    if not win:
        raise ValueError(f"{path}: no {WINDOW} range")
    t0, dur = win[0]
    t1 = t0 + dur
    spans = {k: [(ts, d) for ts, d in v if t0 <= ts < t1]
             for k, v in spans.items()}
    ivs = sorted(((ts, ts + d, k) for k, v in spans.items() for ts, d in v),
                 key=lambda x: (x[0], -x[1]))
    inside = [e for e in device
              if float(e["ts"]) + float(e.get("dur", 0.0)) > t0
              and float(e["ts"]) < t1]
    at = {}                     # launch time -> innermost span, one sweep
    stack, i = [], 0
    for t in sorted({launches[c] for c in (e.get("args", {}).get(
            "correlation") for e in inside) if c in launches}):
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] <= ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        at[t] = stack[-1][2] if stack else None
    ops = []
    for e in inside:
        launch = launches.get(e.get("args", {}).get("correlation"))
        ops.append(DeviceOp(e["name"], float(e["ts"]),
                            float(e.get("dur", 0.0)),
                            at.get(launch) if launch is not None else None))
    return Trace(t0, t1, spans, ops)

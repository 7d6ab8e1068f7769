#!/usr/bin/env python3
"""Traced runs of a benchmark cell, read by the program's own spans.

Runs ``bench.run.run_cell`` with ``trace=True`` once a seed on the CUDA
card, and before the benchmark deletes the window's exported profiler
trace, reads it beside the spans that ``repro_torch.tracing`` kept in
memory. One JSON line a seed, with the run's result (``correct``,
``metrics``) and:

  gaps     the ten longest stretches with nothing on the device: seconds,
           the benchmark's name for it, the ``repro.*`` spans open as it
           began (outermost first), and its seconds split by the innermost
           program span (``gc`` included; ``outside`` is time in no span)
  copies   the bytes and number of the window's ``Memcpy DtoH`` / ``HtoD``
           events, the server's counters over the window, and the copies
           launched inside no ``repro.d2h`` / ``repro.h2d`` range, by the
           innermost span they were launched in
  spans    host milliseconds of each program span over the window, and the
           benchmark's own spans of the same layers beside them
  gc       collections in the window by generation, their total and
           longest milliseconds; oldest_gc each oldest-generation one, with
           the spans it struck in

With ``--program-tracing off`` the program's tracing is turned off before
the run, so the same profiler runs without the program's spans (the
readers of program spans then report nothing). ``--noop`` times a span
with tracing off instead (nanoseconds a span on this host). Run from the
repository root:

    python3 tools/program_trace.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds 30] [--program-tracing on|off] [--noop]
"""
import argparse
import bisect
import json
import os
import statistics
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

COPY = {"Memcpy DtoH": "d2h", "Memcpy HtoD": "h2d"}


def _nested(intervals, times):
    """For each time in ``times`` (sorted), the names of the intervals
    ``(start, end, name)`` open at it, outermost first; the intervals nest
    (one thread's spans)."""
    ivs = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] <= ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append([s[2] for s in stack])
    return out


def _split(records, a, b):
    """Seconds of [a, b] (ns) by innermost program span."""
    parent_of = {}
    clip = {}
    for i, r in enumerate(records):
        if r.t1 and r.t0 < b and r.t1 > a:
            clip[i] = min(r.t1, b) - max(r.t0, a)
            parent_of[i] = r.parent
    self_ns = dict(clip)
    for i, p in parent_of.items():
        if p in self_ns:
            self_ns[p] -= clip[i]
    out = {}
    for i, ns in self_ns.items():
        out[records[i].name] = out.get(records[i].name, 0) + ns
    top = sum(ns for i, ns in clip.items() if parent_of[i] not in clip)
    out["outside"] = (b - a) - top
    return {k: round(v * 1e-9, 6) for k, v in
            sorted(out.items(), key=lambda kv: -kv[1]) if v > 0}


def analyse(path, win, records):
    """The JSON fields of one run from its exported trace, its window and
    the program's records."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host, launches, device = [], {}, []
    wts = None
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation":
            if name == "bench.window":
                wts = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            elif name.startswith(("repro.", "bench.")):
                host.append((float(e["ts"]), float(e["ts"]) + float(
                    e.get("dur", 0.0)), name))
        elif cat in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(e)
    t0, t1 = wts
    device = [e for e in device if float(e["ts"]) < t1
              and float(e["ts"]) + float(e.get("dur", 0.0)) > t0]
    repro = [h for h in host if h[2].startswith("repro.") and
             h[1] > t0 and h[0] < t1]
    bench = [h for h in host if h[2].startswith("bench.") and
             h[1] > t0 and h[0] < t1]

    # the trace's clock against perf_counter: the window's opening, then
    # refined on the pumps both record
    off = t0 - win.t0 * 1e6
    pumps = sorted(r.t0 * 1e-3 for r in records if r.name == "pump")
    diffs = []
    for ts, _, name in repro:
        if name == "repro.pump":
            j = bisect.bisect_left(pumps, ts - off)
            near = [pumps[k] for k in (j - 1, j) if 0 <= k < len(pumps)]
            if near:
                p = min(near, key=lambda x: abs(ts - off - x))
                diffs.append(ts - p)
    if diffs:
        off = statistics.median(diffs)

    segs = []
    for e in sorted(device, key=lambda e: float(e["ts"])):
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), t1)
        if b <= a:
            continue
        if segs and a <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], b)
        else:
            segs.append([a, b])
    edges = [t0] + [x for s in segs for x in s] + [t1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    gaps = sorted(gaps[:10])
    open_at = _nested(repro, [a for a, _ in gaps])
    bench_at = _nested(bench, [a for a, _ in gaps])
    gap_rows = sorted(
        ({"s": round((b - a) * 1e-6, 6),
          "bench": (bo[-1][6:] if bo else "client"),
          "open": [n[6:] for n in ro],
          "split": _split(records, (a - off) * 1e3, (b - off) * 1e3)}
         for (a, b), ro, bo in zip(gaps, open_at, bench_at)),
        key=lambda g: -g["s"])

    copies = {k: {"bytes": 0, "copies": 0} for k in COPY.values()}
    outside = {}
    cp = [e for e in device if e.get("cat") == "gpu_memcpy"]
    kinds = [next((v for k, v in COPY.items() if e["name"].startswith(k)),
                  None) for e in cp]
    at = [launches.get(e.get("args", {}).get("correlation")) for e in cp]
    order = sorted(range(len(cp)), key=lambda i: at[i] or 0.0)
    chains = dict(zip(order, _nested(repro, [at[i] or 0.0 for i in order])))
    for i, (e, kind) in enumerate(zip(cp, kinds)):
        if kind is None:
            continue
        nb = int(e.get("args", {}).get("bytes", 0))
        copies[kind]["bytes"] += nb
        copies[kind]["copies"] += 1
        chain = [n[6:] for n in chains[i]]
        if kind not in chain:
            key = f"{kind} in {'>'.join(chain) or 'no span'}"
            o = outside.setdefault(key, {"bytes": 0, "copies": 0})
            o["bytes"] += nb
            o["copies"] += 1
    for kind in copies:
        for what in ("bytes", "copies"):
            k = f"{kind}_{what}"
            copies[kind][f"counted_{what}"] = (
                win.stats1[k] - win.stats0[k] if k in win.stats0 else None)
    copies["not_in_a_copy_span"] = outside

    lo, hi = win.t0 * 1e9, win.t1 * 1e9
    inside = [r for r in records if r.t1 and lo <= r.t0 < hi]
    tot = {}
    gcs = {}
    oldest = []
    for r in inside:
        tot[r.name] = tot.get(r.name, 0) + (r.t1 - r.t0) * 1e-6
        if r.name == "gc":
            g = gcs.setdefault(str(r.attrs["generation"]), [])
            g.append((r.t1 - r.t0) * 1e-6)
            if r.attrs["generation"] == 2:
                chain, p = [], r.parent
                while p >= 0:
                    chain.append(records[p].name)
                    p = records[p].parent
                oldest.append({"ms": round((r.t1 - r.t0) * 1e-6, 3),
                               "in": ">".join(reversed(chain))})
    bench_ms = {}
    for a, b, name in bench:
        if t0 <= a < t1:
            bench_ms[name[6:]] = bench_ms.get(name[6:], 0.0) + (b - a) * 1e-3
    return {"gaps": gap_rows, "copies": copies,
            "spans": {"program_ms": {k: round(v, 3) for k, v in
                                     sorted(tot.items())},
                      "bench_ms": {k: round(v, 3) for k, v in
                                   sorted(bench_ms.items())}},
            "gc": {g: {"n": len(v), "ms": round(sum(v), 3),
                       "max_ms": round(max(v), 3)}
                   for g, v in sorted(gcs.items())},
            "oldest_gc": oldest,
            "clock_offset_us": off}


def noop_cost(n=1_000_000):
    """Nanoseconds a span costs with tracing off, and an empty ``with``."""
    from repro_torch import tracing
    tracing.disable()
    env = {"tracing": tracing, "nullcontext": __import__(
        "contextlib").nullcontext()}
    base = timeit.timeit("with nullcontext: pass", globals=env, number=n)
    out = {"empty_with_ns": base / n * 1e9}
    for label, stmt in (("span_ns", "with tracing.span('traverse'): pass"),
                        ("span_attr_ns",
                         "with tracing.span('hop', hop=1): pass")):
        out[label] = timeit.timeit(stmt, globals=env, number=n) / n * 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--program-tracing", choices=("on", "off"), default="on")
    ap.add_argument("--noop", action="store_true")
    args = ap.parse_args(argv)
    if args.noop:
        print(json.dumps({"noop": noop_cost()}), flush=True)
        if not args.workload:
            return 0

    import torch
    if not torch.cuda.is_available():
        print("program_trace: no CUDA card", file=sys.stderr)
        return 2
    from bench import manifest
    cell = manifest.cell(manifest.load(), args.workload)
    for row in traced_runs(cell, args.seeds, args.seconds,
                           args.program_tracing == "on"):
        print(json.dumps(row), flush=True)
    return 0


def traced_runs(cell, seeds, seconds, program_tracing=True, device="cuda"):
    """One traced run of ``cell`` a seed; yields each run's JSON fields."""
    from bench import load, program, run, trace  # noqa: F401 (enables)
    from repro_torch import tracing
    (tracing.enable if program_tracing else tracing.disable)()
    read_trace, loop_run = trace.read_trace, load.ClosedLoop.run
    got = {}

    def reading(path):
        got["analysis"] = analyse(path, got["win"], tracing.records())
        return read_trace(path)

    def running(self, *a, **k):
        got["win"] = loop_run(self, *a, **k)
        return got["win"]
    trace.read_trace, load.ClosedLoop.run = reading, running
    try:
        for seed in seeds:
            tracing.clear()
            t = time.perf_counter()
            out = run.run_cell(cell, seed, seconds, True, device=device)
            yield {"workload": cell.workload["name"], "seed": seed,
                   "program_tracing": "on" if program_tracing else "off",
                   "correct": out["correct"], "attempted": out["attempted"],
                   "wall_s": round(time.perf_counter() - t, 3),
                   "dropped": tracing.dropped(),
                   "metrics": {k: v["value"]
                               for k, v in out["metrics"].items()},
                   "device": out["device"], **got.pop("analysis")}
    finally:
        trace.read_trace, load.ClosedLoop.run = read_trace, loop_run


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of ``BENCHMARK.json`` on the CUDA card and print its result.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes the cell's graph from its
configuration and ``--seed``, builds it through the program's public API
(``graph.GraphBuilder(...).build``), serves the traffic mix's closed loop
through ``engine.server.QueryServer`` (``load.ClosedLoop``), and once the
window has closed checks a sample of the answers against the plain
references (``checks``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read by
``metrics/<name>.py``), ``device`` and, traced, ``breakdown``; then
``checks``, each number compared beside its limit, which also end standard
error. With no CUDA card, too few cards, no program beside the benchmark,
or JAX loaded once the window has closed, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()           # set-up counts from here

import argparse                         # noqa: E402
import dataclasses                      # noqa: E402
import gc                               # noqa: E402
import json                             # noqa: E402
import os                               # noqa: E402
import sys                              # noqa: E402
from typing import Optional             # noqa: E402

import numpy as np                      # noqa: E402

from bench import checks, data, load, manifest, trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
OUT = manifest.BENCH / "out"
# spans every traced run records, for naming the device's idle gaps
SPANS = {
    "pump": "repro_torch.engine.server:QueryServer.pump",
    "finish": "repro_torch.engine.server:QueryServer._finish",
    "traverse": "repro_torch.query.executor:ExecutionContext.traverse",
    "project": "repro_torch.query.executor:ExecutionContext.project",
}


@dataclasses.dataclass
class Reading:
    """What a metric's reader (``metrics/<name>.py``) reads."""
    cell: manifest.Cell
    window: load.Window
    setup_s: float
    build_s: float
    work: tuple                 # (bytes, ops) the window's launched work needs
    trace: Optional[tracing.Trace]

    def delta(self, counter: str) -> float:
        """A server counter's change over the window."""
        return self.window.stats1[counter] - self.window.stats0[counter]


def loaded_forbidden(modules=None):
    """The top-level names among ``modules`` (default: those loaded) that
    the benchmark must not load, compared whole."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _streams(seed: int):
    """Independent generators for the graph's labels and for the clients
    and the kept sample, from one run seed (any whole number)."""
    ss = np.random.SeedSequence(seed % (1 << 64))
    return [np.random.default_rng(s) for s in ss.spawn(2)]


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             control=None) -> dict:
    """One run of ``cell``; returns the result's fields. ``control``, for
    the tests, takes ``(kind, A, traffic, kept starts)`` and gives answers
    that replace the program's kept answers before they are judged."""
    import torch

    from repro_torch.engine.server import QueryServer
    from repro_torch.graph.graph import GraphBuilder

    cfg, traffic = cell.config, cell.traffic
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kind = checks.KINDS[traffic["answer"]]
    rng_graph, rng_load = _streams(seed)
    t_imported = time.perf_counter()
    if cuda:
        from repro_torch.kernels import build
        build.build_all()                # only the first run compiles
        torch.cuda.init()
    t_kernels = time.perf_counter()
    edges = data.make_graph(cfg, rng_graph)
    t_graph = time.perf_counter()
    store = cfg["storage"]
    sync()
    t = time.perf_counter()
    g = GraphBuilder(edges.n).add_edges(cfg["relation"], edges.src,
                                        edges.dst).build(
        fmt=store["fmt"], block=store.get("block", 128), device=device)
    sync()
    build_s = time.perf_counter() - t
    srv = QueryServer(g)
    loop = load.ClosedLoop(srv, traffic, np.unique(edges.src), rng_load)

    spans = prof = rf = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        targets = dict(SPANS)
        for m in cell.per_layer:
            targets.update(getattr(manifest.reader(m["name"], cell.bench),
                                   "SPANS", {}))
        spans = tracing.Spans(targets)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        rf = record_function(tracing.WINDOW)

    def close():
        if trace:
            rf.__exit__(None, None, None)
            sync()
    win = loop.run(seconds,
                   before_window=prof.start if trace else (lambda: None),
                   window_open=rf.__enter__ if trace else (lambda: None),
                   window_close=close)
    print(f"bench: set-up {win.t0 - t_start:.3f} s: imports "
          f"{t_imported - t_start:.3f}, kernels and CUDA "
          f"{t_kernels - t_imported:.3f}, graph {t_graph - t_kernels:.3f}, "
          f"build {build_s:.3f}, warm-up {win.t0 - t - build_s:.3f}",
          file=sys.stderr)
    loop.drain()
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = None
    if trace:
        prof.stop()
        spans.restore()
        OUT.mkdir(exist_ok=True)
        path = OUT / f"trace-{cell.workload['name']}.json"
        prof.export_chrome_trace(str(path))
        del prof
        tr = tracing.read_trace(str(path))
        path.unlink()

    failed = sum(a.error is not None for a in win.answers)
    kept = [a for a in win.kept if a.error is None]
    got = [kind.value(a.result) for a in kept]
    starts = [a.start for a in kept]
    for a in win.answers:
        a.result = None
    del srv, g, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    from bench.reference.graph import simple_csr
    from bench.reference.precision import exact
    A = simple_csr(edges.src, edges.dst, edges.n)
    want = kind.reference(A, traffic, starts, exact)
    if control is not None:
        got = control(kind, A, traffic, starts)
    numbers = checks.judge(traffic, got, want, failed)
    correct = bool(win.answered and got and checks.passed(numbers))

    r = Reading(cell, win, win.t0 - t_start, build_s,
                kind.work(A, traffic, want, win), tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = manifest.reader(m["name"], cell.bench).read(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win.answered, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in tr.top_ops()],
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = numbers
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = manifest.ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"bench: no program at {src / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    cell = manifest.cell(manifest.load(), args.workload)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # the program builds its kernels inside the checkout
    # (src/repro_torch/kernels/build); any torch or Triton JIT cache goes
    # there too, at a fixed path
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(OUT / "cache" / sub)

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"bench: modules loaded that must not be: {found}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

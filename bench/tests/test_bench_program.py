"""The readers of the program's own spans and copy counters
(``bench/program.py``): in the manifest, read in every traced run where
they apply, and nothing against a program that keeps no such span or
counter. Importing them turns the program's tracing on, so an untraced
run, which loads no per-layer reader, leaves it off."""
import gc
import json
import os
import subprocess
import sys
import time
import types

import pytest

from bench import manifest, program
from bench.tests import helpers

NEW = {"d2h_wait_ms.khop": ["khop2-graph500-s16"],
       "d2h_mb.khop": ["khop2-graph500-s16"],
       "d2h_copies.khop": ["khop2-graph500-s16"],
       "gc_ms.khop": ["khop2-graph500-s16"],
       "gc_ms.algo": ["tc-graphchallenge-s15", "pagerank-graphchallenge-s15"],
       "plan_tasks.algo": ["tc-graphchallenge-s15"],
       "h2d_mb.algo": ["tc-graphchallenge-s15",
                       "pagerank-graphchallenge-s15"]}
SCALE = {"khop2-graph500-s16": 9, "tc-graphchallenge-s15": 8,
         "pagerank-graphchallenge-s15": 8}


def test_the_program_metrics_are_in_the_manifest():
    m = manifest.load()
    assert manifest.problems(m) == []
    got = {e["name"]: e for e in m["per_layer"]}
    for name, cells in NEW.items():
        e = got[name]
        assert e["workloads"] == cells and e["better"] == "lower"
        assert e["source"] in ("program_span", "program_counter")
    assert [e["name"] for e in m["per_layer"][-len(NEW):]] == list(NEW)


@pytest.mark.parametrize("cell", list(SCALE))
def test_a_traced_run_reads_every_program_metric_of_its_cell(cell):
    out = helpers.run_small(cell, scale=SCALE[cell], trace=True)
    assert out["correct"] is True
    want = {k for k, cells in NEW.items() if cell in cells}
    assert want <= set(out["metrics"]), want - set(out["metrics"])
    for k in want:
        assert out["metrics"][k]["value"] >= 0.0, k
    if cell == "tc-graphchallenge-s15":
        assert out["metrics"]["plan_tasks.algo"]["value"] > 0
    # a CPU graph copies nothing to or from a card
    for k in ("d2h_mb.khop", "d2h_copies.khop", "h2d_mb.algo"):
        if k in want:
            assert out["metrics"][k]["value"] == 0.0, k


def test_an_untraced_run_leaves_the_program_tracing_off():
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'src')\n"
        "from bench.tests import helpers\n"
        "from repro_torch import tracing\n"
        "for trace in (False, True):\n"
        "    out = helpers.run_small('tc-graphchallenge-s15', scale=7,\n"
        "                            trace=trace)\n"
        "    print(json.dumps([tracing.enabled(),\n"
        "                      'bench.program' in sys.modules,\n"
        "                      'gc_ms.algo' in out['metrics']]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    untraced, traced = (json.loads(x) for x in p.stdout.splitlines()[-2:])
    assert untraced == [False, False, False]
    assert traced == [True, True, True]


def _reading(stats=None, t0=0.0, t1=1.0):
    stats = stats or {}
    win = types.SimpleNamespace(t0=t0, t1=t1, pumps=4, answered=4,
                                stats0=dict(stats), stats1=dict(stats))
    return types.SimpleNamespace(
        window=win, delta=lambda k: win.stats1[k] - win.stats0[k])


@pytest.mark.parametrize("name", list(NEW))
def test_a_program_without_spans_or_counters_reads_nothing(name,
                                                           monkeypatch):
    monkeypatch.setattr(program, "tracing", None)
    assert manifest.reader(name).read(_reading()) is None


@pytest.mark.parametrize("name", ["d2h_wait_ms.khop", "gc_ms.khop",
                                  "gc_ms.algo"])
def test_span_readers_tell_tracing_off_from_nothing_happened(name):
    tracing = program.tracing
    was = tracing.enabled()
    gc.disable()
    try:
        tracing.disable()
        t0 = time.perf_counter()
        with tracing.span("pump"):
            pass
        r = _reading(t0=t0, t1=time.perf_counter())
        assert manifest.reader(name).read(r) is None
        tracing.enable()
        t0 = time.perf_counter()
        with tracing.span("pump"):
            pass
        r = _reading(t0=t0, t1=time.perf_counter())
        assert manifest.reader(name).read(r) == 0.0
    finally:
        gc.enable()
        (tracing.enable if was else tracing.disable)()

"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json`` (named by its entry's
``file``), a traffic mix ``traffic/<traffic>.json`` and a per-layer metric
``metrics/<metric>.py`` (a module with ``read(reading)`` and optionally
``SPANS``). Adding a cell or a metric adds files and entries; no code here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict                # the configuration's file
    traffic: dict               # the traffic mix's file
    end_to_end: List[dict]      # the metrics this cell reports
    per_layer: List[dict]
    bench: Path = BENCH         # where its files were found


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str, bench: Path = BENCH) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    try:
        w = next(w for w in manifest["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                       f"{[w['name'] for w in manifest['workloads']]})")
    c = next(c for c in manifest["configs"] if c["name"] == w["config"])
    with open(bench.parent / c["file"]) as f:
        config = json.load(f)
    with open(bench / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(w, config, traffic,
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)], bench)


def reader(metric: str, bench: Path = BENCH):
    """The module ``metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(manifest: dict, bench: Path = BENCH) -> List[str]:
    """What in ``manifest`` breaks the names' and units' rules or names a
    file, configuration or cell that is not there."""
    out = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[key]]
        if len(set(names)) != len(names):
            out.append(f"{key}: a name used twice")
        for e in manifest[key]:
            if not NAME.fullmatch(e["name"]):
                out.append(f"{key}: bad name {e['name']!r}")
    for c in manifest["configs"]:
        for k in c["reduced"]:
            if not NAME.fullmatch(k):
                out.append(f"config {c['name']}: bad key {k!r}")
        if not (bench.parent / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
    configs = {c["name"] for c in manifest["configs"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for w in manifest["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.fullmatch(w[k]):
                out.append(f"workload {w['name']}: bad {k} {w[k]!r}")
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: no config {w['config']}")
        if not (bench / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic {w['traffic']}")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for key in ("end_to_end", "per_layer"):
        for m in manifest[key]:
            if not UNIT.fullmatch(m["unit"]):
                out.append(f"{m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"{m['name']}: better is {m['better']!r}")
            for c in m.get("workloads", ()):
                if c not in cells:
                    out.append(f"{m['name']}: no cell {c}")
    for m in manifest["end_to_end"]:
        if not (bench / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader metrics/{m['name']}.py")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']}, not end to end")
        if not (bench / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader metrics/{m['name']}.py")
    return out

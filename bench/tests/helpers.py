"""Small cells for the CPU tests: a cell of ``BENCHMARK.json`` at a scale
the CPU runs in seconds, driven through ``run.run_cell`` on the CPU."""
from __future__ import annotations

import sys
import time

from bench import manifest

SRC = str(manifest.ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

SCALES = {"graph500-s16": 11, "graphchallenge-s15": 10}


def small_cell(name: str, scale: int = None,
               edge_factor: int = None) -> manifest.Cell:
    c = manifest.cell(manifest.load(), name)
    c.config = dict(c.config,
                    scale=scale or SCALES[c.workload["config"]])
    if edge_factor:
        c.config["generator"] = dict(c.config["generator"],
                                     edge_factor=edge_factor)
    return c


def run_small(name: str, seed: int = 2**31 + 11, seconds: float = 0.3,
              trace: bool = False, scale: int = None, edge_factor=None,
              control=None):
    from bench import run
    return run.run_cell(small_cell(name, scale, edge_factor), seed, seconds,
                        trace, device="cpu", t_start=time.perf_counter(),
                        control=control)

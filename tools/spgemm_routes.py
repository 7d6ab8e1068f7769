#!/usr/bin/env python3
"""Times the two routes of the masked SpGEMM, ``C<A> = A plus_pair A`` and
its sum (the triangle count), on the Graph Challenge's undirected Graph500
R-MAT as the benchmark's ``graphchallenge-s15`` configuration makes it at
other scales (``bench/data.py``, one relabeling from ``--seed``), 128-tiles:
the tile route (``core.bsr.spgemm``: the symbolic plan and the entry or tile
kernel over a dense output stack) and the masked dot route
(``core.bsr.spgemm_dot``: one count per mask entry, ``csrc/bsr_spgemm_dot.cu``).
``--edge-factors`` makes the graph denser at a scale, so its tiles fuller.
Prints one JSON line per scale, edge factor and route: the median milliseconds of
``--reps`` timed products after one untimed one, the device memory peak,
the operands' stored fill (the route rule's input, ``core.grb.dot_route_ok``),
the mask entries, the dot route's work (the sum of the shorter list's length
over them) and the count, which the two routes must agree on. The tile
route is skipped above ``--tile-max-scale``, and a route that runs out of
the card's memory gives a line with its ``error``. Run from the repository root, on a CUDA card:

    python3 tools/spgemm_routes.py [--scales 8,10,12,14,15,16,18] [--reps 5]
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _timed(fn, reps, sync):
    fn()
    sync()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        v = fn()
        sync()
        out.append((time.perf_counter() - t) * 1e3)
    return v, out


def routes(scale, reps, seed, tile, device="cuda", edge_factor=16):
    import numpy as np
    import torch

    from bench import data, manifest
    from repro_torch import tracing
    from repro_torch.core import bsr as B, grb, semiring as S
    from repro_torch.graph.graph import GraphBuilder

    cfg = manifest.cell(manifest.load(), "tc-graphchallenge-s15").config
    cfg = dict(cfg, scale=scale, generator=dict(cfg["generator"],
                                                edge_factor=edge_factor))
    e = data.make_graph(cfg, np.random.default_rng(seed))
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    g = GraphBuilder(e.n).add_edges("KNOWS", e.src, e.dst).build(
        fmt="bsr", device=device)
    A = g.relation("KNOWS").A
    a, at = A.store, A.T.store
    fill = B.stored_fill(a)

    def count(C):
        return int(grb.reduce(grb.GBMatrix(C), S.PLUS,
                              dtype=torch.float64) / 6.0)

    runs = {"dot": lambda: count(B.spgemm_dot(a, a, S.PLUS_PAIR, a, Bt=at))}
    if tile:
        runs["tile"] = lambda: count(B.spgemm(a, a, S.PLUS_PAIR, mask=a))
    out = []
    for name, fn in runs.items():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        tracing.clear()
        try:
            v, ms = _timed(fn, reps, sync)
        except torch.OutOfMemoryError as err:
            out.append(dict(scale=scale, route=name, edge_factor=edge_factor,
                            fill=fill, error=str(err).split(".")[0]))
            continue
        line = dict(scale=scale, route=name, seed=seed, n=e.n,
                    edge_factor=edge_factor,
                    entries=a.nnz, tiles=a.tiles_held, fill=fill,
                    count=v, ms=statistics.median(ms), ms_all=ms,
                    peak_bytes=(torch.cuda.max_memory_allocated()
                                if cuda else 0),
                    tile_builds=B.tile_builds())
        spans = [r for r in tracing.records() if r.name == "spgemm_dot"]
        if spans:
            line.update(spans[-1].attrs)
        out.append(line)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scales", default="8,10,12,14,15,16,18")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--tile-max-scale", type=int, default=16)
    ap.add_argument("--edge-factors", default="16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from repro_torch import tracing
    tracing.enable()
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build_all()
        torch.cuda.init()
    for s in (int(x) for x in args.scales.split(",")):
        for ef in (int(x) for x in args.edge_factors.split(",")):
            lines = routes(s, args.reps, args.seed,
                           s <= args.tile_max_scale, args.device, ef)
            counts = {ln["count"] for ln in lines if "count" in ln}
            for ln in lines:
                ln["routes_agree"] = len(counts) == 1
                print(json.dumps(ln), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

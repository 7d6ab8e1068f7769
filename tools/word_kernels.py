#!/usr/bin/env python3
"""The two packed-word kernels on one NVIDIA GPU at the k-hop path's
shapes, through the port found under SRC (default the checkout's ``src``;
give another tree's ``src`` to time an older version in the same call):
``ell_mxv_packed`` on the Graph500 R-MAT scale-16 transpose ELL handle
and ``bitadj_mxv_packed`` on the scale-18 transpose BitELL handle, both at
W = 16 words (one 512-query batch).

For each: the kernel through its public wrapper, held against its plain
version with ``torch.equal``, timed by CUDA events (median of 20 calls,
and per call over 50 issued back to back), then the traverse of one
512-seed ``MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)`` batch
(``ExecutionContext.traverse``, synchronised host clock, median of 7).
With ``--sweep`` (this tree's API only): what ``nvcc -Xptxas -v`` reports
for each source, and each kernel at every work-item size, L ids per item
(``core.ell.item_plan``) and K slots per item (``core.bitadj.slot_plan``).
Then the card's name and power limit. One JSON line per measurement. Run
from the repository root:

    python3 tools/word_kernels.py [--src SRC] [--sweep]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 16
TEXT = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"


def time_ms(torch, fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()``, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def loop_ms(torch, fn, reps=50):
    """Milliseconds per call over ``reps`` calls issued back to back
    between two CUDA events: the device's time once the host runs ahead."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def wall_ms(torch, fn, reps=7):
    """Median milliseconds of ``fn()`` by the host clock, synchronised."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def ptxas(build, name):
    """nvcc's resource report for csrc/<name>.cu (built apart, thrown
    away)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), str(build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, timeout=600)
    return [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "error" in ln]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--L", default="32,64,128,256,512")
    ap.add_argument("--K", default="32,64,128,256")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("word_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core import bitadj, ops
    from repro_torch.graph.datagen import rmat_edges, rmat_graph
    from repro_torch.kernels import bitadj_mxv, bitmap_mxv, build
    from repro_torch.query.executor import ExecutionContext
    from repro_torch.query.parser import parse
    from repro_torch.query.planner import plan
    tag = os.path.relpath(os.path.abspath(args.src), ROOT)
    names = ["ell_mxv_packed", "bitadj_mxv_packed"]
    if args.sweep:
        for name in names:
            print(json.dumps({"src": tag, "source": name,
                              "ptxas": ptxas(build, name)}), flush=True)
    build.build_all(names)
    rng = np.random.default_rng(2026)

    def cell(scale, fmt, kernel, plain, sweep):
        g = rmat_graph(scale, fmt=fmt, device="cuda")
        store = g.relations["KNOWS"].A.T.store        # what `->` hops read
        x = rng.integers(0, 2 ** 32, size=(store.shape[1], W),
                         dtype=np.uint64)
        xw = torch.from_numpy(x.astype(np.uint32).view(np.int32)).cuda()
        got = kernel(store, xw)
        want = plain(store, xw)
        torch.cuda.synchronize()
        src, _, _ = rmat_edges(scale)
        seeds = np.random.default_rng(scale).choice(np.unique(src), 512,
                                                    replace=False)
        ctx = ExecutionContext(g)
        p = plan(parse(TEXT))
        print(json.dumps({
            "src": tag, "kernel": kernel.__name__, "scale": scale, "W": W,
            "equal": torch.equal(got, want),
            "ms": time_ms(torch, lambda: kernel(store, xw)),
            "loop_ms": loop_ms(torch, lambda: kernel(store, xw)),
            "traverse_ms": wall_ms(torch, lambda: ctx.traverse(p, seeds))}),
            flush=True)
        if sweep:
            sweep(store, xw, want)

    def ell_sweep(store, xw, want):
        from repro_torch.core.ell import item_plan
        csr = store.row_csr()
        for L in (int(v) for v in args.L.split(",")):
            pl = item_plan(csr, L)
            got = bitmap_mxv.ell_mxv_items(csr, pl, xw)
            torch.cuda.synchronize()
            print(json.dumps({
                "src": tag, "kernel": "ell_mxv_packed", "L": L,
                "items": pl.items, "split_rows": pl.split_rows,
                "equal": torch.equal(got, want),
                "ms": time_ms(torch, lambda: bitmap_mxv.ell_mxv_items(
                    csr, pl, xw)),
                "loop_ms": loop_ms(torch, lambda: bitmap_mxv.ell_mxv_items(
                    csr, pl, xw))}), flush=True)

    def bitadj_sweep(store, xw, want):
        from repro_torch.core.bitadj import slot_plan
        tiles, cols = store.occupied_first()
        for K in (int(v) for v in args.K.split(",")):
            pl = slot_plan(cols, store.shape[0], store.n_ctiles, K)
            got = bitadj_mxv.bitadj_mxv_items(tiles, cols, pl, xw,
                                              store.shape)
            torch.cuda.synchronize()
            print(json.dumps({
                "src": tag, "kernel": "bitadj_mxv_packed", "K": K,
                "items": int(pl.items.shape[0]),
                "split_panels": pl.split_panels,
                "equal": torch.equal(got, want),
                "ms": time_ms(torch, lambda: bitadj_mxv.bitadj_mxv_items(
                    tiles, cols, pl, xw, store.shape)),
                "loop_ms": loop_ms(torch, lambda: bitadj_mxv.bitadj_mxv_items(
                    tiles, cols, pl, xw, store.shape))}), flush=True)

    cell(16, "ell", bitmap_mxv.ell_mxv_packed, ops.ell_mxm_packed,
         ell_sweep if args.sweep else None)
    torch.cuda.empty_cache()
    cell(18, "bitadj", bitadj_mxv.bitadj_mxv_packed, bitadj.mxm_words,
         bitadj_sweep if args.sweep else None)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

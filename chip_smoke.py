#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

The main path is the paper's seeded k-hop count,
``MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) = $s RETURN count(DISTINCT b)``,
submitted through ``repro_torch.engine.QueryServer`` on Graph500 R-MAT
graphs (edge factor 16): ELL at scale 16 (what ``fmt="auto"`` picks) and
BitELL at scale 18. Phases, each printing one JSON line:

  device    the card's name and power limit (nvidia-smi)
  build     both CUDA kernels built from ``src/repro_torch/kernels/csrc``
  kernels   each kernel against its plain PyTorch version, bit for bit, at
            a ragged small shape and at the path's own shapes, with its
            time, the plain version's time and the card's bound
  serve_*   1024 queries per storage kind through the server; launch
            counts, queries/s, latency, and 32 answers held against the
            BFS oracle ``repro_torch.query.reference``

then the kernels line, the nvidia-smi line, and the result line. Any
failed check raises and the script exits non-zero without a result line;
so does a host with no CUDA device. Run from the repository root:

    python3 chip_smoke.py
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
# the kernels' work is 32-bit OR and bit tests, which issue on the integer
# pipes: 64 results per clock per SM for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput) x 132 SMs x the
# 1.98 GHz boost clock of the H100 SXM data sheet, about 16.7e12 per second
INT32_OPS_PER_S = 64 * 132 * 1.98e9
QUERIES = 1024
CHECKED = 32


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of moving ``nbytes`` and doing ``nops`` 32-bit integer ops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, reps=10, warmup=2):
    """Median milliseconds of ``fn()`` on the card, CUDA events around
    each call."""
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core import bitadj, ops
    from repro_torch.core.bitadj import BitELL
    from repro_torch.core.ell import ELL
    from repro_torch.engine import QueryServer
    from repro_torch.graph.datagen import rmat_graph
    from repro_torch.kernels import bitadj_mxv, bitmap_mxv, build
    from repro_torch.engine.server import MAX_WIDTH
    from repro_torch.query.executor import ExecutionContext
    from repro_torch.query.parser import parse
    from repro_torch.query.planner import plan
    from repro_torch.query.reference import Reference

    # -- device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0]})"
    emit(phase="device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # -- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    emit(phase="build", card=card, seconds=time.perf_counter() - t0,
         libraries=sorted(p.name for p in libs.values()))

    rng = np.random.default_rng(2026)
    kern = {}

    def words(k, w):
        x = rng.integers(0, 2 ** 32, size=(k, w), dtype=np.uint64)
        return torch.from_numpy(x.astype(np.uint32).view(np.int32)).cuda()

    def ell_case(store, w, tag, timed):
        xw = words(store.shape[1], w)
        got = bitmap_mxv.ell_mxv_packed(store, xw)
        want = ops.ell_mxm_packed(store, xw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"ell_mxv_packed == plain ({tag})")
        err = int((got.long() - want.long()).abs().max())
        row = dict(phase="kernel", kernel="ell_mxv_packed", shape=tag,
                   card=card, n=store.shape[0], k=store.shape[1],
                   deg=store.max_deg, W=w, equal=True, max_abs_err=err)
        if timed:
            n, k, deg = store.shape[0], store.shape[1], store.max_deg
            # the data's need: each row's valid ids and the sentinel that
            # ends the row (rows are valid-first), the frontier and the
            # output; one OR per edge and word
            ids = int(torch.clamp(store.mask.sum(dim=1) + 1, max=deg).sum())
            nbytes = ids * 4 + k * w * 4 + n * w * 4
            bound_ms, bound_by = bound(nbytes, store.nnz * w)
            row.update(
                kernel_ms=time_ms(torch,
                                  lambda: bitmap_mxv.ell_mxv_packed(store, xw)),
                plain_ms=time_ms(torch,
                                 lambda: ops.ell_mxm_packed(store, xw),
                                 reps=3, warmup=0),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                ids_read=ids, padded_id_bytes=n * deg * 4, library_ms=None)
        emit(**row)
        return row

    def bitadj_case(store, w, tag, timed):
        xw = words(store.shape[1], w)
        got = bitadj_mxv.bitadj_mxv_packed(store, xw)
        want = bitadj.mxm_words(store, xw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"bitadj_mxv_packed == plain ({tag})")
        err = int((got.long() - want.long()).abs().max())
        P, S, _ = store.tiles.shape
        row = dict(phase="kernel", kernel="bitadj_mxv_packed", shape=tag,
                   card=card, n=store.shape[0], k=store.shape[1], P=P, S=S,
                   W=w, equal=True, max_abs_err=err)
        if timed:
            n, k = store.shape
            occ = (store.cols < store.n_ctiles).sum(dim=1)
            occupied = int(occ.sum())
            # the data's need: each panel's occupied slot ids and the
            # sentinel that ends the panel (slots are occupied-first), the
            # tiles of occupied slots, the frontier and the output; one OR
            # per edge and word
            ids = int(torch.clamp(occ + 1, max=S).sum())
            nbytes = ids * 4 + occupied * 32 * 4 + k * w * 4 + n * w * 4
            bound_ms, bound_by = bound(nbytes, store.nnz * w)
            row.update(
                kernel_ms=time_ms(
                    torch, lambda: bitadj_mxv.bitadj_mxv_packed(store, xw)),
                plain_ms=time_ms(torch, lambda: bitadj.mxm_words(store, xw),
                                 reps=3, warmup=0),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                occupied_slots=occupied, ids_read=ids,
                padded_tile_bytes=P * S * 32 * 4,
                library_ms=None)
        emit(**row)
        return row

    # -- kernels at a ragged small shape ---------------------------------------
    r = rng.integers(0, 1000, size=6000)
    c = np.where(r < 32, rng.integers(0, 999, size=6000),
                 rng.integers(0, 64, size=6000))
    small_e = ELL.from_coo(r, c, None, (1000, 999), device="cuda")
    small_b = BitELL.from_coo(r, c, None, (1000, 999), device="cuda")
    for w in (1, 16):
        ell_case(small_e, w, f"ragged n=1000 k=999 W={w}", timed=False)
    for w in (1, 16, 300):
        bitadj_case(small_b, w, f"ragged n=1000 k=999 W={w}", timed=False)
    del small_e, small_b

    def serve(g, texts, kernel_mod, tag):
        """Submit every (text, seed), drive the server once with the launch
        counts at 0, check the answers."""
        srv = QueryServer(g)
        for t, s in texts[:32]:
            srv.submit(t, seeds=[s])
        warm = srv.flush()
        check(len(warm) == 32 and all(v.error is None for v in warm.values()),
              f"{tag}: warm-up batch")
        srv = QueryServer(g)
        bitmap_mxv.launches = 0
        bitadj_mxv.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        qids = [srv.submit(t, seeds=[s]) for t, s in texts]
        out = srv.flush()
        dt = time.perf_counter() - t0
        launches = {"ell_mxv_packed": bitmap_mxv.launches,
                    "bitadj_mxv_packed": bitadj_mxv.launches}
        errors = [out[q].error for q in qids if out[q].error is not None]
        check(not errors, f"{tag}: query errors {errors[:3]}")
        counts = np.array([out[q].scalar() for q in qids])
        check(len(counts) == len(texts) and (counts >= 0).all()
              and (counts < g.n).all(), f"{tag}: counts in range")
        # one launch per hop of each batch: batches per query shape are its
        # total seed width over the server's admission width
        need, batches = 0, 0
        for sig in {m.sig for m in srv.log}:
            members = [m for m in srv.log if m.sig == sig]
            nb = -(-sum(m.width for m in members) // srv.max_width)
            need += nb * members[0].plan.expands[0].max_hops
            batches += nb
        check(srv.stats["batches"] == batches,
              f"{tag}: {srv.stats['batches']} batches, expected {batches}")
        check(launches[kernel_mod] >= need and launches[kernel_mod] > 0,
              f"{tag}: {kernel_mod} launched {launches[kernel_mod]} times, "
              f"needs at least {need}")
        ref = Reference(g)
        pick = np.random.default_rng(7).choice(len(texts), CHECKED,
                                               replace=False)
        t1 = time.perf_counter()
        for i in pick:
            t, s = texts[i]
            want = ref.execute(t.replace("RETURN", f"WHERE id(a) = {s} "
                                         f"RETURN")).scalar()
            check(int(counts[i]) == want,
                  f"{tag}: query {i} (seed {s}) = {counts[i]}, BFS {want}")
        ref_s = time.perf_counter() - t1
        lat = np.array([m.latency_s for m in srv.log]) * 1e3
        emit(phase=f"serve_{tag}", card=card, n=g.n,
             nnz=g.relations["KNOWS"].nnz,
             fmt=g.relations["KNOWS"].A.fmt, queries=len(texts),
             seconds=dt, qps=len(texts) / dt,
             p50_ms=float(np.percentile(lat, 50)),
             p99_ms=float(np.percentile(lat, 99)),
             batches=srv.stats["batches"], pack_ratio=srv.stats["pack_ratio"],
             launches=launches, checked_against_bfs=CHECKED,
             reference_s=ref_s, count_mean=float(counts.mean()),
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        return launches[kernel_mod]

    def breakdown(g, text, seeds, tag):
        """Where one 512-column batch's time goes, as the server spends it:
        traverse (launches, then waits for the device), the copy of the
        frontier to the host, and the per-query host projection."""
        ctx = ExecutionContext(g)
        p0 = plan(parse(text))
        seeds = np.asarray(seeds[:MAX_WIDTH], dtype=np.int64)
        before = bitmap_mxv.launches + bitadj_mxv.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        B = ctx.traverse(p0, seeds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        Bn = B.cpu().numpy()
        t2 = time.perf_counter()
        rows = [ctx.project(dataclasses.replace(p0, seeds=[int(s)]),
                            np.array([s]), Bn[:, j:j + 1]).rows
                for j, s in enumerate(seeds)]
        t3 = time.perf_counter()
        check(len(rows) == len(seeds), f"{tag}: breakdown rows")
        emit(phase=f"breakdown_{tag}", card=card, columns=len(seeds),
             launches=bitmap_mxv.launches + bitadj_mxv.launches - before,
             traverse_ms=1e3 * (t1 - t0), copy_ms=1e3 * (t2 - t1),
             project_ms=1e3 * (t3 - t2), frontier_mb=Bn.nbytes / 1e6)

    # -- ELL: Graph500 scale 16 through fmt="auto" -----------------------------
    t0 = time.perf_counter()
    g = rmat_graph(16, fmt="auto", device="cuda")
    build_s = time.perf_counter() - t0
    A = g.relations["KNOWS"].A
    check(A.fmt == "ell", f"scale 16 fmt='auto' picked {A.fmt}, not ell")
    emit(phase="graph_ell", card=card, scale=16, n=g.n, nnz=A.nvals,
         deg=A.store.max_deg, deg_T=A.T.store.max_deg, build_s=build_s,
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    ell_case(A.store, 16, "scale-16 forward handle W=16", timed=True)
    kern["ell_mxv_packed"] = ell_case(
        A.T.store, 16, "scale-16 transpose handle W=16 (the path's)",
        timed=True)
    out_deg = A.store.mask.sum(dim=1).cpu().numpy()
    seeds = np.random.default_rng(16).choice(
        np.nonzero(out_deg >= 1)[0], QUERIES, replace=False)
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    kern["ell_mxv_packed"]["launches"] = serve(
        g, [(tmpl, int(s)) for s in seeds], "ell_mxv_packed", "ell")
    breakdown(g, tmpl, seeds, "ell")
    del g, A
    gc.collect()
    torch.cuda.empty_cache()

    # -- BitELL: Graph500 scale 18 -------------------------------------------
    t0 = time.perf_counter()
    g = rmat_graph(18, fmt="bitadj", device="cuda")
    build_s = time.perf_counter() - t0
    A = g.relations["KNOWS"].A
    check(A.fmt == "bitadj", f"fmt='bitadj' gave {A.fmt}")
    emit(phase="graph_bitadj", card=card, scale=18, n=g.n, nnz=A.nvals,
         P=A.store.n_panels, S=A.store.n_slots, S_T=A.T.store.n_slots,
         build_s=build_s,
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    bitadj_case(A.store, 16, "scale-18 forward handle W=16", timed=True)
    kern["bitadj_mxv_packed"] = bitadj_case(
        A.T.store, 16, "scale-18 transpose handle W=16 (the path's)",
        timed=True)
    out_deg = bitadj_out_degree(torch, A.store)
    seeds = np.random.default_rng(18).choice(
        np.nonzero(out_deg >= 1)[0], QUERIES, replace=False)
    t12 = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    t23 = "MATCH (a)-[:KNOWS*2..3]->(b) RETURN count(DISTINCT b)"
    texts = [(t12 if i % 2 == 0 else t23, int(s))
             for i, s in enumerate(seeds)]
    kern["bitadj_mxv_packed"]["launches"] = serve(
        g, texts, "bitadj_mxv_packed", "bitadj")
    breakdown(g, t12, seeds[::2], "bitadj")
    del g, A
    gc.collect()
    torch.cuda.empty_cache()

    # -- the kernels line, the card, the result --------------------------------
    sources = {
        "ell_mxv_packed": ("src/repro_torch/kernels/csrc/ell_mxv_packed.cu",
                           "src/repro/kernels/bitmap_mxv.py:63"),
        "bitadj_mxv_packed": (
            "src/repro_torch/kernels/csrc/bitadj_mxv_packed.cu",
            "src/repro/kernels/bitadj_mxv.py:69"),
    }
    line = []
    for name, row in kern.items():
        check(row["launches"] > 0, f"{name} never launched on the main path")
        line.append({"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": row["launches"],
                     "max_abs_err": row["max_abs_err"],
                     "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bitadj_out_degree(torch, store):
    """Per-row edge counts straight off the bit-tiles (SWAR popcount)."""
    from repro_torch.core import bitmap
    per = bitmap.popcount(store.tiles).sum(dim=1)          # (P, 32)
    return per.reshape(-1)[:store.shape[0]].cpu().numpy()


if __name__ == "__main__":
    sys.exit(main())

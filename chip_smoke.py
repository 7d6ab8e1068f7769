#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

The main path is the paper's seeded k-hop count,
``MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) = $s RETURN count(DISTINCT b)``,
(and on BSR also the walk count, ``RETURN count(b)``) submitted through
``repro_torch.engine.QueryServer`` on Graph500 R-MAT graphs (edge factor
16): ELL at scale 16 (what ``fmt="auto"`` picks), BitELL at scale 18, BSR
at scale 16 (the float hop loop, kernel ``bsr_mxm``) and BSR at scale 14
(the ``*1..2`` hop matrix built by SpGEMM, kernel ``bsr_spgemm``, then one
``bsr_mxm`` per batch). Phases, each printing one JSON line:

  device    the card's name and power limit (nvidia-smi)
  build     every CUDA kernel built from ``src/repro_torch/kernels/csrc``
  kernel    each kernel against its plain PyTorch version at a ragged
            small shape and at the path's own shapes, with its time, the
            plain version's time, the card's bound and, where one PyTorch
            call computes the same product, that call's time
  graph_*   each graph's build time, sizes and device memory
  serve_*   1024 queries per cell through the server, with the launch
            counts zeroed just before and read just after; queries/s,
            latency, and 32 answers held against the BFS oracle
            ``repro_torch.query.reference`` (walk counts: against
            ``scipy.sparse`` products of the generator's edges)
  breakdown_*  where one 512-column batch's time goes

then the kernels line, the nvidia-smi line, and the result line. Any
failed check raises and the script exits non-zero without a result line;
so does a host with no CUDA device. Tolerances: every comparison is bit
for bit (words, 0/1 indicators, integer walk counts below 2^24, and
min / max-plus picks), with TF32 off in the plain versions' products.
Run from the repository root:

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
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 peak outside the tensor cores
# the kernels' work is 32-bit OR and bit tests, which issue on the integer
# pipes: 64 results per clock per SM for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput) x 132 SMs x the
# 1.98 GHz boost clock of the H100 SXM data sheet, about 16.7e12 per second
INT32_OPS_PER_S = 64 * 132 * 1.98e9
QUERIES = 1024
CHECKED = 32
DEVICE = "cuda"                # where every graph and operand lives


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def bound(nbytes, nops, ops_per_s=INT32_OPS_PER_S):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of moving ``nbytes`` and doing ``nops`` operations at
    ``ops_per_s`` (32-bit integer ops by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def abs_err(got, want) -> float:
    """Largest |got - want| over entries that differ (equal infinities of
    the tropical identity count as 0)."""
    d = (got - want).abs()
    d[got == want] = 0
    return float(d.max()) if d.numel() else 0.0


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
    from repro_torch.core import semiring as S
    from repro_torch.core.bitadj import BitELL
    from repro_torch.core.bsr import BSR, spgemm_symbolic
    from repro_torch.core.ell import ELL
    from repro_torch.engine import QueryServer
    from repro_torch.graph.datagen import rmat_edges, rmat_graph
    from repro_torch.kernels import (bitadj_mxv, bitmap_mxv, bsr_mxm,
                                     bsr_spgemm, build)
    from repro_torch.engine.server import MAX_WIDTH
    from repro_torch.query.executor import ExecutionContext
    from repro_torch.query.parser import parse
    from repro_torch.query.planner import plan
    from repro_torch.query.reference import Reference

    # the plain versions' products run in full fp32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counted = {"ell_mxv_packed": bitmap_mxv, "bitadj_mxv_packed": bitadj_mxv,
               "bsr_mxm": bsr_mxm, "bsr_spgemm": bsr_spgemm}

    def launches_now():
        return {k: mod.launches for k, mod in counted.items()}

    peak = [0]              # device memory peak over the whole script

    def read_peak():
        """The peak since the last reset, folded into the script's peak."""
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        return torch.cuda.max_memory_allocated()

    def emit_phase(**kw):
        """One JSON line, with the device memory peak since the line
        before it (``peak_gb``)."""
        emit(**kw, peak_gb=read_peak() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    # -- device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0]})"
    emit_phase(phase="device", card=card, torch=torch.__version__,
               cuda=torch.version.cuda, count=torch.cuda.device_count())

    # -- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    emit_phase(phase="build", card=card, seconds=time.perf_counter() - t0,
               libraries=sorted(p.name for p in libs.values()))

    rng = np.random.default_rng(2026)
    kern = {}

    def words(k, w):
        x = rng.integers(0, 2 ** 32, size=(k, w), dtype=np.uint64)
        return torch.from_numpy(
            x.astype(np.uint32).view(np.int32)).to(DEVICE)

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
        emit_phase(**row)
        return row

    def bitadj_case(store, w, tag, timed):
        xw = words(store.shape[1], w)
        got = bitadj_mxv.bitadj_mxv_packed(store, xw)
        want = bitadj.mxm_words(store, xw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"bitadj_mxv_packed == plain ({tag})")
        err = int((got.long() - want.long()).abs().max())
        P, S_, _ = store.tiles.shape
        row = dict(phase="kernel", kernel="bitadj_mxv_packed", shape=tag,
                   card=card, n=store.shape[0], k=store.shape[1], P=P, S=S_,
                   W=w, equal=True, max_abs_err=err)
        if timed:
            n, k = store.shape
            occ = (store.cols < store.n_ctiles).sum(dim=1)
            occupied = int(occ.sum())
            # the data's need: each panel's occupied slot ids and the
            # sentinel that ends the panel (slots are occupied-first), the
            # tiles of occupied slots, the frontier and the output; one OR
            # per edge and word
            ids = int(torch.clamp(occ + 1, max=S_).sum())
            nbytes = ids * 4 + occupied * 32 * 4 + k * w * 4 + n * w * 4
            bound_ms, bound_by = bound(nbytes, store.nnz * w)
            row.update(
                kernel_ms=time_ms(
                    torch, lambda: bitadj_mxv.bitadj_mxv_packed(store, xw)),
                plain_ms=time_ms(torch, lambda: bitadj.mxm_words(store, xw),
                                 reps=3, warmup=0),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                occupied_slots=occupied, ids_read=ids,
                padded_tile_bytes=P * S_ * 32 * 4,
                library_ms=None)
        emit_phase(**row)
        return row

    def bsr_mxm_case(store, X, sr, tag, mask=None, complement=False,
                     timed=False):
        """Kernel 3 against its plain version on one input, bit for bit."""
        def kernel():
            return bsr_mxm.bsr_mxm(store, X, sr, mask=mask,
                                   complement=complement)

        def plain():
            return bsr_mxm.mask_epilogue(ops.bsr_mxm_plain(store, X, sr),
                                         mask, complement, sr.identity)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"bsr_mxm == plain ({tag}, {sr.name})")
        n, m = store.shape
        F = X.shape[1]
        row = dict(phase="kernel", kernel="bsr_mxm", shape=tag, card=card,
                   semiring=sr.name, masked=mask is not None,
                   complement=complement, n=n, m=m, F=F, block=store.block,
                   equal=True, max_abs_err=abs_err(got, want))
        if timed:
            tiles = int(store.valid.sum())
            b = store.block
            # the data's need: each stored tile read once (the tiles are
            # the only record of where the entries are), the frontier, the
            # mask and the output; one multiply-add (2 fp32 operations) per
            # stored entry and frontier column. The kernel multiplies whole
            # tiles: tile_bound_ms is that work at the fp32 peak.
            nbytes = (tiles * b * b * 4 + m * F * 4 + n * F * 4
                      * (2 if mask is not None else 1))
            bound_ms, bound_by = bound(nbytes, 2 * store.nnz * F,
                                       FP32_FLOPS_PER_S)
            row.update(kernel_ms=time_ms(torch, kernel),
                       plain_ms=time_ms(torch, plain, reps=3, warmup=1),
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                       entries=store.nnz, valid_tiles=tiles,
                       tile_bound_ms=bound(nbytes, 2 * tiles * b * b * F,
                                           FP32_FLOPS_PER_S)[0])
        emit_phase(**row)
        return row

    def spgemm_case(A, B, sr, tag, mask=None, complement=False, timed=False):
        """Kernel 4 against its plain version on one plan, bit for bit."""
        plan_ = spgemm_symbolic(A, B, mask, complement)
        mb = None
        if mask is not None:
            sel = torch.from_numpy(np.clip(plan_.mask_sel, 0, None)).long()
            mb = (mask.blocks[sel.to(DEVICE)] * torch.from_numpy(
                plan_.mask_sel >= 0).float().to(DEVICE)[:, None, None])

        def kernel():
            return bsr_spgemm.spgemm_blocks(A.blocks, B.blocks, plan_, sr,
                                            mask_blocks=mb,
                                            complement=complement)

        def plain():
            return bsr_spgemm.spgemm_blocks_plain(A.blocks, B.blocks, plan_,
                                                  sr, mb, complement)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"bsr_spgemm == plain ({tag}, {sr.name})")
        b = A.block
        tasks = int(plan_.valid.sum())
        row = dict(phase="kernel", kernel="bsr_spgemm", shape=tag, card=card,
                   semiring=sr.name, masked=mask is not None, block=b,
                   tasks=tasks, output_tiles=plan_.nc, equal=True,
                   max_abs_err=abs_err(got, want))
        del got, want
        if timed:
            # the data's need: the A and B tiles once each, the plan's
            # selections and run pointer, the output tiles; one multiply-add
            # (2 fp32 operations) per pair of stored entries A[i,k], B[k,j].
            # The kernel multiplies whole tiles, b^3 per task:
            # tile_bound_ms is that work at the fp32 peak.
            nbytes = ((int(A.valid.sum()) + int(B.valid.sum())) * b * b * 4
                      + plan_.ntasks * 3 * 4 + (plan_.nc + 1) * 4
                      + plan_.nc * b * b * 4)
            ra, ca, _ = A.to_coo()
            rb, _, _ = B.to_coo()
            k = A.shape[1]
            pairs = int((np.bincount(ca, minlength=k).astype(np.int64)
                         * np.bincount(rb, minlength=k)).sum())
            bound_ms, bound_by = bound(nbytes, 2 * pairs, FP32_FLOPS_PER_S)
            row.update(kernel_ms=time_ms(torch, kernel, reps=5),
                       plain_ms=time_ms(torch, plain, reps=2, warmup=0),
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                       entry_products=pairs,
                       tile_bound_ms=bound(nbytes, 2 * tasks * b ** 3,
                                           FP32_FLOPS_PER_S)[0])
        emit_phase(**row)
        return row

    # -- kernels at ragged small shapes ---------------------------------------
    r = rng.integers(0, 1000, size=6000)
    c = np.where(r < 32, rng.integers(0, 999, size=6000),
                 rng.integers(0, 64, size=6000))
    small_e = ELL.from_coo(r, c, None, (1000, 999), device=DEVICE)
    small_b = BitELL.from_coo(r, c, None, (1000, 999), device=DEVICE)
    for w in (1, 16):
        ell_case(small_e, w, f"ragged n=1000 k=999 W={w}", timed=False)
    for w in (1, 16, 300):
        bitadj_case(small_b, w, f"ragged n=1000 k=999 W={w}", timed=False)
    del small_e, small_b
    # BSR: n % b != 0, an empty block-row (rows 256..383), ragged F, a few
    # explicit zero weights (the emask); integer weights keep dot exact
    keep = (r < 256) | (r >= 384)
    v = rng.integers(0, 4, size=int(keep.sum())).astype(np.float64)
    small_s = BSR.from_coo(r[keep], c[keep], v, (1000, 999), block=128,
                           device=DEVICE)
    Xs = torch.from_numpy(rng.integers(0, 3, size=(999, 300)).astype(
        np.float32)).to(DEVICE)
    Ms = torch.from_numpy((rng.uniform(size=(1000, 300)) < 0.5).astype(
        np.float32)).to(DEVICE)
    for name in ("plus_times", "or_and", "plus_pair", "plus_first",
                 "min_plus", "max_plus"):
        for mask, comp in ((None, False), (Ms, True)):
            bsr_mxm_case(small_s, Xs, S.get(name), "ragged n=1000 m=999 F=300",
                         mask=mask, complement=comp)
    small_t = BSR.from_coo(c[keep], r[keep], v, (999, 1000), block=128,
                           device=DEVICE)
    for name in ("plus_times", "or_and", "plus_pair", "plus_first"):
        spgemm_case(small_s, small_t, S.get(name), "ragged 1000x999x1000")
    spgemm_case(small_s, small_t, S.OR_AND, "ragged 1000x999x1000",
                mask=BSR.from_coo(r, r, None, (1000, 1000), block=128,
                                  device=DEVICE), complement=True)
    del small_s, small_t, Xs, Ms

    def serve(g, texts, needs, tag, want_fn, prime=False):
        """Submit every (text, seed), drive the server once with the launch
        counts at 0, check the answers. ``needs`` maps each kernel of the
        cell to the launches it must make: at least "hops" (one per hop of
        each batch) or "batches" (one per batch), or exactly "once". With
        ``prime`` the fresh server first answers one query alone (building
        the context's caches, the hop matrix) inside the counted run,
        timed apart from the served batches."""
        srv = QueryServer(g)
        for t, s in texts[:32]:
            srv.submit(t, seeds=[s])
        warm = srv.flush()
        check(len(warm) == 32 and all(v.error is None for v in warm.values()),
              f"{tag}: warm-up batch")
        srv = QueryServer(g)
        for mod in counted.values():
            mod.launches = 0
        torch.cuda.synchronize()
        setup_peak = read_peak()    # since the line before: the warm-up
        torch.cuda.reset_peak_memory_stats()
        prime_s, primed = None, 0
        if prime:
            t0 = time.perf_counter()
            q0 = srv.submit(texts[0][0], seeds=[texts[0][1]])
            p0 = srv.flush()
            check(p0[q0].error is None, f"{tag}: priming query")
            prime_s, primed = time.perf_counter() - t0, 1
        b0 = srv.stats["batches"]
        t0 = time.perf_counter()
        qids = [srv.submit(t, seeds=[s]) for t, s in texts]
        out = srv.flush()
        dt = time.perf_counter() - t0
        launches = launches_now()
        errors = [out[q].error for q in qids if out[q].error is not None]
        check(not errors, f"{tag}: query errors {errors[:3]}")
        counts = np.array([out[q].scalar() for q in qids])
        check(len(counts) == len(texts) and (counts >= 0).all(),
              f"{tag}: counts in range")
        # batches per query shape are its total seed width over the
        # server's admission width
        log = srv.log[primed:]
        hops, batches = 0, 0
        for sig in {m.sig for m in log}:
            members = [m for m in log if m.sig == sig]
            nb = -(-sum(m.width for m in members) // srv.max_width)
            hops += nb * members[0].plan.expands[0].max_hops
            batches += nb
        check(srv.stats["batches"] - b0 == batches,
              f"{tag}: {srv.stats['batches'] - b0} batches, expected "
              f"{batches}")
        for k, how in needs.items():
            need = {"hops": hops, "batches": batches, "once": 1}[how]
            check(launches[k] >= need and launches[k] > 0,
                  f"{tag}: {k} launched {launches[k]} times, needs at "
                  f"least {need}")
            # "once": built on the first batch, cached by the server's one
            # context for the rest
            check(how != "once" or launches[k] == 1,
                  f"{tag}: {k} launched {launches[k]} times, not once")
        pick = np.random.default_rng(7).choice(len(texts), CHECKED,
                                               replace=False)
        t1 = time.perf_counter()
        for i in pick:
            want = want_fn(*texts[i])
            check(int(counts[i]) == want,
                  f"{tag}: query {i} ({texts[i]}) = {counts[i]}, want {want}")
        ref_s = time.perf_counter() - t1
        lat = np.array([m.latency_s for m in log]) * 1e3
        emit_phase(phase=f"serve_{tag}", card=card, n=g.n,
                   nnz=g.relations["KNOWS"].nnz,
                   fmt=g.relations["KNOWS"].A.fmt, queries=len(texts),
                   seconds=dt, qps=len(texts) / dt,
                   p50_ms=float(np.percentile(lat, 50)),
                   p99_ms=float(np.percentile(lat, 99)),
                   batches=batches, pack_ratio=srv.stats["pack_ratio"],
                   launches={k: launches[k] for k in needs},
                   checked=CHECKED, reference_s=ref_s,
                   count_mean=float(counts.mean()), prime_s=prime_s,
                   setup_peak_gb=setup_peak / 1e9)
        return launches

    def bfs_want(g):
        ref = Reference(g)

        def want(t, s):
            return ref.execute(t.replace("RETURN", f"WHERE id(a) = {s} "
                                         f"RETURN")).scalar()
        return want

    def breakdown(g, text, seeds, tag, ctx=None):
        """Where one 512-column batch's time goes, as the server spends it:
        traverse (launches, then waits for the device), the copy of the
        frontier to the host, and the per-query host projection."""
        ctx = ctx or ExecutionContext(g)
        p0 = plan(parse(text))
        seeds = np.asarray(seeds[:MAX_WIDTH], dtype=np.int64)
        before = sum(launches_now().values())
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
        emit_phase(phase=f"breakdown_{tag}", card=card, columns=len(seeds),
                   launches=sum(launches_now().values()) - before,
                   traverse_ms=1e3 * (t1 - t0), copy_ms=1e3 * (t2 - t1),
                   project_ms=1e3 * (t3 - t2), frontier_mb=Bn.nbytes / 1e6)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    t12 = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    w12 = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(b)"

    # -- ELL: Graph500 scale 16 through fmt="auto" -----------------------------
    t0 = time.perf_counter()
    g = rmat_graph(16, fmt="auto", device=DEVICE)
    build_s = time.perf_counter() - t0
    A = g.relations["KNOWS"].A
    check(A.fmt == "ell", f"scale 16 fmt='auto' picked {A.fmt}, not ell")
    emit_phase(phase="graph_ell", card=card, scale=16, n=g.n, nnz=A.nvals,
               deg=A.store.max_deg, deg_T=A.T.store.max_deg, build_s=build_s,
               memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    ell_case(A.store, 16, "scale-16 forward handle W=16", timed=True)
    kern["ell_mxv_packed"] = ell_case(
        A.T.store, 16, "scale-16 transpose handle W=16 (the path's)",
        timed=True)
    out_deg = A.store.mask.sum(dim=1).cpu().numpy()
    seeds = np.random.default_rng(16).choice(
        np.nonzero(out_deg >= 1)[0], QUERIES, replace=False)
    kern["ell_mxv_packed"]["launches"] = serve(
        g, [(t12, int(s)) for s in seeds], {"ell_mxv_packed": "hops"}, "ell",
        bfs_want(g))["ell_mxv_packed"]
    breakdown(g, t12, seeds, "ell")
    del g, A
    release()

    # -- BitELL: Graph500 scale 18 -------------------------------------------
    t0 = time.perf_counter()
    g = rmat_graph(18, fmt="bitadj", device=DEVICE)
    build_s = time.perf_counter() - t0
    A = g.relations["KNOWS"].A
    check(A.fmt == "bitadj", f"fmt='bitadj' gave {A.fmt}")
    emit_phase(phase="graph_bitadj", card=card, scale=18, n=g.n, nnz=A.nvals,
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
    t23 = "MATCH (a)-[:KNOWS*2..3]->(b) RETURN count(DISTINCT b)"
    texts = [(t12 if i % 2 == 0 else t23, int(s))
             for i, s in enumerate(seeds)]
    kern["bitadj_mxv_packed"]["launches"] = serve(
        g, texts, {"bitadj_mxv_packed": "hops"}, "bitadj",
        bfs_want(g))["bitadj_mxv_packed"]
    breakdown(g, t12, seeds[::2], "bitadj")
    del g, A
    release()

    # -- BSR: Graph500 scale 16, the float hop loop ---------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = rmat_graph(16, fmt="bsr", device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    A = g.relations["KNOWS"].A
    AT = A.T.store                         # the handle `->` hops read
    check(A.fmt == "bsr", f"fmt='bsr' gave {A.fmt}")
    emit_phase(phase="graph_bsr", card=card, scale=16, n=g.n, nnz=A.nvals,
               block=A.store.block, tiles=int(A.store.valid.sum()),
               tiles_T=int(AT.valid.sum()), nnzb=A.store.nnzb, nnzb_T=AT.nnzb,
               fill_ratio=A.store.fill_ratio, build_s=build_s,
               memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    out_deg = bsr_out_degree(torch, A.store)
    seeds = np.random.default_rng(16).choice(
        np.nonzero(out_deg >= 1)[0], QUERIES, replace=False)
    # the path's shape: hop 2 of one 512-column batch, the hop-1 frontier
    # under the <!visited> mask (count(DISTINCT b)) and as walk counts
    ctx = ExecutionContext(g)
    B0 = ctx.seed_frontier(seeds[:MAX_WIDTH])
    X1 = bsr_mxm.bsr_mxm(AT, B0, S.OR_AND, mask=B0, complement=True)
    visited = torch.maximum(B0, X1)
    rows3 = [bsr_mxm_case(AT, X1, S.OR_AND, "scale-16 transpose handle "
                          "F=512, hop 2 (the path's)", mask=visited,
                          complement=True, timed=True),
             bsr_mxm_case(AT, X1, S.PLUS_TIMES, "scale-16 transpose handle "
                          "F=512, hop 2 (the path's)", timed=True)]
    kern["bsr_mxm"] = dict(rows3[0], max_abs_err=max(
        r_["max_abs_err"] for r_ in rows3))
    kern["bsr_mxm"]["library_ms"], why = library_bsr_mm(torch, AT, X1)
    emit_phase(phase="library", kernel="bsr_mxm", card=card,
               call="torch.sparse_bsr_tensor @ dense frontier, F=512",
               library_ms=kern["bsr_mxm"]["library_ms"], reason=why)
    del B0, X1, visited
    src, dst, n = rmat_edges(16)
    texts = [(t12 if i % 2 == 0 else w12, int(s))
             for i, s in enumerate(seeds)]
    bfs = bfs_want(g)
    walks = walk_counts(src, dst, n)
    want = (lambda t, s: bfs(t, s) if "DISTINCT" in t else int(walks[s]))
    kern["bsr_mxm"]["launches"] = serve(
        g, texts, {"bsr_mxm": "hops"}, "bsr", want)["bsr_mxm"]
    breakdown(g, t12, seeds[::2], "bsr")
    del g, A, AT, ctx, bfs, want
    release()

    # -- BSR: Graph500 scale 14, the *1..2 hop matrix (SpGEMM) ---------------
    t0 = time.perf_counter()
    g = rmat_graph(14, fmt="bsr", device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    A = g.relations["KNOWS"].A
    AT = A.T.store
    ctx = ExecutionContext(g)
    check(g.n <= ctx.SPGEMM_EXPAND_MAX_N, "scale 14 admits the hop matrix")
    t0 = time.perf_counter()
    P = ctx._hop_matrix("KNOWS", True, 2)
    torch.cuda.synchronize()
    hop_s = time.perf_counter() - t0
    emit_phase(phase="graph_bsr_hop", card=card, scale=14, n=g.n, nnz=A.nvals,
               tiles=int(A.store.valid.sum()), tiles_T=int(AT.valid.sum()),
               build_s=build_s, hop_matrix_s=hop_s,
               hop_tiles=int(P.store.valid.sum()), hop_entries=P.nvals,
               memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    kern["bsr_spgemm"] = spgemm_case(
        AT, AT, S.OR_AND, "scale-14 transpose handle squared (the path's)",
        timed=True)
    kern["bsr_spgemm"]["library_ms"], why = library_spgemm(torch, AT)
    emit_phase(phase="library", kernel="bsr_spgemm", card=card,
               call="torch.sparse.mm of two CSR tensors (cuSPARSE SpGEMM)",
               library_ms=kern["bsr_spgemm"]["library_ms"], reason=why)
    out_deg = bsr_out_degree(torch, A.store)
    seeds = np.random.default_rng(14).choice(
        np.nonzero(out_deg >= 1)[0], QUERIES, replace=False)
    breakdown(g, t12, seeds, "bsr_hop", ctx)       # its hop matrix is built
    del P, ctx
    launched = serve(g, [(t12, int(s)) for s in seeds],
                     {"bsr_spgemm": "once", "bsr_mxm": "batches"}, "bsr_hop",
                     bfs_want(g), prime=True)
    kern["bsr_spgemm"]["launches"] = launched["bsr_spgemm"]
    kern["bsr_mxm"]["launches"] += launched["bsr_mxm"]
    del g, A, AT
    release()

    # -- the kernels line, the card, the result --------------------------------
    sources = {
        "ell_mxv_packed": ("src/repro_torch/kernels/csrc/ell_mxv_packed.cu",
                           "src/repro/kernels/bitmap_mxv.py:63"),
        "bitadj_mxv_packed": (
            "src/repro_torch/kernels/csrc/bitadj_mxv_packed.cu",
            "src/repro/kernels/bitadj_mxv.py:69"),
        "bsr_mxm": ("src/repro_torch/kernels/csrc/bsr_mxm.cu",
                    "src/repro/kernels/bsr_mxm.py:112"),
        "bsr_spgemm": ("src/repro_torch/kernels/csrc/bsr_spgemm.cu",
                       "src/repro/kernels/bsr_spgemm.py:161"),
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
    check(len(line) == len(sources), "every kernel has a row")
    read_peak()
    emit_phase(phase="memory", card=card,
               max_memory_allocated_gb=peak[0] / 1e9)
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bitadj_out_degree(torch, store):
    """Per-row edge counts straight off the bit-tiles (SWAR popcount), 256
    panels at a time: the popcount works in int64, and over all 6.2 GB of
    scale-18 tiles at once its temporaries took the device to 75 GB."""
    from repro_torch.core import bitmap
    per = torch.cat([bitmap.popcount(store.tiles[lo:lo + 256]).sum(dim=1)
                     for lo in range(0, store.tiles.shape[0], 256)])
    return per.reshape(-1)[:store.shape[0]].cpu().numpy()


def bsr_out_degree(torch, store):
    """Per-row stored-entry counts of a BSR's valid tiles."""
    b = store.block
    per = torch.zeros(store.nbrows * b, dtype=torch.int64,
                      device=store.device)
    step = 8192
    for lo in range(0, store.nnzb, step):
        cnt = (store.blocks[lo:lo + step] != 0).sum(dim=2)      # (c, b)
        cnt = cnt * (store.valid[lo:lo + step] != 0)[:, None]
        rows = (store.block_rows[lo:lo + step].long()[:, None] * b
                + torch.arange(b, device=store.device))
        per.index_add_(0, rows.reshape(-1), cnt.reshape(-1))
    return per[:store.shape[0]].cpu().numpy()


def walk_counts(src, dst, n):
    """count(b) of ``(a)-[*1..2]->(b)`` per seed, from the generator's edges
    deduplicated as the graph builder does: out-degree plus the sum of the
    out-neighbours' out-degrees (scipy.sparse on the host)."""
    import scipy.sparse as sp
    key = np.unique(src * n + dst)
    A = sp.csr_matrix((np.ones(len(key)), (key // n, key % n)), shape=(n, n))
    deg = np.asarray(A.sum(axis=1)).ravel()
    return (deg + A @ deg).astype(np.int64)


def library_bsr_mm(torch, store, X):
    """(ms, reason): one PyTorch call for the BSR x dense product of the
    valid tiles (``torch.sparse_bsr_tensor @ X``, which PyTorch routes to
    its own BSR kernel), or None and why it did not run. A yardstick only:
    the port never calls it."""
    try:
        v = torch.nonzero(store.valid, as_tuple=True)[0]
        rows = store.block_rows[v].long()
        crow = torch.zeros(store.nbrows + 1, dtype=torch.int64,
                           device=store.device)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=store.nbrows),
                                0)
        b = store.block
        pad_m = store.nbcols * b - store.shape[1]
        Xp = torch.nn.functional.pad(X, (0, 0, 0, pad_m))
        M = torch.sparse_bsr_tensor(
            crow, store.block_cols[v].long(), store.blocks[v],
            size=(store.nbrows * b, store.nbcols * b))
        ms = time_ms(torch, lambda: M @ Xp, reps=5)
        return ms, None
    except Exception as e:         # the yardstick only; no phase depends on it
        return None, f"{type(e).__name__}: {e}"[:300]


def library_spgemm(torch, store):
    """(ms, reason): ``torch.sparse.mm`` of the handle's CSR form with
    itself (cuSPARSE SpGEMM), or None and why it did not run."""
    try:
        r, c, v = store.to_coo()
        n = store.shape[0]
        M = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([r, c])), torch.from_numpy(v),
            (n, n)).coalesce().to_sparse_csr().to(DEVICE)
        ms = time_ms(torch, lambda: torch.sparse.mm(M, M), reps=5)
        return ms, None
    except Exception as e:         # the yardstick only; no phase depends on it
        return None, f"{type(e).__name__}: {e}"[:300]


if __name__ == "__main__":
    sys.exit(main())

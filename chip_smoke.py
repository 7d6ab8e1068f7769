#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

The main path is the paper's seeded k-hop count,
``MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) = $s RETURN count(DISTINCT b)``,
(and on BSR also the walk count, ``RETURN count(b)``) submitted through
``repro_torch.engine.QueryServer`` on Graph500 R-MAT graphs (edge factor
16): ELL at scale 16 (what ``fmt="auto"`` picks), BitELL at scale 18, BSR
at scale 16 (the float hop loop, kernel ``bsr_mxm``) and BSR at scale 14
(the ``*1..2`` hop matrix built by SpGEMM, kernel ``bsr_spgemm``, then one
``bsr_mxm`` per batch); then the GraphChallenge analytics on an undirected
Graph500 R-MAT scale-15 BSR graph through ``repro_torch.algorithms``:
``triangle_count``, ``ktruss(k=4)``, ``similarity_matrix`` and
``similarity`` (kernels ``bsr_spgemm_dot``, the masked dot SpGEMM that
``core.grb``'s route rule picks at Graph500 fill, ``bsr_ewise``,
``bsr_mxm``).
Each BSR kernel has two variants: an entry kernel (stored entries) and a
tile kernel (whole tiles), picked by the operands' fill against a
crossover table measured by this script's fill sweeps; Graph500 tiles take
the entry kernels, the sweeps and full tiles the tile kernels.
Phases, each printing one JSON line:

  device    the card's name and power limit (nvidia-smi)
  build     every CUDA kernel built from ``src/repro_torch/kernels/csrc``
  kernel    each kernel against its plain PyTorch version at a ragged
            small shape and at the path's own shapes (the two variants of
            a BSR kernel also against each other), with the dispatch's
            pick, each kernel's time, the plain versions' times, the
            card's bound and, where one PyTorch call computes the same
            product, that call's time; for ``bsr_spgemm`` also the
            entry-form build, the dispatch, the host plan and the whole
            SpGEMM as the path calls it, for ``bsr_ewise`` the payload
            forms' build and the whole op as the path calls it; for the
            two word kernels also their work plans (items, the longest
            row or the hub panel's slots), the frontier bytes gathered
            from L2, the device memory once the forms and plans are
            built, the time per call issued back to back (``loop_ms``)
            and the time before their redesign (``earlier_ms``)
  fill_sweep  both variants of ``bsr_spgemm``, ``bsr_mxm`` and
            ``bsr_ewise`` at each tile side 16-128 from 0.2% to 100% fill:
            where the entry kernel stops winning (each kernel's crossover
            table, by side)
  clustered_sweep  the same on a planted-partition graph that
            ``fmt="auto"`` stores as BSR, 3-22% full: the crossovers on
            uneven tiles
  graph_*   each graph's build time, sizes and device memory
  serve_*   1024 queries per cell through the server, with the launch
            counts zeroed just before and read just after; queries/s,
            latency, and 32 answers held against the BFS oracle
            ``repro_torch.query.reference`` (walk counts: against
            ``scipy.sparse`` products of the generator's edges)
  breakdown_*  where one 512-column batch's time goes
  any_pair  after each of the s16 ELL, s18 BitELL and s16 BSR cells, on
            the served handle: ``grb.mxm(A, X, ANY_PAIR)`` at F = 512
            launches or_and's kernel once (``ell_mxv_packed``,
            ``bitadj_mxv_packed``, the ``bsr_mxm`` entry kernel) and equals
            or_and bit for bit; on ELL also under
            ``packed_frontiers("off")``, with no word launch
  graph_analytics, triangles, ktruss, similarity
            the analytics cell: its graph, then each call with the launch
            counts zeroed just before and read just after, held against
            ``scipy.sparse`` oracles (triangle count and every truss edge
            and support exactly, Jaccard scores within 1e-6 relative)
  library   one PyTorch call computing what a kernel computes, a yardstick
  algo_*    the remaining algorithms and ``CALL algo.*`` (``algorithm_cells``)
  mesh_*    the mesh (``mesh_cells``): (pod, data, model) meshes of 4 and 8
            positions on the one card (``distinct_devices`` 1: no figure
            here is a multi-GPU figure); 1024 k-hop queries through
            ``QueryServer(mesh=)`` on R-MAT s16 ELL at (1, 4, 1) and
            (2, 2, 2) and on s18 BitELL at (1, 4, 1), every row equal to
            the unsharded server's, 32 against the BFS oracle, no host
            transfer; ``Database.query(mesh=)`` on an s16 graph with
            pending deltas (frozen as compacted ELL); BFS, k-hop, SSSP,
            WCC and PageRank on the distributed s16 ELL; the unlinked
            transposed lowerings against the linked twin at 4 and 16 row
            shards; each word kernel at one position's local shapes with
            the gather, kernel and hop times and the all-gather bytes,
            and (``mesh_shards``) at every shard-local handle and word
            width that the served, algorithm and database phases ran,
            bit for bit against its plain version
  probe_graph500*  the paper's ``graph500_s21`` config (``probe_cells``)
            at its published widths: R-MAT scale 21, edge factor 16, each
            vertex's in-neighbours deduplicated and cut to the first 64 by
            source id (the config's (N, 64) ELL; the shares of edges and
            rows the cut drops are printed), 256 seeded queries, k = 2;
            ``distr.graph2d.khop_counts_2d`` in its int8, bitmap and
            bitmap + sentinel forms on a ("data", "model") = (4, 2) mesh of
            the card's positions and the bitmap form on (2, 2, 2), every
            count equal to a ``scipy.sparse`` oracle, ``ell_mxv_packed``
            launched once per position per hop, each probe shard handle
            bit for bit against its plain version (position 0 timed), a
            hop's gather, local and whole times, and the all-gather bytes
            of words against int8; ``pagerank_2d`` (10 iterations, float32
            push within L1 1e-5 of a float64 scipy power iteration, the
            bfloat16 push's L1 printed)
  dryrun_graph  ``python -m repro_torch.launch.dryrun --graph --mesh
            both`` into ``experiments/dryrun_graph``: one line per cell (16
            cells: layout, position 0's counted cost, memory and roofline),
            and the layout accounting of the (4, 2) mesh equal to the bytes
            the probes held (arguments, gathered frontiers and push
            vectors)
  write_*   the write path (``write_path_cells``): two ``Database`` graphs
            loaded from R-MAT s16 through ``MutableGraph.create_edge``
            (ELL by ``fmt="auto"``, and BSR with 64-tiles), three rounds
            of 2% deletes and creates sent as fsynced commands of 256
            edges (pending crosses ``AUTO_DELTA_COMPACT`` in round 3),
            each followed by 1024 served k-hop queries on the delta
            handles (kernels ``ell_mxv_packed``, ``bsr_mxm``) against the
            same graph compacted and the scipy BFS of the live edge set,
            and a reader frozen before the round that must not move; the
            kernels bit for bit against their plain versions at the write
            path's shapes (the patch's ELL, the 64-tile bases); writes
            interleaved with reads (one command, then one batch, its
            latency with the freeze and the patch); the read cost at 0-10%
            pending; the five algorithms and k-truss on
            an s14 BSR delta handle (``bsr_spgemm``, ``bsr_ewise``)
            against its compaction; an s12 graph written through CREATE
            and replayed from its AOF; and an s12 dense handle against
            its ELL
  models_parity  the models' serving path (``model_cells``; no TPU kernel
            lies on it): every arch of ``configs.base.ARCHS`` at
            ``launch.serve.tiny_config``, float32 with TF32 off, params
            from one seeded init on the CPU copied to the card: the prefill
            logits and 8 decode steps equal the CPU's within 1e-4, and the
            decode steps equal one forward over the same tokens
  serve_qwen2  qwen2-1.5b at its published widths and depth (bfloat16)
            through ``launch.serve.main`` (``--tiny 0``) at the defaults
            of ``repro.launch.serve`` (batch 4, prompt 16, 16 new tokens)
            and at batch 64, prompt 128, 64 new tokens, each run twice (equal
            tokens): tokens/s, ms a decode step against the step's bound,
            the prefill's ms and the peak memory; decode over a 64-token
            prefix against one forward
  decode_cost  one more batch-4 decode step under the dry-run's counters:
            its FLOPs and bytes equal to ``launch.dryrun``'s count of the
            same step on meta tensors, its peak within 10% of the
            dry-run's; the roofline's bound beside the step's ms
  models_widths  every other arch at its published widths (bfloat16),
            its depth cut (``WIDTH_LAYERS``): a 32-token prefill, decode
            over it against one forward, 8 greedy steps, every logit finite
  train_parity  the models' training path (``train_cells``; no TPU
            kernel lies on it either): every arch at the serve entry
            point's tiny config, float32 with TF32 off, the loss and every
            gradient leaf on the card against the CPU, then 3 optimizer
            steps (AdamW; llama4 one Adafactor step; qwen2 with 2
            microbatches and int8 compression), each step's loss and the
            params after them against the CPU's
  train_qwen2  qwen2-1.5b at its published size (bfloat16, AdamW, remat)
            through ``launch.train`` at batch 8 x 1,024 tokens: 10 steps,
            one checkpoint (host copy, write, bytes), a restore into a fresh
            state held to the saved one bit for bit, the last 2 of 12 steps
            from both (uninterrupted and resumed losses compared); losses,
            ms a step, tokens/s against the step's bound, peak memory, and
            one step under ``torch.profiler`` (launches, device-busy ms)
  train_cost  one more step's forward and backward under the dry-run's
            counters: its FLOPs and bytes equal to ``launch.dryrun``'s
            count on a one-position mesh; one sharded step on that mesh of
            the card, its peak within 10% of the dry-run's; the roofline's
            bound beside the step's ms and the hand formula's bound
  train_mesh  the models on the mesh (``train_mesh_cells``; no TPU kernel
            lies on it): that checkpoint restored onto ("data", "model")
            = (2, 16) of the card's positions, its gather against the
            manifest's sha1s, each position's bytes against the dry-run's,
            one sharded step against the unsharded step with 2
            microbatches; a worker's heartbeats stop (``RestartPolicy``
            under a fake clock), ``plan_restart`` gives (1, 16), and the
            same restore and step there; restore seconds, step ms,
            collectives, bytes a position, the differences
  dryrun_models  ``launch.dryrun --all --mesh both --no-cost`` on meta
            positions, every cell ok, qwen2-1.5b's cells again with their
            cost, memory and roofline, qwen2-1.5b's train cell on each
            ``train_mesh`` mesh equal to the bytes placed there

then the kernels line (the word kernels' rows with their launches under
the mesh, ``mesh_launches``, and their rows at a position's local shapes
and at every shard shape the mesh path ran, ``mesh_shapes``; kernel 1's
launches and shapes under the probes, ``probe_launches`` /
``probe_shapes``; the any_pair launches of rows 1-3), the
nvidia-smi line, and the result line. Any
failed check raises and the script exits non-zero without a result line;
so does a host with no CUDA device. The s18 BitELL's host build runs once
(``bitadj_graph``); each phase that serves it copies its arrays to the card
anew. Tolerances: every kernel comparison
is bit for bit (words, 0/1 indicators, integer walk counts below 2^24,
min / max-plus picks, and the element-wise modes), with TF32 off in the
plain versions' products; Jaccard scores, float32 quotients, are held to
1e-6 relative against float64 oracles; the models' float32 logits within
1e-4, their bfloat16 logits within ``BF16_REL_TOL`` of the largest logit
(``model_cells`` gives the reason); the training path's as ``train_cells``
states.
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
import types

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
ANALYTICS_SCALE = 15           # the HPEC Graph Challenge's graph500 inputs
                               # start at 18; cut to what one run can peel
SIM_SOURCES = 64
# the algorithm cells: R-MAT scale, sources of each seeded call; label
# propagation runs at scale 14, cut from 16, where its host loop builds
# 584 one-hot chunks of 65,536 x 256 (136 at scale 14)
ALGO_SCALE = 16
ALGO_SOURCES = 512
SSSP_SOURCES = 64
BETWEENNESS_SOURCES = 128
LABELPROP_SCALE = 14
LABEL_CHUNK = 256              # labels a CDLP vote chunk (its F)
WCC_BITADJ_SCALE = 18
WCC_BATCH = 128                # seeds a WCC closure takes (wcc's batch)
# the write path: Database graphs on Graph500 R-MAT, written in commands of
# WRITE_COMMAND edges, each round WRITE_FRAC of the base's stored entries
# (half deletes, half creates) so that pending crosses
# core.delta.AUTO_DELTA_COMPACT in round 3; the read cost at each pending
# share; the algorithms on a delta handle at scale 14, recovery and dense
# handles at scale 12 (a 64 MB dense matrix)
WRITE_SCALE = 16
WRITE_ROUNDS = 3
WRITE_FRAC = 0.02
WRITE_COMMAND = 256
WRITE_ALGO_SCALE = 14
RECOVERY_SCALE = 12
DENSE_SCALE = 12
READ_COST_PENDING = (0.0, 0.01, 0.02, 0.05, 0.10)
# interleaved writes and reads: INTERLEAVE_STEPS times one command, then
# one batch of reads, right after round 3's compaction and again after a
# bulk write of INTERLEAVE_BULK of the base (below the threshold)
INTERLEAVE_STEPS = 4
INTERLEAVE_BULK = 0.03
SEED = 0                       # --seed: the write streams' draws
# the mesh: (pod, data, model) meshes whose positions all lie on the one
# card; the served cells on R-MAT s16 ELL (both meshes) and s18 BitELL, the
# algorithms on s16, the transposed lowerings at 4 and at 16 row shards
# (past bitmap.NIBBLE_MAX_SHARDS), the database at s16 with MESH_WRITES
# pending edge writes
MESH_SHAPES = ((1, 4, 1), (2, 2, 2))
MESH_SCALE = 16
MESH_BITADJ_SCALE = 18
MESH_BITADJ_SHAPE = (1, 4, 1)
MESH_ALGO_SOURCES = 64
# SSSP's min_plus hops are plain torch (no word kernel), and 16 sources took
# 2.13 s of the mesh phases' 88.9 s on an H100 80GB HBM3 at 700 W
MESH_SSSP_SOURCES = 16
MESH_WIDE_DATA = 16
MESH_TRANSPOSED_F = 64
MESH_WRITES = 1024
# the paper's workload (configs.graph500, graph500_s21): R-MAT at the
# config's scale with the Graph500 edge factor and seed, PageRank for the
# JAX dry-run's iteration count
PROBE_EDGE_FACTOR = 16
PROBE_SEED = 0
PROBE_PR_ITERS = 10
# the models' serving path (model_cells): every arch at launch.serve's
# tiny config on the card against the CPU (MODEL_PARITY_STEPS decode
# steps); qwen2-1.5b at its published size through launch.serve at the
# JAX entry point's defaults and at a wider batch (batch, prompt, new), its
# decode held to one forward over SERVE_CHECK_PREFIX tokens; every other
# arch at its published widths, depth cut to WIDTH_LAYERS (a WIDTHS_PROMPT
# token prefill, then WIDTHS_STEPS greedy steps)
MODEL_PARITY_STEPS = 8
SERVE_RUNS = ((4, 16, 16), (64, 128, 64))
SERVE_CHECK_PREFIX = 64
PROFILED_STEPS = 4             # decode steps under torch.profiler
WIDTHS_PROMPT = 32
WIDTHS_STEPS = 8
WIDTH_LAYERS = {
    # one layer of llama4's 128 experts is about 32 GB in bfloat16
    "llama4-maverick-400b-a17b": {"n_layers": 1},
    # shared_attn_every + 1: two segments, so the shared block runs twice
    "zamba2-1.2b": {"n_layers": 7},
    "whisper-medium": {"n_layers": 2, "encoder_layers": 2},
}
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bfloat16 (data sheet)
# the training path (train_cells): every arch's serve-entry tiny config,
# TRAIN_PARITY_STEPS optimizer steps card against CPU (TRAIN_PARITY_DENSE
# with microbatches and int8 compression); then qwen2-1.5b at its published
# size through launch.train at TRAIN_BATCH x TRAIN_SEQ tokens a step,
# TRAIN_SAVED_AT steps, one checkpoint, and the last steps resumed from it
TRAIN_PARITY_STEPS = 3
TRAIN_PARITY_LR = 1e-3
TRAIN_PARITY_SHAPE = (2, 8)     # batch, sequence
TRAIN_PARITY_DENSE = "qwen2-1.5b"
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
# 12 steps: at launch.train's lr (1e-3, 5 warmup steps) a fresh batch's
# loss over 151,936-way random-init logits falls about 0.02 in 12 steps and
# not past one batch's noise in 6 (each step lowers its own batch's loss
# by 0.08-0.7: train_cells checks that)
TRAIN_SAVED_AT = 10
TRAIN_STEPS = 12
# resumed losses against the uninterrupted run's, relative (the reason is
# with train_cells)
TRAIN_RESUME_RTOL = 1e-3
# the mesh phase (train_mesh): train_qwen2's state on a ("data", "model")
# mesh of the card's positions, workers of TRAIN_MESH_WORKER positions
TRAIN_MESH = (2, 16)
TRAIN_MESH_WORKER = 8
# bfloat16 decode against one forward: the largest logit difference over
# the largest logit (the reason is with model_cells)
BF16_REL_TOL = 0.05
# the fill sweeps: an n x n matrix at each tile side and fill, frontiers
# of SWEEP_F columns; the planted-partition graph's communities and degrees
SWEEP_N = 8192
SWEEP_F = 512
SWEEP_FILLS = (0.002, 0.01, 0.02, 0.035, 0.05, 0.07, 0.10, 0.15, 0.25,
               0.50, 1.0)
CLUSTER_COMMUNITIES = 256
CLUSTER_D_IN = (4, 8, 16, 32, 64)
# the word kernels' times before their redesign (each thread or block
# walking a whole row or panel): the range of their chip_smoke.py runs on
# an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6
EARLIER_MS = {"ell_mxv_packed": [0.476, 0.519],
              "bitadj_mxv_packed": [1.002, 1.068]}


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


def loop_ms(torch, fn, reps=50):
    """Milliseconds per call over ``reps`` calls issued back to back
    between two CUDA events: the device's time once the host runs ahead
    (``time_ms`` also holds the host's launch time of a short call)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def wall_ms(torch, fn, reps=3):
    """Median milliseconds of ``fn()`` by the host clock, the card
    synchronised before and after: for calls that hold host work."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch import algorithms as algo
    from repro_torch.algorithms.similarity import degrees
    from repro_torch.core import bitadj, grb, ops
    from repro_torch.core import bsr as bsr_mod
    from repro_torch.core import semiring as S
    from repro_torch.core.bitadj import BitELL
    from repro_torch.core.bsr import BSR, spgemm_symbolic
    from repro_torch.core.ell import ELL
    from repro_torch.engine import QueryServer
    from repro_torch.graph.datagen import rmat_edges, rmat_graph
    from repro_torch.graph.graph import GraphBuilder, from_arrays
    from repro_torch.kernels import (bitadj_mxv, bitmap_mxv, bsr_dot,
                                     bsr_ewise, bsr_mxm, bsr_spgemm, build)
    from repro_torch.engine.server import MAX_WIDTH
    from repro_torch.query import execute
    from repro_torch.query.executor import ExecutionContext
    from repro_torch.query.parser import parse
    from repro_torch.query.planner import plan
    from repro_torch.query.reference import Reference

    # the plain versions' products run in full fp32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counted = {"ell_mxv_packed": bitmap_mxv, "bitadj_mxv_packed": bitadj_mxv,
               "bsr_mxm": bsr_mxm, "bsr_spgemm": bsr_spgemm,
               "bsr_ewise": bsr_ewise, "bsr_dot": bsr_dot}

    def launches_now():
        return {k: mod.launches for k, mod in counted.items()}

    variants = (bsr_mxm, bsr_spgemm, bsr_ewise)   # entry and tile kernels

    def zero_launches():
        for mod in counted.values():
            mod.launches = 0
        for mod in variants:
            mod.launches_entry = mod.launches_tile = 0

    def variant_launches():
        return {f"{mod.__name__.rsplit('.', 1)[-1]}_{v}":
                getattr(mod, f"launches_{v}")
                for mod in variants for v in ("entry", "tile")}

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

    def ell_case(store, w, tag, timed, earlier=True):
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
            plan = store.item_plan()          # built by the call above
            # the data's need (the kernel module's count)
            nbytes, nops = bitmap_mxv.launch_cost(
                n, deg, w, k, valid=store.mask.sum(dim=1))
            bound_ms, bound_by = bound(nbytes, nops)
            row.update(
                kernel_ms=time_ms(torch,
                                  lambda: bitmap_mxv.ell_mxv_packed(store, xw)),
                loop_ms=loop_ms(torch,
                                lambda: bitmap_mxv.ell_mxv_packed(store, xw)),
                plain_ms=time_ms(torch,
                                 lambda: ops.ell_mxm_packed(store, xw),
                                 reps=3, warmup=0),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                padded_id_bytes=n * deg * 4, library_ms=None,
                items=plan.items, ids_per_item=plan.L,
                split_rows=plan.split_rows, longest_row=plan.longest_row,
                l2_gather_bytes=store.nnz * w * 4,
                memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
                earlier_ms=EARLIER_MS["ell_mxv_packed"]
                if w == 16 and earlier else None)
        emit_phase(**row)
        return row

    def bitadj_case(store, w, tag, timed, earlier=True):
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
            plan = store.slot_plan()          # built by the call above
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
                loop_ms=loop_ms(
                    torch, lambda: bitadj_mxv.bitadj_mxv_packed(store, xw)),
                plain_ms=time_ms(torch, lambda: bitadj.mxm_words(store, xw),
                                 reps=3, warmup=0),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                occupied_slots=occupied, ids_read=ids,
                padded_tile_bytes=P * S_ * 32 * 4,
                library_ms=None, items=int(plan.items.shape[0]),
                slots_per_item=plan.K, split_panels=plan.split_panels,
                hub_slots=plan.hub_slots,
                l2_gather_bytes=store.nnz * w * 4,
                memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
                earlier_ms=EARLIER_MS["bitadj_mxv_packed"]
                if w == 16 and earlier else None)
        emit_phase(**row)
        return row

    def bsr_mxm_case(store, X, sr, tag, mask=None, complement=False,
                     timed=False, sweep=False, with_tile=True,
                     library="values"):
        """Kernel 3 on one input: the entry kernel against the tile kernel
        and each against its plain version, bit for bit (integer weights
        and frontiers keep every sum exact), and the dispatch's pick.
        Timed: both kernels, both plain versions, each one's bound and
        cuSPARSE SpMM (``torch.sparse.mm``) on the handle's CSR. ``sweep``:
        the two kernels alone, checked against each other.
        ``with_tile=False``: the entry kernel and its plain version only
        (the tile kernel's b * b * F a tile would take seconds a call at
        the shape).
        ``library``: SpMM over the handle's "values", over its "pattern"
        (ones: the plus_pair count), or None (no PyTorch call computes a
        min-plus product)."""
        csr = store.row_csr()

        def entry():
            return bsr_mxm.bsr_mxm_entry(csr, X, sr, mask=mask,
                                         complement=complement)

        def tile():
            return bsr_mxm.bsr_mxm_tile(store, X, sr, mask=mask,
                                        complement=complement)

        def plain_entry():
            return bsr_mxm.mask_epilogue(
                bsr_mxm.bsr_mxm_entry_plain(csr, X, sr), mask, complement,
                sr.identity)

        def plain_tile():
            return bsr_mxm.mask_epilogue(ops.bsr_mxm_plain(store, X, sr),
                                         mask, complement, sr.identity)

        got_d = bsr_mxm.bsr_mxm(store, X, sr, mask=mask,
                                complement=complement)
        picked = bsr_mxm.picked
        got_e = entry()
        if with_tile:
            got_t = tile()
            torch.cuda.synchronize()
            check(torch.equal(got_e, got_t),
                  f"bsr_mxm entry == tile ({tag}, {sr.name})")
            del got_t
        torch.cuda.synchronize()
        check(torch.equal(got_d, got_e),
              f"bsr_mxm dispatch ({picked}) == kernels ({tag}, {sr.name})")
        err = 0.0
        if not sweep:
            plains = [("entry", plain_entry)] + ([("tile", plain_tile)]
                                                 if with_tile else [])
            for what, plain_fn in plains:
                want = plain_fn()
                torch.cuda.synchronize()
                check(torch.equal(got_e, want),
                      f"bsr_mxm {what} == plain ({tag}, {sr.name})")
                err = max(err, abs_err(got_e, want))
                del want
        del got_d
        n, m = store.shape
        F = X.shape[1]
        b = store.block
        row = dict(phase="kernel", kernel="bsr_mxm", shape=tag, card=card,
                   semiring=sr.name, masked=mask is not None,
                   complement=complement, n=n, m=m, F=F, block=b,
                   fill=store.fill_ratio, picked=picked, equal=True,
                   entry_equals_tile=True if with_tile else None,
                   max_abs_err=err)
        if timed or sweep:
            # what each kernel must move: the frontier, the mask and the
            # output once, and its form of A: the row CSR (row pointer,
            # row order, a column and a value an entry) or the stored
            # tiles. The data's work: one multiply-add (2 fp32 operations)
            # per stored entry and frontier column; the tile kernel does
            # b * b a tile per column (tile_work_bound_ms).
            io = m * F * 4 + n * F * 4 * (2 if mask is not None else 1)
            e_bytes = 8 * (n + 1) + 4 * n + 8 * csr.entries + io
            t_bytes = store.tiles_held * b * b * 4 + io
            work = 2 * csr.entries * F
            e_bound = bound(e_bytes, work, FP32_FLOPS_PER_S)
            t_bound = bound(t_bytes, work, FP32_FLOPS_PER_S)
            slow = sweep or store.tiles_held * b * b * F > 1e11
            row.update(
                entry_ms=time_ms(torch, entry),
                tile_ms=time_ms(torch, tile, reps=3 if slow else 10,
                                warmup=1 if slow else 2)
                if with_tile else None,
                entry_bound_ms=e_bound[0], entry_bound_by=e_bound[1],
                entry_bytes=e_bytes, tile_bound_ms=t_bound[0],
                tile_bound_by=t_bound[1], tile_bytes=t_bytes,
                tile_work_bound_ms=bound(
                    t_bytes, 2 * store.tiles_held * b * b * F,
                    FP32_FLOPS_PER_S)[0],
                entries=csr.entries, valid_tiles=store.tiles_held)
        if timed:
            row.update(
                plain_ms=time_ms(torch, plain_entry, reps=3, warmup=1),
                plain_tile_ms=time_ms(torch, plain_tile, reps=2, warmup=0)
                if with_tile else None)
            if library is None:
                row["library_ms"], row["library_reason"] = None, (
                    "no PyTorch call computes a min-plus (tropical) product "
                    "of a sparse matrix and a dense one")
            else:
                row["library_ms"], row["library_reason"] = library_spmm(
                    torch, csr, store.shape, X, pattern=library == "pattern")
            on_path = "entry" if picked == "entry" else "tile"
            row.update(kernel_ms=row[f"{on_path}_ms"],
                       bound_ms=row[f"{on_path}_bound_ms"],
                       bound_by=row[f"{on_path}_bound_by"])
        emit_phase(**row)
        return row

    def spgemm_case(A, B, sr, tag, mask=None, complement=False, timed=False,
                    whole=False):
        """Kernel 4 on one plan: the entry kernel, the tile kernel and the
        plain version, all three bit for bit (0/1 modes, integer weights);
        the dispatch's pick. Timed: each kernel on the plan (built on the
        card), the entry-form build, the dispatch on the two handles as the
        path calls it (the handles' cached forms, kernel) and the plain
        version. ``whole``: also the symbolic plan alone and the whole
        SpGEMM as the path calls it (``core.bsr.spgemm``: plan, mask tiles,
        counts, entry form, kernel, output pruning), by the host clock."""
        plan_ = spgemm_symbolic(A, B, mask, complement)
        mb = None if mask is None else plan_.mask_tiles(mask)

        def form():
            EA = bsr_spgemm.entry_form(A.blocks)
            return EA, (EA if B.blocks is A.blocks
                        else bsr_spgemm.entry_form(B.blocks))

        EA, EB = form()

        def entry():
            return bsr_spgemm.spgemm_entry(EA, EB, plan_, sr, mask_blocks=mb,
                                           complement=complement)

        def tile():
            return bsr_spgemm.spgemm_tile(A.blocks, B.blocks, plan_, sr,
                                          mask_blocks=mb,
                                          complement=complement)

        def dispatch():
            return bsr_spgemm.spgemm_blocks(A, B, plan_, sr, mask_blocks=mb,
                                            complement=complement)

        def plain():
            return bsr_spgemm.spgemm_blocks_plain(A.blocks, B.blocks, plan_,
                                                  sr, mb, complement)

        got_d = dispatch()
        picked = bsr_spgemm.picked
        got_e, got_t, want = entry(), tile(), plain()
        torch.cuda.synchronize()
        for what, got in (("entry", got_e), ("tile", got_t),
                          ("dispatch", got_d)):
            check(torch.equal(got, want),
                  f"bsr_spgemm {what} == plain ({tag}, {sr.name})")
        check(torch.equal(got_e, got_t),
              f"bsr_spgemm entry == tile ({tag}, {sr.name})")
        b = A.block
        tasks = int(plan_.valid.sum())
        fill = bsr_spgemm.operand_fill(*(
            [bsr_spgemm.entry_counts(A.blocks)] if B.blocks is A.blocks else
            [bsr_spgemm.entry_counts(A.blocks),
             bsr_spgemm.entry_counts(B.blocks)]))
        row = dict(phase="kernel", kernel="bsr_spgemm", shape=tag, card=card,
                   semiring=sr.name, masked=mask is not None,
                   complement=complement, block=b, tasks=tasks,
                   output_tiles=plan_.nc, fill=fill, picked=picked,
                   entries=EA.entries + (0 if EB is EA else EB.entries),
                   equal=True, entry_equals_tile=True,
                   max_abs_err=max(abs_err(got_e, want),
                                   abs_err(got_t, want)))
        del got_d, got_e, got_t, want
        if timed:
            # what each kernel must move: its operands once (one operand
            # when B is A), the plan's selections and run pointer, the mask
            # tiles, the output tiles. The entry kernel reads the entry
            # forms (tile base, row_ptr, row, column and value of each
            # entry, band words), the tile kernel whole tiles. The work: one
            # multiply-add (2 fp32 operations) per pair of stored entries
            # A[i,k], B[k,j] (before the mask) for the entry kernel, b^3 a
            # task for the tile kernel.
            forms = [EA] if EB is EA else [EA, EB]
            form_bytes = sum(8 * (f.row_ptr.shape[0] + 1)
                             + 4 * f.row_ptr.numel() + 6 * f.entries
                             + 4 * f.bands.numel() for f in forms)
            stores = [A] if B.blocks is A.blocks else [A, B]
            tile_bytes = sum(int(X.valid.sum()) for X in stores) * b * b * 4
            rest = (plan_.ntasks * 3 * 4 + (plan_.nc + 1) * 4
                    + plan_.nc * b * b * 4 * (1 if mask is None else 2))
            ra, ca, _ = A.to_coo()
            rb, _, _ = B.to_coo()
            k = A.shape[1]
            pairs = int((np.bincount(ca, minlength=k).astype(np.int64)
                         * np.bincount(rb, minlength=k)).sum())
            e_bound = bound(form_bytes + rest, 2 * pairs, FP32_FLOPS_PER_S)
            t_bound = bound(tile_bytes + rest, 2 * tasks * b ** 3,
                            FP32_FLOPS_PER_S)
            entry_ms = time_ms(torch, entry)
            tile_ms = time_ms(torch, tile, reps=5)
            on_path = e_bound if picked == "entry" else t_bound
            row.update(kernel_ms=entry_ms if picked == "entry" else tile_ms,
                       entry_ms=entry_ms, tile_ms=tile_ms,
                       entry_form_ms=time_ms(torch, form),
                       dispatch_ms=time_ms(torch, dispatch),
                       plain_ms=time_ms(torch, plain, reps=2, warmup=0),
                       bound_ms=on_path[0], bound_by=on_path[1],
                       entry_bound_ms=e_bound[0], entry_bound_by=e_bound[1],
                       entry_bytes=form_bytes + rest,
                       tile_bound_ms=t_bound[0], tile_bound_by=t_bound[1],
                       tile_bytes=tile_bytes + rest, entry_products=pairs)
        if whole:
            row.update(
                plan_ms=wall_ms(torch, lambda: spgemm_symbolic(
                    A, B, mask, complement)),
                spgemm_ms=wall_ms(torch, lambda: bsr_mod.spgemm(
                    A, B, sr, mask, complement)))
        emit_phase(**row)
        return row

    def dot_case(A, B, mask, sr, tag, timed=False):
        """The masked dot SpGEMM's kernel (``kernels.bsr_dot``) on the forms
        ``core.bsr.spgemm_dot`` hands it (A's row CSR, the row CSR of B's
        transpose, the mask's entries) against its plain version, bit for
        bit (0/1 modes, integer weights); then the whole ``spgemm_dot``
        against the kernel's values. Timed: the kernel, the plain version,
        the whole route by the host clock, and the card's bound: the
        operands' row CSRs, the mask's entries and the output read or
        written once, and one lookup (an int32 operation) per walked
        element (the work: the shorter list's length, summed over the
        mask's entries)."""
        Ac = bsr_mod.nonzero_csr(A.row_csr())
        Bc = bsr_mod.transpose_csr(bsr_mod.nonzero_csr(B.row_csr()),
                                   B.shape)
        M = bsr_mod.nonzero_csr(mask.row_csr())
        m_rows = bsr_mod.csr_rows(M)

        def kernel():
            return bsr_dot.masked_dot(Ac, Bc, m_rows, M.cols, sr)

        def plain():
            return bsr_dot.masked_dot_plain(Ac, Bc, m_rows, M.cols, sr)

        got, work = kernel()
        want = plain()
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"bsr_spgemm_dot == plain ({tag}, {sr.name})")
        C = bsr_mod.spgemm_dot(A, B, sr, mask)
        r_, c_, v_ = C.to_coo()
        m = mask.shape[1]
        keep = (got != 0).cpu().numpy()
        key = (m_rows.cpu().numpy() * m + M.cols.cpu().numpy())[keep]
        got_key = r_ * m + c_
        order = np.argsort(got_key)
        check(C.nnz == len(key) and np.array_equal(got_key[order], key)
              and np.array_equal(v_[order], got.cpu().numpy()[keep]),
              f"spgemm_dot holds the kernel's nonzero values ({tag})")
        row = dict(phase="kernel", kernel="bsr_spgemm_dot", shape=tag,
                   card=card, semiring=sr.name, mask_entries=M.entries,
                   a_entries=Ac.entries, b_entries=Bc.entries, work=work,
                   output_nnz=C.nnz, equal=True,
                   max_abs_err=abs_err(got, want))
        del C, want
        if timed:
            n = A.shape[0]
            nbytes = (8 * (n + 1) + 8 * Ac.entries + 8 * (B.shape[1] + 1)
                      + 8 * Bc.entries + 12 * M.entries)
            b_ms, b_by = bound(nbytes, work)
            row.update(kernel_ms=time_ms(torch, kernel),
                       plain_ms=time_ms(torch, plain, reps=2, warmup=0),
                       spgemm_ms=wall_ms(torch, lambda: bsr_mod.spgemm_dot(
                           A, B, sr, mask)),
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        emit_phase(**row)
        return row

    def crossover(rows):
        """The geometric middle between the last fill at which the entry
        kernel beats the tile kernel and the first at which it does not,
        when the two runs split cleanly; else None."""
        wins = [o["fill"] for o in rows if o["entry_ms"] < o["tile_ms"]]
        loses = [o["fill"] for o in rows if o["entry_ms"] >= o["tile_ms"]]
        if wins and loses and max(wins) < min(loses):
            return float(np.sqrt(max(wins) * min(loses)))
        return None

    def sweep_row(row):
        return {key: row[key] for key in (
            "shape", "fill", "picked", "entry_ms", "tile_ms",
            "entry_bound_ms", "tile_bound_ms", "tasks", "entry_form_ms",
            "dispatch_ms", "mode") if key in row}

    def frontier(n, F, seed):
        """(n, F) integer frontier values 0-2, 30% nonzero, on the card."""
        rs = np.random.default_rng(seed)
        x = np.where(rs.random((n, F)) < 0.3, rs.integers(1, 3, (n, F)), 0)
        return torch.from_numpy(x.astype(np.float32)).to(DEVICE)

    def variant_rows(A, A2, X, tag):
        """The sweeps' mxm and ewise rows of one operand: A x X over
        plus_times, A .* A2 over times and A >= 2 (A2 holds A's tiles)."""
        return (sweep_row(bsr_mxm_case(A, X, S.PLUS_TIMES, tag,
                                       sweep=True)),
                [sweep_row(ewise_case("intersect", A, A2, S.ewise("times"),
                                      tag, sweep=True)),
                 sweep_row(ewise_case("select", A, None, S.ewise("ge", 2.0),
                                      tag, sweep=True))])

    def emit_sweeps(phase, rows, tables, **kw):
        """One line per kernel: its rows, the crossover (ewise: of each
        mode) and the dispatch's current limit."""
        for kernel, out in rows.items():
            if kernel == "bsr_ewise":
                cross = {m: crossover([o for o in out if o["mode"] == m])
                         for m in ("intersect", "select")}
            else:
                cross = crossover(out)
            emit_phase(phase=phase, card=card, kernel=kernel, rows=out,
                       crossover_fill=cross, entry_max_fill=tables[kernel],
                       **kw)

    def fill_sweep():
        """Both variants of ``bsr_spgemm`` (A x A, plus_times), ``bsr_mxm``
        (A x X, plus_times, F = 512) and ``bsr_ewise`` (A .* A2, A >= 2) on
        integer weights, so every result agrees bit for bit, at each tile
        side b in {16, 32, 64, 128} over fills from 0.2% to 100%: an
        8192 x 8192 matrix of 8192 / b block-rows of 8 tiles, entries
        placed uniformly in each tile (A2: the same tiles, other places).
        The crossover (where the entry kernel stops beating the tile
        kernel) at each b is what each crossover table holds."""
        n, per_row = SWEEP_N, 8
        before = variant_launches()
        X = frontier(n, SWEEP_F, n)
        for b in (16, 32, 64, 128):
            nbr = n // b
            rs = np.random.default_rng(b)
            br = np.repeat(np.arange(nbr), per_row)
            bc = np.concatenate([rs.choice(nbr, per_row, replace=False)
                                 for _ in range(nbr)])
            order = np.argsort(rs.random((len(br), b * b)), axis=1)
            order2 = np.argsort(rs.random((len(br), b * b)), axis=1)
            rows = {"bsr_spgemm": [], "bsr_mxm": [], "bsr_ewise": []}
            for fill in SWEEP_FILLS:
                k = max(1, int(round(fill * b * b)))
                ops_ = []
                for o in (order, order2):
                    pos = o[:, :k]
                    r = (br[:, None] * b + pos // b).ravel()
                    c = (bc[:, None] * b + pos % b).ravel()
                    v = rs.integers(1, 4, size=r.size).astype(np.float64)
                    ops_.append(BSR.from_coo(r, c, v, (n, n), block=b,
                                             device=DEVICE))
                A, A2 = ops_
                tag = f"fill sweep {fill:g}, {len(br)} {b}-tiles"
                rows["bsr_spgemm"].append(sweep_row(spgemm_case(
                    A, A, S.PLUS_TIMES, tag, timed=True)))
                mx, ew = variant_rows(A, A2, X, tag)
                rows["bsr_mxm"].append(mx)
                rows["bsr_ewise"] += ew
                del A, A2, ops_
            emit_sweeps("fill_sweep", rows, {
                "bsr_spgemm": bsr_spgemm.entry_max_fill(b),
                "bsr_mxm": bsr_mxm.entry_max_fill(b),
                "bsr_ewise": bsr_ewise.entry_max_fill(b)}, block=b,
                tiles=len(br))
        after = variant_launches()
        swept = {k: after[k] - before[k] for k in after}
        for k, v in swept.items():
            check(v > 0, f"fill sweep: {k} launched")
        return swept

    def clustered_sweep():
        """Both variants of each BSR kernel on a clustered relation that
        ``fmt="auto"`` stores as BSR: a planted-partition graph (a
        stochastic block model) of 256 communities of 128 consecutive ids,
        each vertex with ``d_in`` edges into its own community and 2 into
        a neighbouring one, undirected, integer weights 1-3. Its diagonal
        tiles are far fuller than the rest, so the dispatch's mean fill is
        tried on uneven tiles. SpGEMM: A x A over plus_times (a weighted
        2-hop) and the triangle support C<A> = A x A over plus_pair;
        ``bsr_mxm``: A x X, F = 512; ``bsr_ewise``: A .* A, A >= 2."""
        blocks, size, d_out = CLUSTER_COMMUNITIES, 128, 2
        n = blocks * size
        X = frontier(n, SWEEP_F, n)
        rows = {"bsr_spgemm": [], "bsr_mxm": [], "bsr_ewise": []}
        for d_in in CLUSTER_D_IN:
            rs = np.random.default_rng(d_in)
            u = np.repeat(np.arange(n), d_in + d_out)
            hop = np.tile(np.r_[np.zeros(d_in, np.int64),
                                np.ones(d_out, np.int64)], n)
            comm = (u // size + hop * rs.choice([-1, 1], size=u.size)) \
                % blocks
            v = comm * size + rs.integers(0, size, size=u.size)
            keep = u != v
            key = np.unique(np.r_[u[keep] * n + v[keep],
                                  v[keep] * n + u[keep]])
            src, dst = key // n, key % n
            w = (np.minimum(src, dst) * 7 + np.maximum(src, dst)) % 3 + 1
            g = GraphBuilder(n).add_edges("KNOWS", src, dst, w).build(
                fmt="auto", device=DEVICE)
            A = g.relations["KNOWS"].A.store
            check(g.relations["KNOWS"].A.fmt == "bsr",
                  f"clustered d_in={d_in}: fmt='auto' stores BSR")
            tag = f"planted partition d_in={d_in}"
            rows["bsr_spgemm"].append(sweep_row(spgemm_case(
                A, A, S.PLUS_TIMES, tag + ", A x A", timed=True)))
            rows["bsr_spgemm"].append(sweep_row(spgemm_case(
                A, A, S.PLUS_PAIR, tag + ", support C<A> = A x A", mask=A,
                timed=True)))
            mx, ew = variant_rows(A, A, X, tag)
            rows["bsr_mxm"].append(mx)
            rows["bsr_ewise"] += ew
            del g, A
        sp = rows.pop("bsr_spgemm")
        emit_phase(phase="clustered_sweep", card=card, kernel="bsr_spgemm",
                   block=size, communities=blocks, rows=sp,
                   crossover_fill={
                       "A x A": crossover(sp[0::2]),
                       "support": crossover(sp[1::2])},
                   entry_max_fill=bsr_spgemm.entry_max_fill(size))
        emit_sweeps("clustered_sweep", rows, {
            "bsr_mxm": bsr_mxm.entry_max_fill(size),
            "bsr_ewise": bsr_ewise.entry_max_fill(size)}, block=size,
            communities=blocks)

    def fresh_handle(X):
        """The same handle without its cached forms."""
        return BSR(X.shape, X.block, X.blocks, X.block_rows, X.block_cols,
                   X.first, X.last, X.valid, X.row_ptr, X.nnz, X.emask)

    def ewise_case(mode, A, B, op, tag, timed=False, sweep=False):
        """Kernel 5 on one plan of ``core.bsr``: the entry kernel's slots
        against its plain version's, the tile kernel's tiles against its
        plain version's, and the two routes' handles (tile lists, nnz, the
        entry route's lazily built tiles) against each other, bit for bit;
        the dispatch's pick. Timed: each kernel alone (selectors on the
        card, outputs allocated: ``bsr_ewise.launch`` of a prepared call),
        both plain versions, each bound, the payload form's build, and by
        the host clock the whole op as the path calls it (host plan,
        selector upload, slot sizing, kernel, output scan and prune) and
        its steps. ``sweep``: the two kernels and their handles only."""
        sel_a, sel_b, rows, cols, Bs = bsr_mod.ewise_plan(mode, A, B)
        FA = A.payload_form()
        FB = None if Bs is None else Bs.payload_form()
        Bb = None if Bs is None else Bs.blocks

        def entry():
            return bsr_ewise.map_entries(FA, sel_a, FB, sel_b, mode, op)

        def tile():
            return bsr_ewise.map_tiles(A.blocks, sel_a, Bb, sel_b, mode, op)

        def plain_entry():
            return bsr_ewise.map_entries_plain(FA, sel_a, FB, sel_b, mode,
                                               op)

        def plain_tile():
            return bsr_ewise.map_tiles_plain(A.blocks, sel_a, Bb, sel_b,
                                             mode, op)

        picked = bsr_ewise.pick(A, Bs)
        got_e, got_t = entry(), tile()
        torch.cuda.synchronize()
        if not sweep:
            want_e, want_t = plain_entry(), plain_tile()
            kept = got_e[3].view(torch.int32) != 0
            check(torch.equal(got_e[0], want_e[0]) and torch.equal(
                got_e[3].view(torch.int32), want_e[3].view(torch.int32))
                and all(torch.equal(g[kept], w[kept])
                        for g, w in zip(got_e[1:3], want_e[1:3])),
                f"bsr_ewise entry == plain ({tag}, {mode})")
            check(torch.equal(got_t, want_t),
                  f"bsr_ewise tile == plain ({tag}, {mode})")
            del want_e, want_t
        G = BSR.from_entry_slots(rows, cols, *got_e, A.shape, A.block)
        W = BSR.from_blocks_device(rows, cols, got_t, A.shape, A.block)
        check(G.nnz == W.nnz and all(
            torch.equal(getattr(G, f), getattr(W, f)) for f in (
                "block_rows", "block_cols", "first", "last", "valid",
                "row_ptr")) and torch.equal(
                    G.blocks.view(torch.int32), W.blocks.view(torch.int32)),
            f"bsr_ewise entry route == tile route: tiles, tile list, nnz "
            f"({tag}, {mode})")
        b, T = A.block, len(sel_a)
        slots = int(got_e[0][-1])
        row = dict(phase="kernel", kernel="bsr_ewise", shape=tag, card=card,
                   mode=mode, op=None if op is None else str(op),
                   block=b, n=A.shape[0], m=A.shape[1], tiles=T,
                   fill=bsr_mod.stored_fill(*([A] if Bs is None or Bs is A
                                               else [A, Bs])),
                   picked=picked,
                   absent_a=int((sel_a < 0).sum()),
                   absent_b=None if sel_b is None else int((sel_b < 0).sum()),
                   entries_a=FA.entries,
                   entries_b=None if FB is None else FB.entries, slots=slots,
                   tiles_out=int(W.valid.sum()), nnz_out=W.nnz, equal=True,
                   entry_equals_tile=True, max_abs_err=0.0)
        del got_e, got_t, G, W
        if timed or sweep:
            # what each kernel must move: the selectors and, for the entry
            # kernel, each present operand tile's entries (row, column,
            # value: 6 bytes) with its two 8-byte bounds, the slot pointer
            # and every slot written once (6 bytes); for the tile kernel
            # each present operand tile and each output tile (4 bytes an
            # element). One fp32 operation per slot, or per output element.
            sels = [sel_a] + ([] if sel_b is None else [sel_b])
            forms = [FA] + ([] if FB is None else [FB])
            present = [int((x >= 0).sum()) for x in sels]
            ent = sum(int(f.base.diff().cpu().numpy()[x[x >= 0]].sum())
                      for f, x in zip(forms, sels))
            e_bytes = (6 * ent + 16 * sum(present) + 4 * T * len(sels)
                       + 8 * (T + 1) + 6 * slots)
            t_bytes = ((sum(present) + T) * b * b * 4 + 4 * T * len(sels))
            e_bound = bound(e_bytes, slots, FP32_FLOPS_PER_S)
            t_bound = bound(t_bytes, T * b * b, FP32_FLOPS_PER_S)
            ecall = bsr_ewise.entry_call(FA, sel_a, FB, sel_b, mode, op)
            tcall = bsr_ewise.tile_call(A.blocks, sel_a, Bb, sel_b, mode, op)
            row.update(entry_ms=time_ms(torch,
                                        lambda: bsr_ewise.launch(ecall)),
                       tile_ms=time_ms(torch,
                                       lambda: bsr_ewise.launch(tcall)),
                       entry_bound_ms=e_bound[0], entry_bound_by=e_bound[1],
                       entry_bytes=e_bytes, tile_bound_ms=t_bound[0],
                       tile_bound_by=t_bound[1], tile_bytes=t_bytes)
            del ecall, tcall
        if timed:
            fresh = A.blocks
            slots_ = entry()
            row.update(
                plan_ms=wall_ms(torch, lambda: bsr_mod.ewise_plan(mode, A,
                                                                  B)),
                entry_wrapper_ms=wall_ms(torch, entry),
                tile_wrapper_ms=wall_ms(torch, tile),
                assemble_ms=wall_ms(torch, lambda: BSR.from_entry_slots(
                    rows, cols, *slots_, A.shape, A.block)),
                plain_ms=time_ms(torch, plain_entry, reps=3, warmup=1),
                plain_tile_ms=time_ms(torch, plain_tile, reps=3, warmup=1),
                payload_form_ms=time_ms(torch, lambda: bsr_mod.entry_form(
                    fresh, signed_zeros=True)),
                whole_op_ms=wall_ms(torch, lambda: bsr_mod._ewise(
                    mode, A, B, op), reps=5),
                # as the path meets a fresh operand: its payload form built
                whole_op_fresh_ms=wall_ms(torch, lambda: bsr_mod._ewise(
                    mode, fresh_handle(A), None if B is None
                    else fresh_handle(B), op), reps=3),
                library_ms=None)
            saved = bsr_ewise.entry_max_fill
            bsr_ewise.entry_max_fill = lambda b_: 0.0   # the tile route
            try:
                row["whole_op_tile_ms"] = wall_ms(
                    torch, lambda: bsr_mod._ewise(mode, A, B, op), reps=5)
            finally:
                bsr_ewise.entry_max_fill = saved
            on_path = "entry" if picked == "entry" else "tile"
            row.update(kernel_ms=row[f"{on_path}_ms"],
                       bound_ms=row[f"{on_path}_bound_ms"],
                       bound_by=row[f"{on_path}_bound_by"])
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
    sweep = fill_sweep()
    clustered_sweep()
    path = {k: 0 for k in variant_launches()}
    # bsr_ewise: b in {32, 64, 128}, n % b != 0, block-rows absent on either
    # side, then an empty operand and a side absent everywhere
    modes = [("union", S.ewise("min")), ("intersect", S.ewise("times")),
             ("apply", S.ewise("mul", 0.5)), ("select", S.ewise("ge", 1.0)),
             ("mask", None), ("mask_c", None)]
    for b_, n_, m_ in ((32, 200, 150), (64, 300, 260), (128, 520, 400)):
        ops_ = []
        for skip in (range(b_, 2 * b_), range(2 * b_, 3 * b_)):
            rr = rng.integers(0, n_, size=4 * n_)
            cc = rng.integers(0, m_, size=4 * n_)
            keep_ = ~np.isin(rr, list(skip))
            vv = rng.choice([-2, -1, -0.5, 0.5, 1, 2], size=int(keep_.sum()))
            ops_.append(BSR.from_coo(rr[keep_], cc[keep_], vv, (n_, m_),
                                     block=b_, device=DEVICE))
        for mode, op in modes:
            ewise_case(mode, ops_[0], ops_[1], op,
                       f"ragged {n_}x{m_} b={b_}")
    empty = BSR.from_coo([], [], None, (n_, m_), block=b_, device=DEVICE)
    for mode, op in modes:
        ewise_case(mode, ops_[0], empty, op, f"ragged {n_}x{m_} b={b_}, "
                   "B empty")
        if mode not in bsr_ewise.UNARY_MODES:
            ewise_case(mode, empty, ops_[0], op, f"ragged {n_}x{m_} "
                       f"b={b_}, A empty")
    del ops_, empty

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
        zero_launches()
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
        launches = {**launches_now(), **variant_launches()}
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
                   variants={k: v for k, v in launches.items()
                             if k.endswith(("_entry", "_tile"))},
                   picked={"bsr_mxm": bsr_mxm.picked,
                           "bsr_spgemm": bsr_spgemm.picked},
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

    def any_pair_case(g, tag, kernel):
        """``grb.mxm(A, X, ANY_PAIR)`` on a served graph's handle at F =
        512 (a 1% frontier), with the launch counts at 0 just before and
        read just after: one launch of or_and's kernel, and or_and's bits.
        On ELL also under ``packed_frontiers("off")``: no word kernel,
        the same bits."""
        A = g.relations["KNOWS"].A
        rs = np.random.default_rng(21)
        X = torch.from_numpy((rs.random((g.n, MAX_WIDTH)) < 0.01)
                             .astype(np.float32)).to(DEVICE)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = grb.mxm(A, X, S.ANY_PAIR)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = {**launches_now(), **variant_launches()}
        check(launched[kernel] == 1 and sum(launches_now().values()) == 1,
              f"any_pair {tag}: launches {launched}, not one of {kernel}")
        check(torch.equal(got, grb.mxm(A, X, S.OR_AND)),
              f"any_pair {tag}: differs from or_and")
        row = dict(phase="any_pair", card=card, tag=tag, fmt=A.fmt, n=g.n,
                   F=MAX_WIDTH, seconds=dt, launches={kernel: 1},
                   variants={k_: v for k_, v in launched.items()
                             if k_.startswith(kernel + "_") and v},
                   equal_or_and=True)
        if A.fmt == "ell":
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with grb.packed_frontiers("off"):
                off = grb.mxm(A, X, S.ANY_PAIR)
            torch.cuda.synchronize()
            row["off_seconds"] = time.perf_counter() - t0
            row["off_launches"] = sum(launches_now().values())
            check(row["off_launches"] == 0 and torch.equal(off, got),
                  f"any_pair {tag} packing off: {row['off_launches']} "
                  f"launches, equal {torch.equal(off, got)}")
            row["off_equal"] = True
            del off
        emit_phase(**row)
        del X, got
        return launched[kernel]

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
    any_pair = {"ell_mxv_packed": any_pair_case(g, "s16 ELL",
                                                "ell_mxv_packed")}
    del g, A
    release()

    # -- BitELL: Graph500 scale 18 -------------------------------------------
    bitadj_built, bitadj_copies = {}, []

    def bitadj_graph(scale):
        """(a fresh R-MAT BitELL graph on the card, its host build s): the
        host build (``np.unique`` over the edge keys, most of it) once a
        scale, its arrays copied to the card anew for each phase that
        serves it, so that no phase reads another's cached forms and none
        holds the card's memory through the phases between."""
        if scale not in bitadj_built:
            t0 = time.perf_counter()
            gh = rmat_graph(scale, fmt="bitadj", device="cpu")

            def arrays(M):
                return tuple({"tiles": s.tiles.numpy(), "cols": s.cols.numpy()}
                             for s in (M.store, M.T.store))

            bitadj_built[scale] = (
                gh.n, {k: arrays(r.A) for k, r in gh.relations.items()},
                arrays(gh.adj.A), time.perf_counter() - t0)
        n, rels, adj, host_s = bitadj_built[scale]
        t0 = time.perf_counter()
        gd = from_arrays(n, rels, adj=adj, device=DEVICE)
        torch.cuda.synchronize()
        bitadj_copies.append(time.perf_counter() - t0)
        return gd, host_s

    t0 = time.perf_counter()
    g, host_build_s = bitadj_graph(18)
    build_s = time.perf_counter() - t0
    A = g.relations["KNOWS"].A
    check(A.fmt == "bitadj", f"fmt='bitadj' gave {A.fmt}")
    emit_phase(phase="graph_bitadj", card=card, scale=18, n=g.n, nnz=A.nvals,
               P=A.store.n_panels, S=A.store.n_slots, S_T=A.T.store.n_slots,
               build_s=build_s, host_build_s=host_build_s,
               memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    bitadj_case(A.store, 16, "scale-18 forward handle W=16", timed=True)
    kern["bitadj_mxv_packed"] = bitadj_case(
        A.T.store, 16, "scale-18 transpose handle W=16 (the path's)",
        timed=True)
    out_deg = grb.reduce(A, S.PLUS, axis=1).cpu().numpy()
    seeds = np.random.default_rng(18).choice(
        np.nonzero(out_deg >= 1)[0], QUERIES, replace=False)
    t23 = "MATCH (a)-[:KNOWS*2..3]->(b) RETURN count(DISTINCT b)"
    texts = [(t12 if i % 2 == 0 else t23, int(s))
             for i, s in enumerate(seeds)]
    kern["bitadj_mxv_packed"]["launches"] = serve(
        g, texts, {"bitadj_mxv_packed": "hops"}, "bitadj",
        bfs_want(g))["bitadj_mxv_packed"]
    breakdown(g, t12, seeds[::2], "bitadj")
    any_pair["bitadj_mxv_packed"] = any_pair_case(g, "s18 BitELL",
                                                  "bitadj_mxv_packed")
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
    for r_ in rows3:
        check(r_["picked"] == "entry", f"bsr_mxm at scale 16 picked "
              f"{r_['picked']}, not the entry kernel")
    mxm_row = dict(rows3[0], max_abs_err=max(
        r_["max_abs_err"] for r_ in rows3), plus_times=rows3[1])
    emit_phase(phase="library", kernel="bsr_mxm", card=card,
               call="torch.sparse.mm of the handle's CSR and the dense "
               "frontier, F=512 (cuSPARSE SpMM)",
               library_ms=mxm_row["library_ms"],
               reason=mxm_row["library_reason"])
    mxm_row["bsr_library_ms"], why = library_bsr_mm(torch, AT, X1)
    emit_phase(phase="library", kernel="bsr_mxm", card=card,
               call="torch.sparse_bsr_tensor @ dense frontier, F=512 "
               "(PyTorch's BSR kernel: the tile kernel's whole-tile work)",
               library_ms=mxm_row["bsr_library_ms"], reason=why)
    del B0, X1, visited
    src, dst, n = rmat_edges(16)
    texts = [(t12 if i % 2 == 0 else w12, int(s))
             for i, s in enumerate(seeds)]
    bfs = bfs_want(g)
    walks = walk_counts(src, dst, n)
    want = (lambda t, s: bfs(t, s) if "DISTINCT" in t else int(walks[s]))
    launched = serve(g, texts, {"bsr_mxm": "hops"}, "bsr", want)
    check(launched["bsr_mxm_entry"] == launched["bsr_mxm"],
          f"bsr s16: bsr_mxm took {launched['bsr_mxm_tile']} tile "
          f"launches; the entry kernel is the path's")
    for k in path:
        path[k] += launched[k]
    breakdown(g, t12, seeds[::2], "bsr")
    any_pair["bsr_mxm_entry"] = any_pair_case(g, "s16 BSR", "bsr_mxm")
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
        timed=True, whole=True)
    kern["bsr_spgemm"]["library_ms"], why = library_spgemm(torch, AT)
    emit_phase(phase="library", kernel="bsr_spgemm", card=card,
               call="torch.sparse.mm of two CSR tensors (cuSPARSE SpGEMM)",
               library_ms=kern["bsr_spgemm"]["library_ms"], reason=why)
    out_deg = bsr_out_degree(torch, A.store)
    seeds = np.random.default_rng(14).choice(
        np.nonzero(out_deg >= 1)[0], QUERIES, replace=False)
    B0 = ctx.seed_frontier(seeds[:MAX_WIDTH])
    hop_row = bsr_mxm_case(P.store, B0, S.OR_AND, "scale-14 hop matrix "
                           "F=512 (the path's)", mask=(B0 > 0).to(
                               torch.float32), complement=True, timed=True)
    emit_phase(phase="library", kernel="bsr_mxm", card=card,
               shape=hop_row["shape"],
               call="torch.sparse.mm of the hop matrix's CSR and the seed "
               "frontier, F=512 (cuSPARSE SpMM)",
               library_ms=hop_row["library_ms"],
               reason=hop_row["library_reason"])
    del B0
    breakdown(g, t12, seeds, "bsr_hop", ctx)       # its hop matrix is built
    del P, ctx
    launched = serve(g, [(t12, int(s)) for s in seeds],
                     {"bsr_spgemm": "once", "bsr_mxm": "batches"}, "bsr_hop",
                     bfs_want(g), prime=True)
    check(launched["bsr_spgemm_entry"] == 1
          and launched["bsr_spgemm_tile"] == 0,
          f"bsr_hop: the hop matrix took {launched['bsr_spgemm_entry']} "
          f"entry and {launched['bsr_spgemm_tile']} tile launches, not one "
          f"entry")
    hop_variant = "entry" if hop_row["picked"] == "entry" else "tile"
    check(launched["bsr_mxm_" + hop_variant] == launched["bsr_mxm"],
          "bsr_hop: bsr_mxm took the variant the hop matrix's fill picks")
    for k in path:
        path[k] += launched[k]
    del g, A, AT
    release()

    # -- analytics: Graph500 scale 15, undirected, BSR --------------------------
    src, dst, n = rmat_edges(ANALYTICS_SCALE)
    loop = src == dst
    s_all = np.concatenate([src[~loop], dst[~loop]])
    d_all = np.concatenate([dst[~loop], src[~loop]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = GraphBuilder(n).add_edges("KNOWS", s_all, d_all).build(
        fmt="bsr", block=128, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rel = g.relations["KNOWS"]
    A = rel.A
    t0 = time.perf_counter()
    Asp = undirected_csr(s_all, d_all, n)
    sup = masked_support(Asp)
    tri_want = int(round(sup.sum())) // 6
    truss_want, rounds_want = peel(Asp, 4)
    oracle_s = time.perf_counter() - t0
    check(A.fmt == "bsr" and A.nvals == Asp.nnz, "analytics graph: every "
          "undirected edge stored once")
    emit_phase(phase="graph_analytics", card=card, scale=ANALYTICS_SCALE, n=n,
               nnz=A.nvals, block=A.store.block,
               tiles=int(A.store.valid.sum()),
               gb_per_handle=A.store.nnzb * A.store.block ** 2 * 4 / 1e9,
               handles=4, build_s=build_s, oracle_s=oracle_s,
               memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    # kernel 4 at the triangle path's shape, the tile route that the dot
    # route replaces there: the support C<A> = A (x) A over plus_pair
    tri_row = spgemm_case(A.store, A.store, S.PLUS_PAIR,
                          f"scale-{ANALYTICS_SCALE} support C<A> = A x A "
                          f"(the tile route's)", mask=A.store, timed=True,
                          whole=True)
    tri_row["library_ms"], why = library_spgemm(torch, A.store, masked=True)
    emit_phase(phase="library", kernel="bsr_spgemm", card=card,
               shape=tri_row["shape"],
               call="torch.sparse.mm of two CSR tensors, then * A as COO "
               "(cuSPARSE SpGEMM, then the mask)",
               library_ms=tri_row["library_ms"], reason=why)
    # the masked dot SpGEMM at the same shape, the path's: plus_pair on A,
    # and plus_times on integer weights 1-4 over A's pattern (exact sums)
    rr, cc, _ = A.store.to_coo()
    W = BSR.from_coo(rr, cc, (1 + (rr * 7 + cc * 3) % 4).astype(np.float32),
                     A.shape, block=A.store.block, device=DEVICE)
    dot_row = dot_case(A.store, A.store, A.store, S.PLUS_PAIR,
                       f"scale-{ANALYTICS_SCALE} support C<A> = A x A "
                       f"(the triangle path's)", timed=True)
    dot_case(W, W, A.store, S.PLUS_TIMES, f"scale-{ANALYTICS_SCALE} "
             f"C<A> = W x W, weights 1-4 on A's pattern")
    dot_row["library_ms"] = tri_row["library_ms"]
    del rr, cc, W
    dot_path = [0]          # the dot kernel's launches on the analytics path

    def read_launches(phase_needs):
        """Launches since the last zero, checked against what the phase
        needs (kernel -> least count), added to the path's totals by
        variant; every BSR kernel of the analytics takes its entry kernel
        (Graph500 tiles)."""
        got = launches_now()
        for k, need in phase_needs.items():
            check(got[k] >= need and got[k] > 0,
                  f"analytics: {k} launched {got[k]} times, needs {need}")
        var = variant_launches()
        for mod in variants:
            k = mod.__name__.rsplit(".", 1)[-1]
            check(var[f"{k}_tile"] == 0 and var[f"{k}_entry"] == got[k],
                  f"analytics: {k} took {var[k + '_tile']} tile launches; "
                  f"the entry kernel is the path's")
        for k in path:
            path[k] += var[k]
        dot_path[0] += got["bsr_dot"]
        return {k: got[k] for k in phase_needs}

    # triangles
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tri = int(algo.triangle_count(rel))
    tri_s = time.perf_counter() - t0
    launched = read_launches({"bsr_dot": 1})
    check(tri == tri_want, f"triangles: {tri}, scipy {tri_want}")
    check(launched["bsr_dot"] == 1, "triangles: one bsr_spgemm_dot launch")
    emit_phase(phase="triangles", card=card, count=tri, scipy=tri_want,
               ms=1e3 * tri_s, plus_sum=6 * tri, past_2_24=6 * tri > 2 ** 24,
               launches=launched)

    # k-truss, k = 4, each round's steps timed by wrappers around the
    # masked dot SpGEMM, its kernel, the select's kernel and the select
    # (synchronised); each hook keeps its step's seconds and a count read
    # off its result (the support's entries, the kernel's work, the
    # select's surviving entries), not the result
    steps = {"spgemm_dot": [], "masked_dot": [], "map_entries": [],
             "select_stored": []}
    # the select's kernel is the entry kernel at Graph500 fill
    # (read_launches checks it)
    hooks = [(bsr_mod, "spgemm_dot", lambda C_: C_.nnz),
             (bsr_dot, "masked_dot", lambda out_: out_[1]),
             (bsr_ewise, "map_entries", lambda _: None),
             (bsr_mod, "select_stored", lambda sel: sel.nnz)]
    saved = [getattr(mod, name) for mod, name, _ in hooks]

    def hook(name, fn, count):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            steps[name].append((time.perf_counter() - t, count(out)))
            return out
        return timed

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for (mod, name, count), fn in zip(hooks, saved):
            setattr(mod, name, hook(name, fn, count))
        T = algo.ktruss(rel, 4)
        torch.cuda.synchronize()
    finally:
        for (mod, name, _), fn in zip(hooks, saved):
            setattr(mod, name, fn)
    truss_s = time.perf_counter() - t0
    nrounds = len(steps["spgemm_dot"])
    launched = read_launches({"bsr_dot": nrounds, "bsr_ewise": nrounds})
    check(launched["bsr_dot"] == nrounds,
          f"ktruss: {launched['bsr_dot']} dot SpGEMMs for {nrounds} rounds")
    per_round = [dict(support=sup_, work=work, spgemm_ms=1e3 * ts,
                      kernel_ms=1e3 * tk, select_ms=1e3 * te, surviving=kept)
                 for (ts, sup_), (tk, work), (te, _), (_, kept) in zip(
                     *(steps[k] for k in ("spgemm_dot", "masked_dot",
                                          "map_entries", "select_stored")))]
    del steps
    r_, c_, v_ = T.store.to_coo()
    got_key = r_ * n + c_
    order = np.argsort(got_key)
    want = truss_want.tocoo()
    want_key = want.row.astype(np.int64) * n + want.col
    worder = np.argsort(want_key)
    check(nrounds == rounds_want, f"ktruss: {nrounds} rounds, scipy "
          f"{rounds_want}")
    check(np.array_equal(got_key[order], want_key[worder]),
          "ktruss: the 4-truss edge set equals scipy's peeling")
    check(np.array_equal(v_[order], want.data[worder]),
          "ktruss: every support equals scipy's")
    emit_phase(phase="ktruss", card=card, k=4, rounds=nrounds,
               per_round=per_round, surviving=T.nvals,
               tiles=int(T.store.valid.sum()), seconds=truss_s,
               launches=launched)

    # similarity: the sparse matrix on A's pattern, then 64 sources
    deg_np = np.asarray(Asp.sum(axis=1)).ravel()
    sources = np.random.default_rng(15).choice(np.nonzero(deg_np >= 1)[0],
                                               SIM_SOURCES, replace=False)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    J = algo.similarity_matrix(rel, "jaccard")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    Ssrc = algo.similarity(rel, sources, "jaccard")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launched = read_launches({"bsr_mxm": 1, "bsr_dot": 1, "bsr_ewise": 1})
    r_, c_, v_ = J.store.to_coo()
    sc = sup.tocoo()
    key, skey = r_ * n + c_, sc.row.astype(np.int64) * n + sc.col
    order, sorder = np.argsort(key), np.argsort(skey)
    check(np.array_equal(key[order], skey[sorder]),
          "similarity_matrix: stored pattern == the edges with a common "
          "neighbour")
    cnt = sc.data[sorder]
    want_v = cnt / (deg_np[sc.row[sorder]] + deg_np[sc.col[sorder]] - cnt)
    err_mat = rel_err(v_[order], want_v)
    check(err_mat <= 1e-6, f"similarity_matrix: relative error {err_mat}")
    M = (Asp @ Asp[:, sources]).toarray()
    den = deg_np[:, None] + deg_np[sources][None, :] - M
    want_s = np.where(M > 0, M / np.where(M > 0, den, 1.0), 0.0)
    got_s = Ssrc.cpu().numpy()
    err_src = rel_err(got_s, want_s)
    check(got_s.shape == (n, SIM_SOURCES) and err_src <= 1e-6,
          f"similarity: shape {got_s.shape}, relative error {err_src}")
    col = {int(s_): j for j, s_ in enumerate(sources)}
    on = np.isin(c_, sources)
    mat_vs_src = rel_err(got_s[r_[on], [col[int(x)] for x in c_[on]]],
                         v_[on])
    check(mat_vs_src <= 1e-6, f"similarity vs similarity_matrix on the "
          f"stored pattern: relative error {mat_vs_src}")
    emit_phase(phase="similarity", card=card, kind="jaccard", nnz=J.nvals,
               matrix_ms=1e3 * (t1 - t0), sources=SIM_SOURCES,
               sources_ms=1e3 * (t2 - t1), max_rel_err_matrix=err_mat,
               max_rel_err_sources=err_src,
               max_rel_err_sources_vs_matrix=mat_vs_src,
               compared_on_pattern=int(on.sum()), launches=launched)

    # the same two through CALL algo.*: one triangle row, and a row
    # (source, node, score) for each score above 0 of the source columns
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_t = execute(g, "CALL algo.triangles(rel: KNOWS)")
    t1 = time.perf_counter()
    ids = ", ".join(str(int(s_)) for s_ in sources)
    res_s = execute(g, f"CALL algo.similarity(rel: KNOWS, sources: [{ids}]) "
                       f"YIELD node1, node2, score")
    t2 = time.perf_counter()
    launched = read_launches({"bsr_dot": 1, "bsr_mxm": 1})
    check(res_t.error is None and res_t.rows == [(tri,)],
          f"CALL algo.triangles: {res_t.rows[:1]} {res_t.error}, direct {tri}")
    want_rows = sorted((int(s_), int(i), float(got_s[i, j]))
                       for j, s_ in enumerate(sources)
                       for i in np.nonzero(got_s[:, j] > 0)[0])
    check(res_s.error is None and res_s.rows == want_rows,
          f"CALL algo.similarity: {len(res_s.rows)} rows, the direct call's "
          f"{len(want_rows)}, equal: {res_s.rows == want_rows}")
    emit_phase(phase="call_analytics", card=card, triangles_ms=1e3 * (t1 - t0),
               similarity_ms=1e3 * (t2 - t1), similarity_rows=len(want_rows),
               equal_to_direct=True, launches=launched)
    del J, Ssrc, M, want_s, got_s, res_s, want_rows

    # kernel 5 at the path's shapes: round 1's support (C<A> = A x A, the
    # same product triangle_count and similarity_matrix take), the
    # reciprocal denominators similarity_matrix builds, A, the 4-truss
    C1 = grb.mxm(A, A, S.PLUS_PAIR, grb.Descriptor(mask=A)).store
    deg = degrees(A).cpu().numpy()
    rr, cc, vv = C1.to_coo()
    recip = BSR.from_coo(rr, cc, (1.0 / np.maximum(deg[rr] + deg[cc] - vv,
                                                   1.0)).astype(np.float32),
                         C1.shape, block=C1.block, device=DEVICE)
    tag15 = f"scale-{ANALYTICS_SCALE} support (the path's)"
    sel_row = ewise_case("select", C1, None, S.ewise("ge", 2.0), tag15,
                         timed=True)
    ewise_case("apply", C1, None, S.ewise("mul", 0.5), tag15, timed=True)
    ew_row = ewise_case("intersect", C1, recip, S.ewise("times"),
                        tag15 + " x reciprocals", timed=True)
    for r_ in (sel_row, ew_row):
        check(r_["picked"] == "entry", f"bsr_ewise at the scale-15 support "
              f"picked {r_['picked']}, not the entry kernel")
    union_row = ewise_case("union", C1, A.store, S.ewise("plus"),
                           tag15 + " + A", timed=True)
    for mode in ("mask", "mask_c"):
        ewise_case(mode, C1, T.store, None, tag15 + " against the 4-truss",
                   timed=True)
    for mode, X, Y, call in (
            ("intersect", C1, recip, "A * B of coalesced CUDA COO tensors"),
            ("union", C1, A.store,
             "(A + B).coalesce() of coalesced CUDA COO tensors")):
        ms, why = library_ewise(torch, mode, X, Y)
        (ew_row if mode == "intersect" else union_row)["library_ms"] = ms
        emit_phase(phase="library", kernel="bsr_ewise", card=card, mode=mode,
                   call=call, library_ms=ms, reason=why)
    emit_phase(phase="library", kernel="bsr_ewise", card=card,
               mode="apply, select, mask, mask_c", library_ms=None,
               reason="no single PyTorch call maps or filters the stored "
               "values of a sparse tensor by a predicate or a mask pattern")
    del g, rel, A, T, C1, recip, Asp, sup, truss_want
    release()

    # -- the remaining algorithms and CALL algo.* -----------------------------
    h = types.SimpleNamespace(
        card=card, emit_phase=emit_phase, zero_launches=zero_launches,
        launches_now=launches_now, variant_launches=variant_launches,
        path=path, bsr_mxm_case=bsr_mxm_case, ell_case=ell_case,
        bitadj_case=bitadj_case, frontier=frontier, release=release,
        bitadj_graph=bitadj_graph)
    algo_shapes, algo_words, word_shapes = algorithm_cells(torch, h)
    for k, v in algo_words.items():
        kern[k]["launches"] += v

    # -- the write path: Database, delta storage, AOF, dense handles ---------
    write_words, write_shapes = write_path_cells(torch, h)
    for k, v in write_words.items():
        kern[k]["launches"] += v

    # -- the mesh: sharded storage, the lowerings, mesh= serving -------------
    h.bfs_want = bfs_want
    mesh_words, mesh_shapes = mesh_cells(torch, h)
    for k, v in mesh_words.items():
        kern[k]["launches"] += v
    emit_phase(phase="bitadj_shared", card=card,
               host_build_s={k: v[3] for k, v in bitadj_built.items()},
               copies_s=bitadj_copies)
    bitadj_built.clear()            # the last phase that serves the s18 BitELL

    # -- the paper's workload: graph500_s21 probes and the graph dry-run -----
    probe_words, probe_shapes = probe_cells(torch, h)

    # -- the models' serving path: no TPU kernel lies on it ------------------
    model_cells(torch, h)

    # -- the models' training path: no TPU kernel lies on it either ----------
    train_cells(torch, h)

    # -- the kernels line, the card, the result --------------------------------
    csrc = "src/repro_torch/kernels/csrc/"
    rows_by = {
        # name: (row, variant, source, the TPU kernel it replaces)
        "ell_mxv_packed": (kern["ell_mxv_packed"], None, "ell_mxv_packed.cu",
                           "src/repro/kernels/bitmap_mxv.py:63"),
        "bitadj_mxv_packed": (kern["bitadj_mxv_packed"], None,
                              "bitadj_mxv_packed.cu",
                              "src/repro/kernels/bitadj_mxv.py:69"),
        "bsr_mxm_entry": (mxm_row, "entry", "bsr_mxm_entry.cu",
                          "src/repro/kernels/bsr_mxm.py:112"),
        "bsr_mxm_tile": (mxm_row, "tile", "bsr_mxm.cu",
                         "src/repro/kernels/bsr_mxm.py:112"),
        "bsr_spgemm_entry": (kern["bsr_spgemm"], "entry",
                             "bsr_spgemm_entry.cu",
                             "src/repro/kernels/bsr_spgemm.py:161"),
        "bsr_spgemm_tile": (kern["bsr_spgemm"], "tile", "bsr_spgemm.cu",
                            "src/repro/kernels/bsr_spgemm.py:161"),
        "bsr_ewise_entry": (ew_row, "entry", "bsr_ewise_entry.cu",
                            "src/repro/kernels/bsr_ewise.py:140"),
        "bsr_ewise_tile": (ew_row, "tile", "bsr_ewise.cu",
                           "src/repro/kernels/bsr_ewise.py:140"),
        # the masked products' route at Graph500 fill, in place of kernel 4
        "bsr_spgemm_dot": (dot_row, None, "bsr_spgemm_dot.cu",
                           "src/repro/kernels/bsr_spgemm.py:161"),
    }
    dot_row["launches"] = dot_path[0]
    # the yardsticks: cuSPARSE SpMM for the entry kernel of bsr_mxm,
    # PyTorch's BSR product (the same whole-tile work) for its tile kernel
    library = {"bsr_mxm_tile": mxm_row["bsr_library_ms"]}
    line = []
    for name, (row, var, src, replaces) in rows_by.items():
        launched = row["launches"] if var is None else path[name]
        entry = {"name": name, "route": "cuda", "source": csrc + src,
                 "replaces": replaces, "launches": launched,
                 "max_abs_err": row["max_abs_err"]}
        if var is None:
            entry.update(ms=row["kernel_ms"], plain_ms=row["plain_ms"],
                         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                         library_ms=row["library_ms"])
        else:
            entry.update(
                ms=row[f"{var}_ms"],
                plain_ms=row.get("plain_tile_ms", row["plain_ms"])
                if var == "tile" else row["plain_ms"],
                bound_ms=row[f"{var}_bound_ms"],
                bound_by=row[f"{var}_bound_by"],
                library_ms=library.get(name, row["library_ms"]),
                picked_on_path=row["picked"],
                sweep_launches=sweep[name])
        line.append(entry)
    # the other path shapes of each BSR kernel, beside its row
    line[2]["plus_times"] = {k: mxm_row["plus_times"][k] for k in (
        "entry_ms", "tile_ms", "entry_bound_ms", "library_ms")}
    line[2]["hop_matrix"] = {k: hop_row[k] for k in (
        "picked", "fill", "entry_ms", "tile_ms", "entry_bound_ms",
        "tile_bound_ms", "library_ms")}
    # the word kernels at the widths of the WCC closure batches
    for entry in line[:2]:
        entry["algorithm_shapes"] = {
            name: {k: r_[k] for k in (
                "shape", "W", "equal", "max_abs_err", "kernel_ms",
                "bound_ms", "bound_by", "plain_ms", "library_ms")}
            for name, r_ in word_shapes[entry["name"]].items()}
    sp = kern["bsr_spgemm"]
    # the algorithms' shapes of the entry kernel
    entry_keys = ("shape", "semiring", "F", "picked", "equal", "entry_ms",
                  "entry_bound_ms", "entry_bound_by", "plain_ms",
                  "library_ms", "library_reason")
    line[2]["algorithm_shapes"] = {
        name: {k: r_[k] for k in entry_keys}
        for name, r_ in algo_shapes.items()}
    # the write path's shapes: the patches (kernel 1), the 64-tile bases
    # (kernel 3), each bit for bit against its plain version
    line[0]["write_shapes"] = {
        name: {k: r_[k] for k in (
            "shape", "W", "equal", "max_abs_err", "kernel_ms", "bound_ms",
            "bound_by", "plain_ms", "library_ms")}
        for name, r_ in write_shapes["ell_mxv_packed"].items()}
    # the mesh: the word kernels' launches under a mesh and their rows at
    # one position's local shapes, bit for bit against the plain versions
    for entry in line[:2]:
        entry["mesh_launches"] = mesh_words[entry["name"]]
        entry["mesh_shapes"] = mesh_shapes[entry["name"]]
        check(entry["mesh_launches"] > 0,
              f"{entry['name']} never launched under the mesh")
    # the probes: kernel 1's launches and its shard shapes there
    line[0]["probe_launches"] = probe_words
    line[0]["probe_shapes"] = probe_shapes
    check(probe_words > 0, "ell_mxv_packed never launched by the probes")
    # any_pair on the served handles: or_and's kernel on each
    for entry in line:
        if entry["name"] in any_pair:
            entry["any_pair_launches"] = any_pair[entry["name"]]
    line[2]["write_shapes"] = {
        name: {k: r_[k] for k in entry_keys + ("masked", "block")}
        for name, r_ in write_shapes["bsr_mxm"].items()}
    line[4].update(entry_form_ms=sp["entry_form_ms"],
                   dispatch_ms=sp["dispatch_ms"], plan_ms=sp["plan_ms"],
                   spgemm_ms=sp["spgemm_ms"], triangle_shape={
                       "ms": tri_row["entry_ms"],
                       "bound_ms": tri_row["entry_bound_ms"],
                       "plan_ms": tri_row["plan_ms"],
                       "spgemm_ms": tri_row["spgemm_ms"],
                       "library_ms": tri_row["library_ms"]})
    line[5]["triangle_shape_ms"] = tri_row["tile_ms"]
    line[6].update(whole_op_ms=ew_row["whole_op_ms"],
                   payload_form_ms=ew_row["payload_form_ms"],
                   select={k: sel_row[k] for k in (
                       "entry_ms", "tile_ms", "entry_bound_ms",
                       "tile_bound_ms", "whole_op_ms", "plain_ms")})
    for entry in line:
        path_kernel = not entry["name"].endswith("_tile")
        check(entry["launches"] > 0 or not path_kernel,
              f"{entry['name']} never launched on the main path")
        check(entry.get("sweep_launches", 1) > 0,
              f"{entry['name']} never launched in the fill sweeps")
    read_peak()
    emit_phase(phase="memory", card=card,
               max_memory_allocated_gb=peak[0] / 1e9,
               elapsed_s=time.perf_counter() - started)
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def algorithm_cells(torch, h):
    """The remaining algorithms and ``CALL algo.*`` on the card, each
    phase driven once with the launch counts at 0 and held against an
    oracle that does not use the port (scipy / numpy, from the generator's
    edges with repeated edges combined as ``GraphBuilder`` combines them:
    the first one's weight), then the closeness CALL served through
    ``QueryServer``; in between, ``bsr_mxm``'s entry kernel at the
    algorithms' shapes (``h.bsr_mxm_case``), and before each WCC the word
    kernel at the widths of its closure batches (``h.ell_case`` /
    ``h.bitadj_case``). ``h`` carries main's helpers and the path's launch
    totals. Returns ``bsr_mxm``'s rows by shape, the word kernels' launches
    and the word kernels' rows by shape."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from repro_torch import algorithms as algo
    from repro_torch.core import semiring as S
    from repro_torch.engine import QueryServer
    from repro_torch.engine.server import MAX_WIDTH
    from repro_torch.graph.datagen import rmat_edges, rmat_graph
    from repro_torch.graph.graph import GraphBuilder
    from repro_torch.query import execute

    words = {"ell_mxv_packed": 0, "bitadj_mxv_packed": 0}
    shapes = {}
    word_shapes = {k: {} for k in words}
    card = h.card

    def counted(tag, fn, needs):
        """``fn()`` once with the launch counts at 0: (its result, seconds,
        launches). Each kernel of ``needs`` must launch, a BSR kernel only
        its entry variant (Graph500 tiles); the launches join the path's."""
        h.zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got, var = h.launches_now(), h.variant_launches()
        for k in needs:
            check(got[k] > 0, f"{tag}: {k} never launched")
        for k in ("bsr_mxm", "bsr_spgemm", "bsr_ewise"):
            check(var[k + "_tile"] == 0,
                  f"{tag}: {k} took {var[k + '_tile']} tile launches; the "
                  f"entry kernel is the path's")
        for k in h.path:
            h.path[k] += var[k]
        for k in words:
            words[k] += got[k]
        return out, dt, {k: v for k, v in got.items() if v}

    def on_card(t, tag):
        check(t.device.type == torch.device(DEVICE).type,
              f"{tag}: answer on {t.device}, not on {DEVICE}")
        return t.cpu().numpy()

    def stored(src, dst, n, w=None):
        """The entries GraphBuilder stores, scipy CSR: of repeated (row,
        col) edges the first."""
        _, first = np.unique(src * n + dst, return_index=True)
        vals = np.ones(len(first)) if w is None else w[first]
        return sp.csr_matrix((vals, (src[first], dst[first])), shape=(n, n))

    def min_label(W):
        """Weak components, each labelled with its smallest vertex id."""
        n = W.shape[0]
        _, comp = csgraph.connected_components(W, directed=True,
                                               connection="weak")
        low = np.full(comp.max() + 1, n)
        np.minimum.at(low, comp, np.arange(n))
        return low[comp]

    def sources(W, k, seed):
        deg = np.diff(W.indptr)
        return np.sort(np.random.default_rng(seed).choice(
            np.nonzero(deg >= 1)[0], k, replace=False))

    def call_column(res, col=1):
        check(res.error is None, f"CALL error {res.error}")
        return np.array([r[col] for r in res.rows])

    def closure_widths(W):
        """The frontier words of each WCC closure batch, from scipy's
        components: after the vertices with no stored entry, batches of the
        WCC_BATCH smallest unlabelled ids, each labelling its seeds' whole
        components."""
        _, comp = csgraph.connected_components(W, directed=True,
                                               connection="weak")
        done = (np.diff(W.indptr) == 0) & (np.diff(W.tocsc().indptr) == 0)
        widths = []
        while not done.all():
            batch = np.flatnonzero(~done)[:WCC_BATCH]
            widths.append(-(-len(batch) // 32))
            done |= np.isin(comp, comp[batch])
        return widths

    def wcc_phase(g, W, fmt, kernel):
        # the word kernel at each width a closure batch gives it, on both
        # handles (a closure hops both directions), against its plain
        # version bit for bit
        case = h.ell_case if fmt == "ell" else h.bitadj_case
        A = g.relations["KNOWS"].A
        widths = closure_widths(W)
        for w in sorted(set(widths), reverse=True):
            for side, store in (("forward", A.store),
                                ("transpose", A.T.store)):
                word_shapes[kernel][f"{fmt} {side} W={w}"] = case(
                    store, w, f"scale-{g.n.bit_length() - 1} {side} handle "
                    f"W={w} (a WCC closure batch)", timed=True)
        t0 = time.perf_counter()
        want = min_label(W)
        oracle_s = time.perf_counter() - t0
        res, dt, launched = counted(f"algo_wcc {fmt}", lambda: execute(
            g, "CALL algo.wcc(rel: KNOWS)"), [kernel])
        got = call_column(res)
        check(np.array_equal(got, want), f"algo_wcc {fmt}: labels differ "
              f"from scipy's at {int((got != want).sum())} vertices")
        sizes = np.bincount(want)
        h.emit_phase(phase="algo_wcc", card=card, fmt=fmt, n=g.n,
                     nnz=g.relations["KNOWS"].nnz, seconds=dt,
                     components=int((sizes > 0).sum()),
                     nontrivial=int((sizes > 1).sum()),
                     giant=int(sizes.max()), launches=launched,
                     batch_words=widths, oracle_s=oracle_s, exact=True)

    def serve_closeness(g, W, fmt, kernel):
        """QUERIES seeded closeness CALLs through the server: they coalesce
        into MAX_WIDTH-column sweeps; CHECKED answers against scipy's
        levels through the Wasserman-Faust formula in float32, exactly."""
        n = g.n
        text = "CALL algo.closeness(rel: KNOWS) YIELD node, score"
        seeds = sources(W, QUERIES, 3 + g.n)
        srv = QueryServer(g)
        for s in seeds[:32]:
            srv.submit(text, seeds=[int(s)])
        check(all(r.error is None for r in srv.flush().values()),
              f"serve_call_closeness_{fmt}: warm-up batch")
        srv = QueryServer(g)

        def run():
            t0 = time.perf_counter()
            qids = [srv.submit(text, seeds=[int(s)]) for s in seeds]
            return qids, srv.flush(), time.perf_counter() - t0

        (qids, out, dt), _, launched = counted(
            f"serve_call_closeness_{fmt}", run, [kernel])
        errors = [out[q].error for q in qids if out[q].error is not None]
        check(not errors, f"serve_call_closeness_{fmt}: errors {errors[:3]}")
        check(all(len(out[q].rows) == 1 and out[q].rows[0][0] == s
                  for q, s in zip(qids, seeds)),
              f"serve_call_closeness_{fmt}: one row per query, its seed")
        want_batches = -(-QUERIES // MAX_WIDTH)
        check(srv.stats["batches"] == want_batches,
              f"serve_call_closeness_{fmt}: {srv.stats['batches']} batches, "
              f"expected {want_batches} (the CALLs must coalesce)")
        pick = np.random.default_rng(7).choice(QUERIES, CHECKED,
                                               replace=False)
        t1 = time.perf_counter()
        L = csgraph.shortest_path(W, unweighted=True, indices=seeds[pick])
        fin = np.isfinite(L)
        r = fin.sum(axis=1).astype(np.float32)
        tot = np.where(fin, L, 0.0).sum(axis=1).astype(np.float32)
        den = np.float32(n - 1) * np.where(tot > 0, tot, np.float32(1.0))
        want = np.where(tot > 0, (r - np.float32(1.0))
                        * (r - np.float32(1.0)) / den, np.float32(0.0))
        got = np.array([out[qids[i]].rows[0][1] for i in pick],
                       dtype=np.float32)
        check(np.array_equal(got, want), f"serve_call_closeness_{fmt}: "
              f"scores differ from scipy's at {int((got != want).sum())} "
              f"of {CHECKED}")
        ref_s = time.perf_counter() - t1
        lat = np.array([m.latency_s for m in srv.log]) * 1e3
        h.emit_phase(phase=f"serve_call_closeness_{fmt}", card=card, n=n,
                     queries=QUERIES, seconds=dt, qps=QUERIES / dt,
                     p50_ms=float(np.percentile(lat, 50)),
                     p99_ms=float(np.percentile(lat, 99)),
                     batches=srv.stats["batches"],
                     pack_ratio=srv.stats["pack_ratio"], launches=launched,
                     checked=CHECKED, reference_s=ref_s,
                     score_mean=float(np.mean([out[q].rows[0][1]
                                               for q in qids])))

    # -- R-MAT s16: BFS and k-hop levels, on ELL (fmt="auto") and BSR ------
    src, dst, n = rmat_edges(ALGO_SCALE)
    W = stored(src, dst, n)
    seeds = sources(W, ALGO_SOURCES, ALGO_SCALE)
    t0 = time.perf_counter()
    L = csgraph.shortest_path(W, unweighted=True, indices=seeds)
    want_lv = L.T.astype(np.float32)
    want_k = ((L >= 1) & (L <= 2)).sum(axis=1)
    bfs_oracle_s = time.perf_counter() - t0
    del L

    def bfs_phase(g, fmt, kernel):
        rel = g.relations["KNOWS"]
        lv, lv_s, lv_l = counted(f"algo_bfs {fmt}", lambda: algo.bfs_levels(
            rel, seeds), [kernel])
        kc, kc_s, kc_l = counted(f"algo_bfs {fmt} khop", lambda:
                                 algo.khop_counts(rel, seeds, 2), [kernel])
        got = on_card(lv, f"algo_bfs {fmt}")
        check(np.array_equal(got, want_lv), f"algo_bfs {fmt}: levels differ "
              f"from scipy's at {int((got != want_lv).sum())} entries")
        check(np.array_equal(on_card(kc, f"algo_bfs {fmt} khop"), want_k),
              f"algo_bfs {fmt}: k-hop counts differ from scipy's")
        fin = np.isfinite(want_lv)
        h.emit_phase(phase="algo_bfs", card=card, fmt=rel.A.fmt, n=n,
                     nnz=rel.nnz, sources=ALGO_SOURCES,
                     bfs_levels_s=lv_s, khop_counts_s=kc_s, k=2,
                     max_level=float(want_lv[fin].max()),
                     reached_mean=float(fin.sum(axis=0).mean()),
                     khop_mean=float(want_k.mean()),
                     launches={"bfs_levels": lv_l, "khop_counts": kc_l},
                     oracle_s=bfs_oracle_s, exact=True)
        del lv, kc, got

    g = rmat_graph(ALGO_SCALE, fmt="auto", device=DEVICE)
    check(g.relations["KNOWS"].A.fmt == "ell",
          f"R-MAT s{ALGO_SCALE} fmt='auto' picked "
          f"{g.relations['KNOWS'].A.fmt}, not ell")
    bfs_phase(g, "ell", "ell_mxv_packed")
    wcc_phase(g, W, "ell", "ell_mxv_packed")
    serve_closeness(g, W, "ell", "ell_mxv_packed")
    del g
    h.release()

    g = rmat_graph(ALGO_SCALE, fmt="bsr", device=DEVICE)
    rel = g.relations["KNOWS"]
    bfs_phase(g, "bsr", "bsr_mxm")
    del want_lv

    # PageRank through CALL, against float64 power iteration
    t0 = time.perf_counter()
    deg = np.asarray(W.sum(axis=1)).ravel()
    dangling = deg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.maximum(deg, 1e-30))
    WT = W.T.tocsr()
    pr = np.full(n, 1.0 / n)
    for _ in range(50):
        pr = 0.15 / n + 0.85 * (WT @ (pr * inv) + pr[dangling].sum() / n)
    pr_oracle_s = time.perf_counter() - t0
    res, dt, launched = counted("algo_pagerank", lambda: execute(
        g, "CALL algo.pagerank(rel: KNOWS) YIELD node, score"), ["bsr_mxm"])
    got = call_column(res)
    l1 = float(np.abs(got - pr).sum())
    check(l1 <= 1e-5, f"algo_pagerank: L1 distance {l1} from float64")
    h.emit_phase(phase="algo_pagerank", card=card, fmt="bsr", n=n,
                 nnz=rel.nnz, iters=50, seconds=dt, l1=l1,
                 max_abs_err=float(np.abs(got - pr).max()),
                 sum=float(got.sum()), launches=launched,
                 oracle_s=pr_oracle_s)

    # Brandes through CALL, 128 seeded sources, against a float64
    # level-synchronous Brandes in scipy
    bsrc = sources(W, BETWEENNESS_SOURCES, 128)
    t0 = time.perf_counter()
    F = len(bsrc)
    lv = csgraph.shortest_path(W, unweighted=True, indices=bsrc).T
    sigma = np.zeros((n, F))
    sigma[bsrc, np.arange(F)] = 1.0
    dmax = int(lv[np.isfinite(lv)].max())
    for d in range(dmax):
        sigma += np.where(lv == d + 1, WT @ np.where(lv == d, sigma, 0.0),
                          0.0)
    delta = np.zeros((n, F))
    for d in range(dmax, 0, -1):
        coef = np.where(lv == d, (1.0 + delta) / np.maximum(sigma, 1.0), 0.0)
        delta += np.where(lv == d - 1, sigma * (W @ coef), 0.0)
    bc_want = np.where(lv > 0, delta, 0.0).sum(axis=1)
    bc_oracle_s = time.perf_counter() - t0
    del lv, sigma, delta, coef
    text = (f"CALL algo.betweenness(rel: KNOWS, sources: "
            f"[{', '.join(str(int(s)) for s in bsrc)}]) YIELD node, score")
    res, dt, launched = counted("algo_betweenness", lambda: execute(g, text),
                                ["bsr_mxm"])
    got = call_column(res)
    big = bc_want > 1.0
    err = rel_err(got[big], bc_want[big])
    check(err <= 1e-4, f"algo_betweenness: relative error {err} on scores "
          f"above 1")
    h.emit_phase(phase="algo_betweenness", card=card, fmt="bsr", n=n,
                 sources=F, seconds=dt, levels=dmax,
                 max_rel_err_above_1=err, scores_above_1=int(big.sum()),
                 max_abs_err=float(np.abs(got - bc_want).max()),
                 launches=launched, oracle_s=bc_oracle_s)

    AT = rel.A.T.store
    shapes["pagerank"] = h.bsr_mxm_case(
        AT, h.frontier(n, 1, 1), S.PLUS_TIMES, f"scale-{ALGO_SCALE} transpose "
        f"handle F=1 (PageRank's pull)", timed=True)
    shapes["brandes"] = h.bsr_mxm_case(
        AT, h.frontier(n, BETWEENNESS_SOURCES, 128), S.PLUS_TIMES,
        f"scale-{ALGO_SCALE} transpose handle F={BETWEENNESS_SOURCES} "
        f"(Brandes' forward sweep)", timed=True)
    serve_closeness(g, W, "bsr", "bsr_mxm")
    del g, rel, AT
    h.release()

    # SSSP: integer weights 1-3 from seed 0, against Dijkstra
    w = np.random.default_rng(0).integers(1, 4, size=len(src)).astype(
        np.float32)
    g = GraphBuilder(n).add_edges("KNOWS", src, dst, w).build(
        fmt="bsr", device=DEVICE)
    rel = g.relations["KNOWS"]
    Ww = stored(src, dst, n, w)
    ssrc = sources(Ww, SSSP_SOURCES, 64)
    t0 = time.perf_counter()
    want = csgraph.dijkstra(Ww, indices=ssrc).T.astype(np.float32)
    sssp_oracle_s = time.perf_counter() - t0
    dist, dt, launched = counted("algo_sssp", lambda: algo.sssp(rel, ssrc),
                                 ["bsr_mxm"])
    got = on_card(dist, "algo_sssp")
    check(np.array_equal(got, want), f"algo_sssp: distances differ from "
          f"Dijkstra's at {int((got != want).sum())} entries")
    fin = np.isfinite(want)
    h.emit_phase(phase="algo_sssp", card=card, fmt="bsr", n=n,
                 nnz=rel.nnz, sources=SSSP_SOURCES, weights="1-3",
                 seconds=dt, rounds=launched.get("bsr_mxm"),
                 max_dist=float(want[fin].max()),
                 reached_mean=float(fin.sum(axis=0).mean()),
                 launches=launched, oracle_s=sssp_oracle_s, exact=True)
    shapes["sssp"] = h.bsr_mxm_case(
        rel.A.T.store, dist, S.MIN_PLUS, f"scale-{ALGO_SCALE} weighted "
        f"transpose handle F={SSSP_SOURCES} (SSSP's relaxation)", timed=True,
        with_tile=False, library=None)
    del g, rel, dist, Ww, W, WT
    h.release()

    # label propagation (CDLP) through CALL on R-MAT s14
    lsrc, ldst, ln = rmat_edges(LABELPROP_SCALE)
    Wl = stored(lsrc, ldst, ln)
    g = rmat_graph(LABELPROP_SCALE, fmt="bsr", device=DEVICE)
    t0 = time.perf_counter()
    C = Wl.tocoo()
    tgt = np.concatenate([C.row, C.col, np.arange(ln)])
    voter = np.concatenate([C.col, C.row, np.arange(ln)])
    labels, rounds = np.arange(ln), 0
    for _ in range(50):
        key, cnt = np.unique(tgt * ln + labels[voter], return_counts=True)
        v, lab = key // ln, key % ln
        # each vertex's first row after the sort: its top count's
        # smallest label (every vertex votes for itself, so each has one)
        order = np.lexsort((lab, -cnt, v))
        _, first = np.unique(v[order], return_index=True)
        new = lab[order][first]
        rounds += 1
        if np.array_equal(new, labels):
            break
        labels = new
    lp_oracle_s = time.perf_counter() - t0
    res, dt, launched = counted("algo_labelprop", lambda: execute(
        g, "CALL algo.labelprop(rel: KNOWS)"), ["bsr_mxm"])
    got = call_column(res)
    check(np.array_equal(got, labels), f"algo_labelprop: labels differ from "
          f"numpy's at {int((got != labels).sum())} vertices")
    h.emit_phase(phase="algo_labelprop", card=card, fmt="bsr",
                 scale=LABELPROP_SCALE, n=ln, nnz=g.relations["KNOWS"].nnz,
                 seconds=dt, rounds=rounds,
                 communities=int(len(np.unique(labels))),
                 chunks=launched["bsr_mxm"] // 2, launches=launched,
                 oracle_s=lp_oracle_s, exact=True)
    onehot = torch.zeros((ln, LABEL_CHUNK), dtype=torch.float32,
                         device=DEVICE)
    onehot[torch.arange(LABEL_CHUNK), torch.arange(LABEL_CHUNK)] = 1.0
    shapes["labelprop"] = h.bsr_mxm_case(
        g.relations["KNOWS"].A.T.store, onehot, S.PLUS_PAIR,
        f"scale-{LABELPROP_SCALE} transpose handle F={LABEL_CHUNK} (a CDLP "
        f"vote chunk)", timed=True, library="pattern")
    del g, onehot, Wl
    h.release()

    # WCC on the BitELL serving graph
    bsrc_, bdst, bn = rmat_edges(WCC_BITADJ_SCALE)
    Wb = stored(bsrc_, bdst, bn)
    g, _ = h.bitadj_graph(WCC_BITADJ_SCALE)
    wcc_phase(g, Wb, "bitadj", "bitadj_mxv_packed")
    del g, Wb
    h.release()
    return shapes, words, word_shapes


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


def rel_err(got, want) -> float:
    """Largest |got - want| / |want| (0 where both are 0; inf where only
    want is)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    d = np.abs(got - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(d == 0, 0.0, d / np.abs(want))
    return float(r.max())


def undirected_csr(src, dst, n):
    """The deduplicated 0/1 adjacency, scipy CSR on the host."""
    import scipy.sparse as sp
    key = np.unique(src * n + dst)
    return sp.csr_matrix((np.ones(len(key)), (key // n, key % n)),
                         shape=(n, n))


def masked_support(A, step=4096):
    """(A @ A) restricted to A's pattern, a row band at a time: each edge's
    common-neighbour count, stored where it is at least 1."""
    import scipy.sparse as sp
    parts = []
    for lo in range(0, A.shape[0], step):
        band = A[lo:lo + step]
        parts.append((band @ A).multiply(band))
    return sp.vstack(parts).tocsr()


def peel(A, k):
    """The k-truss by scipy peeling: (support matrix of the truss, rounds),
    the rounds counted as the port's loop counts them."""
    cur, rounds = A, 0
    while True:
        S_ = masked_support(cur)
        S_.data[S_.data < k - 2] = 0
        S_.eliminate_zeros()
        rounds += 1
        if S_.nnz == cur.nnz or S_.nnz == 0:
            return S_, rounds
        cur = S_.copy()
        cur.data[:] = 1.0


def library_ewise(torch, mode, A, B):
    """(ms, reason): PyTorch's own sparse element-wise op on the same
    entries as coalesced CUDA COO tensors, the union ``(A + B).coalesce()``
    or the intersection ``A * B``; None and why when it did not run."""
    try:
        def coo(store):
            r, c, v = store.to_coo()
            return torch.sparse_coo_tensor(
                torch.from_numpy(np.stack([r, c])), torch.from_numpy(v),
                store.shape).coalesce().to(DEVICE)
        X, Y = coo(A), coo(B)
        fn = ((lambda: (X + Y).coalesce()) if mode == "union"
              else (lambda: X * Y))
        return time_ms(torch, fn, reps=5), None
    except Exception as e:         # the yardstick only; no phase depends on it
        return None, f"{type(e).__name__}: {e}"[:300]


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
        ms = time_ms(torch, lambda: M @ Xp, reps=2, warmup=1)
        return ms, None
    except Exception as e:         # the yardstick only; no phase depends on it
        return None, f"{type(e).__name__}: {e}"[:300]


def library_spmm(torch, csr, shape, X, pattern=False):
    """(ms, reason): ``torch.sparse.mm`` of the handle's row CSR, already
    on the card, and the dense frontier (cuSPARSE SpMM: the same gathers
    and multiply-adds as the entry kernel, over plus_times; with
    ``pattern`` over ones, the plus_pair count of a 0/1 frontier), or None
    and why it did not run. A yardstick only: the port never calls it."""
    try:
        vals = torch.ones_like(csr.vals) if pattern else csr.vals
        M = torch.sparse_csr_tensor(csr.indptr, csr.cols.long(), vals,
                                    size=tuple(shape))
        Xf = X.to(torch.float32).contiguous()
        return time_ms(torch, lambda: torch.sparse.mm(M, Xf)), None
    except Exception as e:         # the yardstick only; no phase depends on it
        return None, f"{type(e).__name__}: {e}"[:300]


def library_spgemm(torch, store, masked=False):
    """(ms, reason): ``torch.sparse.mm`` of the handle's CSR form with
    itself (cuSPARSE SpGEMM), then with ``masked`` the product times the
    handle as coalesced COO (the <A> mask); or None and why it did not
    run."""
    try:
        r, c, v = store.to_coo()
        n = store.shape[0]
        U = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([r, c])), torch.from_numpy(v),
            (n, n)).coalesce()
        M = U.to_sparse_csr().to(DEVICE)
        U = U.to(DEVICE)
        if masked:
            def fn():
                return torch.sparse.mm(M, M).to_sparse_coo() * U
        else:
            def fn():
                return torch.sparse.mm(M, M)
        ms = time_ms(torch, fn, reps=5)
        return ms, None
    except Exception as e:         # the yardstick only; no phase depends on it
        return None, f"{type(e).__name__}: {e}"[:300]


def write_path_cells(torch, h):
    """The write path on the card: ``Database`` / ``MutableGraph`` with an
    AOF in a temporary directory, delta-served reads, compaction, replay,
    the algorithms on a delta handle and dense handles. Each phase is
    driven with the launch counts at 0 and read just after; each is held
    against an oracle that does not use the port (scipy over the live
    edge set) or against the same graph compacted. ``h`` carries main's
    helpers and the path's launch totals (``h.path``). Returns the word
    kernel's launches on the write path and the kernels' rows at the
    write path's shapes."""
    import shutil
    import tempfile

    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from repro_torch import algorithms as algo
    from repro_torch.core import grb
    from repro_torch.core import semiring as S
    from repro_torch.core.delta import AUTO_DELTA_COMPACT, DeltaMatrix
    from repro_torch.engine import Database, QueryServer
    from repro_torch.engine.server import MAX_WIDTH
    from repro_torch.graph.datagen import rmat_edges
    from repro_torch.graph.graph import Graph, Relation
    from repro_torch.kernels import bsr_mxm

    card = h.card
    words = {"ell_mxv_packed": 0}
    # the kernels at the write path's shapes, bit for bit against their
    # plain versions: kernel 1 on the delta patches, kernel 3's entry
    # kernel on the 64-tile bases
    shapes = {"ell_mxv_packed": {}, "bsr_mxm": {}}
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_write_")

    def counted(fn):
        """(fn(), seconds, launches, variant launches) with the counts at
        0 just before; the launches join the path's totals."""
        h.zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got, var = h.launches_now(), h.variant_launches()
        for k in h.path:
            h.path[k] += var[k]
        words["ell_mxv_packed"] += got["ell_mxv_packed"]
        return out, dt, got, var

    def live_csr(mg, n):
        """scipy CSR of the live KNOWS edge set (``MutableGraph.edges``)."""
        keys = np.array([(s, d) for (r, s, d) in mg.edges if r == "KNOWS"],
                        dtype=np.int64).reshape(-1, 2)
        return sp.csr_matrix((np.ones(len(keys)), (keys[:, 0], keys[:, 1])),
                             shape=(n, n))

    def compacted(g):
        """The query's relation of ``g`` with its deltas folded into fresh
        base-format handles, held by the returned graph alone."""
        A = g.relations["KNOWS"].A
        h_ = grb.GBMatrix(A.store.materialize(), name="KNOWS")
        h_.link_transpose(grb.GBMatrix(A.T.store.materialize(),
                                       name="KNOWS^T"))
        return Graph(n=g.n, relations={"KNOWS": Relation("KNOWS", h_,
                                                         nnz=A.nvals)},
                     labels=g.labels, node_props=g.node_props,
                     device=g.device)

    def unique_edges(src, dst, n):
        key = np.unique(src * n + dst)
        return key // n, key % n

    def reach_12(W, s):
        """Vertices first reached from s at hop 1 or 2 (s itself never)."""
        n1 = W.indices[W.indptr[s]:W.indptr[s + 1]]
        n2 = W[n1].indices if len(n1) else np.zeros(0, np.int64)
        r = np.union1d(n1, n2)
        return int(len(r) - np.isin(s, r))

    def serve(source, seeds, tag, warm=True):
        """Seeded k-hop queries through one server, after a warm-up batch
        of CHECKED queries that builds the handles' kernel forms: (counts,
        qps, p50_ms, p99_ms, seconds, launches, variants)."""
        srv = source if isinstance(source, QueryServer) else \
            QueryServer(source)
        if warm:
            for s in seeds[:CHECKED]:
                srv.submit(tmpl, seeds=[int(s)])
            srv.flush()

        def run():
            qids = [srv.submit(tmpl, seeds=[int(s)]) for s in seeds]
            return srv.flush(), qids

        (out, qids), dt, got, var = counted(run)
        errors = [out[q].error for q in qids if out[q].error]
        check(not errors, f"{tag}: query errors {errors[:3]}")
        counts = np.array([out[q].scalar() for q in qids])
        lat = np.array([m.latency_s for m in srv.log[-len(qids):]]) * 1e3
        return (counts, len(seeds) / dt, float(np.percentile(lat, 50)),
                float(np.percentile(lat, 99)), dt, got, var)

    def per_kind(frac, base_keys, sym=False):
        """Deletes (and creates) of a stream of ``frac`` of the base."""
        return max(2, int(frac * len(base_keys)) // (4 if sym else 2))

    def stream(mg, base_keys, n, k, rng, sym=False):
        """One write stream: k deletes of base edges still live and k
        creates of pairs absent from the base and the live set, as
        commands of WRITE_COMMAND edges in a random order (both
        directions of each pair with ``sym``)."""
        live = [(s, d) for (s, d) in base_keys
                if ("KNOWS", s, d) in mg.edges]
        pick = rng.choice(len(live), k, replace=False)
        dels = [live[i] for i in pick]
        base_set = set(base_keys)
        adds, seen = [], set()
        while len(adds) < k:
            a, b = (int(x) for x in rng.integers(0, n, 2))
            if sym:
                a, b = min(a, b), max(a, b)
            if a != b and (a, b) not in base_set and (a, b) not in seen \
                    and ("KNOWS", a, b) not in mg.edges \
                    and ("KNOWS", b, a) not in mg.edges:
                adds.append((a, b))
                seen.add((a, b))
        if sym:
            dels += [(d, s) for s, d in dels]
            adds += [(d, s) for s, d in adds]
        cmds = []
        for kind, pairs in (("DELETE", dels), ("CREATE", adds)):
            for i in range(0, len(pairs), WRITE_COMMAND):
                cmds.append(f"{kind} " + ", ".join(
                    f"({s})-[:KNOWS]->({d})"
                    for s, d in pairs[i:i + WRITE_COMMAND]))
        order = rng.permutation(len(cmds))
        return [cmds[i] for i in order], len(dels) + len(adds)

    try:
        # -- the write rounds: R-MAT s16, ELL (fmt="auto") and BSR (b=64) --
        src, dst, n = rmat_edges(WRITE_SCALE)
        db = Database(data_dir=os.path.join(tmp, "aof"), device=DEVICE)
        names = {"ell": "g", "bsr": "g_bsr"}
        base_keys = None
        for fmt, name in names.items():
            mg = db._graph(name)
            if fmt == "bsr":
                mg.fmt = "bsr"                       # block 64, as in JAX
            t0 = time.perf_counter()
            for s, d in zip(src.tolist(), dst.tolist()):
                mg.create_edge(s, "KNOWS", d)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            g = mg.freeze()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            A = g.relations["KNOWS"].A
            check(A.fmt == "delta" and A.store.fmt == fmt,
                  f"write_{fmt}: base {A.store.fmt}, want {fmt}")
            check(A.store.device.type == torch.device(DEVICE).type,
                  f"write_{fmt}: base on {A.store.device}")
            if base_keys is None:
                r_, c_, _ = A.store.to_coo()
                base_keys = list(zip(r_.tolist(), c_.tolist()))
            h.emit_phase(phase=f"write_load_{fmt}", card=card,
                         scale=WRITE_SCALE, n=g.n, nnz=A.nvals,
                         base=type(A.store.base).__name__,
                         block=mg.block if fmt == "bsr" else None,
                         load_s=load_s, build_s=build_s,
                         aof="the bulk load goes through "
                             "MutableGraph.create_edge and is not in the AOF",
                         memory_allocated_gb=torch.cuda.memory_allocated()
                         / 1e9)
            del g, A
        rng = np.random.default_rng(SEED)
        seeds_rng = np.random.default_rng(SEED + 1)
        for rnd in range(1, WRITE_ROUNDS + 1):
            cmds, edges = stream(db._graph("g"), base_keys, n,
                                 per_kind(WRITE_FRAC, base_keys), rng)
            deg = np.diff(live_csr(db._graph("g"), n).indptr)
            seeds = seeds_rng.choice(np.nonzero(deg >= 1)[0], QUERIES,
                                     replace=False)
            W, answers = None, {}
            for fmt, name in names.items():
                mg = db._graph(name)
                reader = db.context(name)            # frozen before the round
                snap = serve(reader.graph, seeds[:CHECKED], f"snapshot {fmt}",
                             warm=False)
                # the writes: every command fsynced before query returns
                t0 = time.perf_counter()
                for c in cmds:
                    db.query(name, c)
                write_s = time.perf_counter() - t0
                comp0 = mg.compactions
                t0 = time.perf_counter()
                g = mg.freeze()
                freeze_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                rels = [g.relations["KNOWS"].A, g.relations["KNOWS"].A.T,
                        g.adj.A, g.adj.A.T]
                for a in rels:
                    a.store.patch()
                torch.cuda.synchronize()
                patch_s = time.perf_counter() - t0
                dm = rels[0].store
                pending = dm.pending / max(dm.base_nnz, 1)
                folded = mg.compactions - comp0
                check(mg.rebuilds == 1, f"write_{fmt} round {rnd}: "
                      f"{mg.rebuilds} rebuilds")
                # pending after round r is r * WRITE_FRAC of the base: the
                # first round past the threshold folds both relation pairs
                # (KNOWS and the union adjacency)
                want_c = 2 if rnd * WRITE_FRAC > AUTO_DELTA_COMPACT \
                    >= (rnd - 1) * WRITE_FRAC else 0
                check(folded == want_c, f"write_{fmt} round {rnd}: "
                      f"{folded} compactions, want {want_c}")
                counts, qps, p50, p99, dt, got, var = serve(
                    db.server(name), seeds, f"write_{fmt} round {rnd}")
                kernel = "ell_mxv_packed" if fmt == "ell" else "bsr_mxm"
                check(got[kernel] > 0, f"write_{fmt} round {rnd}: {kernel} "
                      f"never launched")
                if W is None:
                    W = live_csr(mg, n)
                answers[fmt] = counts
                pick = np.random.default_rng(rnd).choice(QUERIES, CHECKED,
                                                         replace=False)
                for i in pick:
                    want = reach_12(W, int(seeds[i]))
                    check(int(counts[i]) == want, f"write_{fmt} round {rnd}: "
                          f"seed {seeds[i]} counts {counts[i]}, want {want}")
                dT = rels[1].store              # the hops' transpose twin
                if fmt == "ell" and dT.pending:
                    # kernel 1 on the patch the hops ran: the touched rows'
                    # ELL, rows and width bucketed to powers of two
                    patch = dT.patch()[0]
                    shapes["ell_mxv_packed"][f"patch_round_{rnd}"] = \
                        h.ell_case(patch, MAX_WIDTH // 32,
                                   f"scale-{WRITE_SCALE} delta patch, round "
                                   f"{rnd}: {patch.shape[0]} rows "
                                   f"({dT.touched} touched) x "
                                   f"{patch.max_deg} slots, W="
                                   f"{MAX_WIDTH // 32}", timed=True,
                                   earlier=False)
                    del patch
                if fmt == "bsr" and rnd == 1:
                    # kernel 3 on the twin's 64-tile base, hop 2 of one
                    # batch: unmasked while deltas are pending (the mask
                    # is applied after the patch's rows), <!visited> once
                    # compacted (round 3 serves the base alone)
                    base = dT.base
                    B0 = torch.zeros((base.shape[1], MAX_WIDTH),
                                     device=DEVICE)
                    B0[torch.from_numpy(seeds[:MAX_WIDTH]).to(DEVICE),
                       torch.arange(MAX_WIDTH, device=DEVICE)] = 1.0
                    X1 = bsr_mxm.bsr_mxm(base, B0, S.OR_AND, mask=B0,
                                         complement=True)
                    visited = torch.maximum(B0, X1)
                    tag = (f"scale-{WRITE_SCALE} 64-tile transpose base "
                           f"F={MAX_WIDTH}, hop 2")
                    shapes["bsr_mxm"]["delta_hop"] = h.bsr_mxm_case(
                        base, X1, S.OR_AND, f"{tag} (delta rounds)",
                        timed=True, with_tile=False)
                    shapes["bsr_mxm"]["compacted_hop"] = h.bsr_mxm_case(
                        base, X1, S.OR_AND, f"{tag} <!visited> (round 3)",
                        mask=visited, complement=True, timed=True,
                        with_tile=False)
                    del base, B0, X1, visited
                again = serve(reader.graph, seeds[:CHECKED],
                              f"snapshot {fmt}", warm=False)
                check(np.array_equal(again[0], snap[0]),
                      f"write_{fmt} round {rnd}: the snapshot moved")
                del reader
                # the same graph compacted: every answer equal
                t0 = time.perf_counter()
                gc_ = compacted(g)
                torch.cuda.synchronize()
                compact_s = time.perf_counter() - t0
                ccounts, cqps, cp50, cp99, _, _, _ = serve(
                    gc_, seeds, f"compacted {fmt} round {rnd}")
                check(np.array_equal(ccounts, counts),
                      f"write_{fmt} round {rnd}: delta-served answers differ "
                      f"from the compacted graph's")
                del gc_
                h.emit_phase(
                    phase=f"write_round_{fmt}", card=card, round=rnd,
                    scale=WRITE_SCALE, commands=len(cmds), edges=edges,
                    write_s=write_s, write_edges_per_s=edges / write_s,
                    write_commands_per_s=len(cmds) / write_s,
                    fsync="every command, before Database.query returns",
                    freeze_ms=1e3 * freeze_s, patch_ms=1e3 * patch_s,
                    compaction_s=freeze_s if folded else None,
                    catch_up_ms=1e3 * (freeze_s + patch_s),
                    pending_share=pending, touched_rows=dm.touched,
                    compactions=mg.compactions, rebuilds=mg.rebuilds,
                    compacted_this_round=folded,
                    queries=QUERIES, qps=qps, p50_ms=p50, p99_ms=p99,
                    compacted_qps=cqps, compacted_p50_ms=cp50,
                    compacted_p99_ms=cp99, compact_view_s=compact_s,
                    launches={k: v for k, v in got.items() if v},
                    variants={k: v for k, v in var.items() if v},
                    checked=CHECKED, snapshot_still=True,
                    equal_to_compacted=True)
                del g, rels, dm
                h.release()
            check(np.array_equal(answers["ell"], answers["bsr"]),
                  f"write round {rnd}: the ELL and BSR graphs disagree")

        # -- writes interleaved with reads: one command, then one batch ----
        # right after round 3's compaction, then past a bulk write of
        # INTERLEAVE_BULK; each step's latency holds the fsynced write,
        # the server's re-freeze (apply_ops) and the patch built anew
        irng = np.random.default_rng(SEED + 6)
        deg = np.diff(live_csr(db._graph("g"), n).indptr)
        iseeds = seeds_rng.choice(np.nonzero(deg >= 1)[0], MAX_WIDTH,
                                  replace=False)
        servers = {fmt: db.server(name) for fmt, name in names.items()}
        for stage, bulk in (("after_compaction", 0.0),
                            ("bulk_pending", INTERLEAVE_BULK)):
            bulk_edges = 0
            if bulk:
                cmds, bulk_edges = stream(db._graph("g"), base_keys, n,
                                          per_kind(bulk, base_keys), irng)
                for name in names.values():
                    for c in cmds:
                        db.query(name, c)
            # INTERLEAVE_STEPS commands of WRITE_COMMAND edges, half
            # DELETE and half CREATE, in a random order
            steps, _ = stream(db._graph("g"), base_keys, n,
                              WRITE_COMMAND * INTERLEAVE_STEPS // 2, irng)
            row = dict(phase="write_interleaved", card=card, stage=stage,
                       scale=WRITE_SCALE, bulk_edges=bulk_edges,
                       command_edges=WRITE_COMMAND, reads=MAX_WIDTH,
                       fsync="every command, before Database.query returns")
            last = {}
            for fmt, name in names.items():
                mg, srv = db._graph(name), servers[fmt]
                comp0 = mg.compactions
                # the same batch with nothing written before it
                quiet = serve(srv, iseeds, f"interleaved {fmt} quiet")
                pts = []
                for c in steps:
                    t0 = time.perf_counter()
                    db.query(name, c)
                    write_s = time.perf_counter() - t0
                    counts, _, p50, p99, dt, got, _ = serve(
                        srv, iseeds, f"interleaved {fmt}", warm=False)
                    step_s = time.perf_counter() - t0
                    dm = mg.freeze().relations["KNOWS"].A.T.store
                    pts.append({"write_ms": 1e3 * write_s,
                                "batch_ms": 1e3 * dt,
                                "step_ms": 1e3 * step_s, "p50_ms": p50,
                                "p99_ms": p99,
                                "pending_share": dm.pending / dm.base_nnz,
                                "touched_rows": dm.touched,
                                "launches": {k: v for k, v in got.items()
                                             if v}})
                check(mg.compactions == comp0 and mg.rebuilds == 1,
                      f"interleaved {fmt}: {mg.compactions - comp0} "
                      f"compactions, {mg.rebuilds} rebuilds")
                last[fmt] = counts
                row[fmt] = {"quiet_batch_ms": 1e3 * quiet[4],
                            "quiet_p50_ms": quiet[2],
                            "quiet_p99_ms": quiet[3], "steps": pts}
            check(np.array_equal(last["ell"], last["bsr"]),
                  f"interleaved {stage}: the ELL and BSR graphs disagree")
            W = live_csr(db._graph("g"), n)
            for i in range(0, MAX_WIDTH, MAX_WIDTH // CHECKED):
                want = reach_12(W, int(iseeds[i]))
                check(int(last["ell"][i]) == want, f"interleaved {stage}: "
                      f"seed {iseeds[i]} counts {last['ell'][i]}, want {want}")
            row["checked"] = CHECKED
            h.emit_phase(**row)
        del db, servers, mg, srv, dm
        h.release()

        # -- read cost against the pending share (the delta.py claim) ------
        us, ud = unique_edges(src, dst, n)
        for fmt in ("ell", "bsr"):
            base = grb.GBMatrix.from_coo(us, ud, None, (n, n), fmt=fmt,
                                         block=64, device=DEVICE).store
            br, bc = us, ud
            # small integers: every sum is exact, so delta and compacted
            # agree bit for bit whatever their summation order
            x1 = torch.randint(0, 4, (n, 1), device=DEVICE).to(torch.float32)
            X = torch.zeros((n, MAX_WIDTH), device=DEVICE)
            X[torch.arange(MAX_WIDTH), torch.arange(MAX_WIDTH)] = 1.0
            if fmt == "bsr":
                shapes["bsr_mxm"]["read_cost_mxv"] = h.bsr_mxm_case(
                    base, x1, S.PLUS_TIMES, f"scale-{WRITE_SCALE} 64-tile "
                    f"base F=1 (the read cost's mxv)", timed=True,
                    with_tile=False)
            crng = np.random.default_rng(SEED + 2)
            row = dict(phase=f"write_read_cost_{fmt}", card=card,
                       scale=WRITE_SCALE, nnz=base.nnz, points=[])
            for pct in READ_COST_PENDING:
                k = int(pct * base.nnz) // 2
                pick = crng.choice(len(br), k, replace=False)
                ops = [("del", int(br[i]), int(bc[i]), 0.0) for i in pick]
                ops += [("add", int(a), int(b), 1.0)
                        for a, b in crng.integers(0, n, (k, 2))]
                t0 = time.perf_counter()
                dm = DeltaMatrix.wrap(base).apply_ops(ops)
                apply_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                dm.patch()
                torch.cuda.synchronize()
                patch_s = time.perf_counter() - t0
                hd = grb.GBMatrix(dm)
                t0 = time.perf_counter()
                hc = grb.GBMatrix(dm.materialize())
                torch.cuda.synchronize()
                materialize_s = time.perf_counter() - t0
                pt = {"pending": pct, "pending_entries": dm.pending,
                      "touched_rows": dm.touched, "apply_ops_s": apply_s,
                      "patch_s": patch_s, "compact_s": materialize_s}
                for what, sr, B in (("plus_times_mxv", S.PLUS_TIMES, x1),
                                    ("or_and_F512", S.OR_AND, X)):
                    yd = grb.mxm(hd, B, sr)
                    yc = grb.mxm(hc, B, sr)
                    torch.cuda.synchronize()
                    check(torch.equal(yd, yc), f"read cost {fmt} {pct}: "
                          f"{sr.name} delta != compacted")
                    td = time_ms(torch, lambda: grb.mxm(hd, B, sr), reps=5)
                    tc = time_ms(torch, lambda: grb.mxm(hc, B, sr), reps=5)
                    pt[what] = {"delta_ms": td, "compacted_ms": tc,
                                "ratio": td / tc}
                row["points"].append(pt)
                del dm, hd, hc, yd, yc
                h.release()
            h.emit_phase(**row)
            del base, X, x1
            h.release()

        # -- the algorithms on a delta handle: undirected R-MAT s14 BSR ----
        asrc, adst, an = rmat_edges(WRITE_ALGO_SCALE)
        keep = asrc != adst
        us = np.concatenate([asrc[keep], adst[keep]])
        ud = np.concatenate([adst[keep], asrc[keep]])
        adb = Database(device=DEVICE)
        mg = adb._graph("u")
        mg.fmt = "bsr"
        for s, d in zip(us.tolist(), ud.tolist()):
            mg.create_edge(s, "KNOWS", d)
        g0 = mg.freeze()
        r_, c_, _ = g0.relations["KNOWS"].A.store.to_coo()
        ukeys = [(s, d) for s, d in zip(r_.tolist(), c_.tolist()) if s < d]
        cmds, edges = stream(mg, ukeys, an,
                             per_kind(2 * WRITE_FRAC, ukeys, sym=True),
                             np.random.default_rng(SEED + 3), sym=True)
        for c in cmds:
            adb.query("u", c)
        del g0
        g = mg.freeze()
        Ad = g.relations["KNOWS"].A
        check(Ad.fmt == "delta" and Ad.store.pending > 0,
              "algo_delta: no pending delta")
        Ac = compacted(g).relations["KNOWS"].A
        an = Ad.shape[0]                 # ids past the last edge unused
        W = live_csr(mg, an)
        srcs = np.arange(0, an, an // 64)[:64]
        results = {}
        for name, fn, exact in (
                ("bfs_levels", lambda A: algo.bfs_levels(A, srcs), True),
                ("sssp", lambda A: algo.sssp(A, srcs), True),
                ("wcc", lambda A: algo.wcc(A), True),
                ("triangle_count", lambda A: algo.triangle_count(A), True),
                ("pagerank", lambda A: algo.pagerank(A, iters=20), False)):
            got, dt, launched, var = counted(lambda: fn(Ad))
            want, dtc, _, _ = counted(lambda: fn(Ac))
            if exact:
                check(torch.equal(got, want),
                      f"algo_delta {name}: delta != compacted")
            else:
                err = float((got - want).abs().max())
                check(err <= 1e-5, f"algo_delta {name}: {err} > 1e-5")
            results[name] = {"delta_s": dt, "compacted_s": dtc,
                             "launches": {k: v for k, v in launched.items()
                                          if v},
                             "variants": {k: v for k, v in var.items() if v}}
        base = Ad.T.store.base           # the pulls' 64-tile twin base
        # the base's rows of SSSP's distances, as _mxm_delta gives them
        # (the delta grew past the base's last id)
        dist = algo.sssp(Ad, srcs)[:base.shape[1]]
        shapes["bsr_mxm"]["sssp"] = h.bsr_mxm_case(
            base, dist, S.MIN_PLUS, f"scale-{WRITE_ALGO_SCALE} 64-tile "
            f"transpose base F={len(srcs)} (SSSP's relaxation on the "
            f"delta)", timed=True, with_tile=False, library=None)
        shapes["bsr_mxm"]["pagerank"] = h.bsr_mxm_case(
            base, h.frontier(base.shape[1], 1, 1), S.PLUS_TIMES,
            f"scale-{WRITE_ALGO_SCALE} 64-tile transpose base F=1 "
            f"(PageRank's pull on the delta)", timed=True, with_tile=False)
        del base, dist
        tri = int(counted(lambda: algo.triangle_count(Ad))[0])
        check(tri == int(round((W @ W).multiply(W).sum() / 6)),
              "algo_delta triangle_count != scipy")
        _, comp = csgraph.connected_components(W, directed=False)
        labels = algo.wcc(Ad).cpu().numpy()
        check(len(np.unique(labels)) == comp.max() + 1,
              "algo_delta wcc: component count != scipy's")
        spgemm_ = ("bsr_spgemm", "bsr_dot")    # by core.grb's route rule
        check(sum(results["triangle_count"]["launches"].get(k, 0)
                  for k in spgemm_) > 0,
              "algo_delta: no SpGEMM kernel launched")
        T, kt_s, klaunch, kvar = counted(lambda: algo.ktruss(Ad, 4))
        Tc = algo.ktruss(Ac, 4)
        check(torch.equal(T.to_dense(), Tc.to_dense()),
              "algo_delta ktruss(4): delta != compacted")
        check(klaunch["bsr_ewise"] > 0
              and sum(klaunch[k] for k in spgemm_) > 0,
              "algo_delta ktruss: bsr_ewise / no SpGEMM kernel launched")
        results["ktruss_4"] = {"delta_s": kt_s, "edges": T.nvals,
                               "launches": {k: v for k, v in klaunch.items()
                                            if v},
                               "variants": {k: v for k, v in kvar.items()
                                            if v}}
        h.emit_phase(phase="write_algorithms", card=card, fmt="bsr",
                     block=mg.block, scale=WRITE_ALGO_SCALE, n=an,
                     nnz=Ad.nvals, write_edges=edges,
                     pending_share=Ad.store.pending / Ad.store.base_nnz,
                     triangles=tri, results=results)
        del g, Ad, Ac, T, Tc, adb, mg
        h.release()

        # -- recovery: an R-MAT s12 graph written through CREATE -----------
        rsrc, rdst, rn = rmat_edges(RECOVERY_SCALE)
        rdir = os.path.join(tmp, "recovery")
        rdb = Database(data_dir=rdir, device=DEVICE)
        pairs = list(zip(rsrc.tolist(), rdst.tolist()))
        t0 = time.perf_counter()
        ncmd = 0
        for i in range(0, len(pairs), WRITE_COMMAND):
            rdb.query("r", "CREATE " + ", ".join(
                f"({s})-[:KNOWS]->({d})" for s, d in
                pairs[i:i + WRITE_COMMAND]))
            ncmd += 1
        create_s = time.perf_counter() - t0
        rmg = rdb._graph("r")
        rg = rmg.freeze()
        r_, c_, _ = rg.relations["KNOWS"].A.to_coo()
        rkeys = list(zip(r_.tolist(), c_.tolist()))
        cmds, edges = stream(rmg, rkeys, rn, per_kind(WRITE_FRAC, rkeys),
                             np.random.default_rng(SEED + 4))
        for c in cmds:
            rdb.query("r", c)
        ncmd += len(cmds)
        seeds = np.arange(0, rn, rn // CHECKED)[:CHECKED]
        live = serve(rdb.server("r"), seeds, "recovery live")[0]
        live_coo = rdb._graph("r").freeze().relations["KNOWS"].A.to_coo()
        del rdb, rmg, rg
        t0 = time.perf_counter()
        back = Database(data_dir=rdir, device=DEVICE)
        replay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bg = back._graph("r").freeze()
        torch.cuda.synchronize()
        first_freeze_s = time.perf_counter() - t0
        replayed = serve(back.server("r"), seeds, "recovery replayed")[0]
        check(np.array_equal(replayed, live), "recovery: replayed answers "
              "differ from the live database's")
        for a, b in zip(bg.relations["KNOWS"].A.to_coo(), live_coo):
            check(np.array_equal(a, b), "recovery: replayed edges differ")
        check(back._graph("r").rebuilds == 1, "recovery: replay rebuilt")
        h.emit_phase(phase="write_recovery", card=card, scale=RECOVERY_SCALE,
                     n=rn, nnz=bg.relations["KNOWS"].nnz, commands=ncmd,
                     create_s=create_s, write_edges=edges,
                     replay_s=replay_s, first_freeze_s=first_freeze_s,
                     aof_bytes=os.path.getsize(os.path.join(rdir, "r.aof")),
                     equal=True)
        del back, bg
        h.release()

        # -- dense handles: R-MAT s12 on the card against its ELL ----------
        dsrc, ddst, dn = rmat_edges(DENSE_SCALE)
        dsrc, ddst = unique_edges(dsrc, ddst, dn)
        Dh = grb.GBMatrix.from_coo(dsrc, ddst, None, (dn, dn), fmt="dense",
                                   device=DEVICE)
        Eh = grb.GBMatrix.from_coo(dsrc, ddst, None, (dn, dn), fmt="ell",
                                   device=DEVICE)
        check(Dh.fmt == "dense" and Dh.nvals == Eh.nvals, "dense: handle")
        drng = np.random.default_rng(SEED + 5)
        Xd = torch.from_numpy((drng.random((dn, 64)) < 0.05).astype(
            np.float32)).to(DEVICE)
        Xw = torch.from_numpy((drng.random((dn, 32)) * 4).astype(
            np.float32).round()).to(DEVICE)
        dense_ms = {}
        for sr, B, exact in ((S.OR_AND, Xd, True), (S.MIN_PLUS, Xw, True),
                             (S.PLUS_TIMES, Xw, False)):
            for d in (grb.NULL, grb.TRANSPOSE_A):
                got = grb.mxm(Dh, B, sr, d)
                want = grb.mxm(Eh, B, sr, d)
                torch.cuda.synchronize()
                check(got.device.type == torch.device(DEVICE).type,
                      "dense: product off the card")
                if exact:
                    check(torch.equal(got, want), f"dense {sr.name}: != ELL")
                else:
                    check(float((got - want).abs().max()) <= 1e-5,
                          f"dense {sr.name}: differs from ELL past 1e-5")
            dense_ms[sr.name] = wall_ms(torch, lambda: grb.mxm(Dh, B, sr))
        from repro_torch.core import bitmap
        bw = bitmap.pack(Xd)
        for t in (False, True):
            check(torch.equal(grb.mxm_words(Dh, bw, transpose_a=t),
                              grb.mxm_words(Eh, bw, transpose_a=t)),
                  "dense mxm_words != ELL's")
        for m in (S.PLUS, S.OR, S.MIN, S.MAX):
            for ax in (None, 0, 1):
                check(torch.equal(grb.reduce(Dh, m, axis=ax),
                                  grb.reduce(Eh, m, axis=ax)),
                      f"dense reduce {m.name} axis {ax} != ELL's")
        wd, wcc_s, _, _ = counted(lambda: algo.wcc(Dh))
        check(torch.equal(wd, algo.wcc(Eh)), "dense wcc != ELL's")
        h.emit_phase(phase="write_dense", card=card, scale=DENSE_SCALE, n=dn,
                     nnz=Dh.nvals, bytes=dn * dn * 4, mxm_ms=dense_ms,
                     wcc_s=wcc_s, equal=True)
        del Dh, Eh, Xd, Xw, bw, wd
        h.release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return words, shapes


def mesh_cells(torch, h):
    """The mesh on the card: ``QueryServer(mesh=)``, ``Database.query(mesh=)``,
    the algorithms and the transposed lowerings on (pod, data, model)
    meshes whose positions all lie on the one card, each phase driven once
    with the launch counts at 0 and read just after, and held against the
    unsharded port (bit for bit; PageRank within L1 1e-5) and, for the
    served answers, the BFS oracle. Every phase line carries its
    ``elapsed_s`` and the mesh's ``distinct_devices``. Returns the word
    kernels' launches under the mesh and their rows at one position's
    local shapes: position 0 timed, and every shard-local handle and word
    width the path handed a word kernel checked bit for bit."""
    from repro_torch import algorithms as algo
    from repro_torch.core import bitadj, grb, ops
    from repro_torch.core import semiring as S
    from repro_torch.core.bitmap import NIBBLE_MAX_SHARDS
    from repro_torch.core.delta import DeltaMatrix
    from repro_torch.core.ell import ELL
    from repro_torch.core.shard import _pad_words
    from repro_torch.distr import graph2d
    from repro_torch.distr import mesh as M
    from repro_torch.distr.mesh import Mesh
    from repro_torch.engine import Database, QueryServer
    from repro_torch.graph.datagen import rmat_edges, rmat_graph
    from repro_torch.kernels import bitadj_mxv, bitmap_mxv

    card = h.card
    tmpl = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN count(DISTINCT b)"
    words = {"ell_mxv_packed": 0, "bitadj_mxv_packed": 0}
    shapes = {"ell_mxv_packed": {"shards": []},
              "bitadj_mxv_packed": {"shards": []}}
    names = ("pod", "data", "model")
    ran = {}            # (id(shard-local handle), W) -> (handle, W)
    devices = set()     # every device a mesh of these phases placed

    def card_mesh(shape):
        mesh = Mesh(np.array([torch.device(DEVICE)] * int(np.prod(shape)),
                             dtype=object).reshape(shape), names)
        devices.update(str(d) for d in mesh.devices.reshape(-1))
        return mesh

    def geometry(mesh):
        return dict(mesh=dict(mesh.shape), positions=mesh.size,
                    distinct_devices=mesh.distinct_devices)

    def counted(fn, path=True):
        """(fn(), seconds, launches) with the counts at 0 just before; on
        the path, the word launches join the mesh totals and each distinct
        (shard-local handle, word width) a lowering hands the word product
        is kept for :func:`shard_cases`."""
        real = graph2d._words

        def seen(local, xg):
            ran.setdefault((id(local), xg.shape[1]), (local, xg.shape[1]))
            return real(local, xg)

        h.zero_launches()
        torch.cuda.synchronize()
        if path:
            graph2d._words = seen
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            graph2d._words = real
        got = h.launches_now()
        if path:
            for k in words:
                words[k] += got[k]
        return out, dt, got

    def shard_cases(tag, mesh):
        """Every (shard-local handle, word width) the path ran since the
        last call, its word kernel against the plain version bit for bit
        on seeded words (untimed); each of the mesh's row blocks must be
        among them. Clears the record."""
        rows = {}
        for local, w in ran.values():
            kernel = ("ell_mxv_packed" if isinstance(local, ELL)
                      else "bitadj_mxv_packed")
            case = h.ell_case if isinstance(local, ELL) else h.bitadj_case
            case(local, w, f"mesh {tag} shard {tuple(local.shape)}",
                 timed=False)
            key = (kernel, tuple(local.shape), w)
            rows[key] = rows.get(key, 0) + 1
        check(len({k for k, _ in ran}) >= mesh.shape["data"],
              f"mesh {tag}: {len(ran)} shard handles ran, fewer than the "
              f"{mesh.shape['data']} row blocks")
        ran.clear()
        for (kernel, shape, w), count in sorted(rows.items()):
            shapes[kernel]["shards"].append(dict(
                tag=tag, shape=list(shape), W=w, handles=count, equal=True))
        h.emit_phase(phase="mesh_shards", card=card, tag=tag,
                     **geometry(mesh), cases=sum(rows.values()),
                     shards=[dict(kernel=k, shape=list(sh), W=w, handles=c)
                             for (k, sh, w), c in sorted(rows.items())])

    def serve(g, seeds, mesh):
        """1024 seeded k-hop queries through one server after a warm-up
        batch (the relation's distribution and its shards' kernel forms):
        counts, latencies, launches, batches, host transfers, seconds."""
        srv = QueryServer(g, mesh=mesh)
        t0 = time.perf_counter()
        for s in seeds[:CHECKED]:
            srv.submit(tmpl, seeds=[int(s)])
        warm = srv.flush()
        check(all(v.error is None for v in warm.values()),
              f"mesh warm-up: {[v.error for v in warm.values()][:2]}")
        setup_s = time.perf_counter() - t0
        b0, x0 = srv.stats["batches"], grb.host_transfers()

        def run():
            qids = [srv.submit(tmpl, seeds=[int(s)]) for s in seeds]
            return srv.flush(), qids

        (out, qids), dt, got = counted(run, path=mesh is not None)
        errors = [out[q].error for q in qids if out[q].error]
        check(not errors, f"mesh serve: query errors {errors[:3]}")
        counts = np.array([out[q].scalar() for q in qids])
        lat = np.array([m.latency_s for m in srv.log[-len(qids):]]) * 1e3
        return dict(counts=counts, seconds=dt, qps=len(seeds) / dt,
                    p50_ms=float(np.percentile(lat, 50)),
                    p99_ms=float(np.percentile(lat, 99)), launches=got,
                    batches=srv.stats["batches"] - b0,
                    host_transfers=grb.host_transfers() - x0,
                    setup_s=setup_s)

    def serve_cell(g, kernel, mesh_shapes, tag):
        A = g.relations["KNOWS"].A
        out_deg = grb.reduce(A, S.PLUS, axis=1).cpu().numpy()
        seeds = np.random.default_rng(16).choice(
            np.nonzero(out_deg >= 1)[0], QUERIES, replace=False)
        base = serve(g, seeds, None)
        want = h.bfs_want(g)
        pick = np.random.default_rng(7).choice(QUERIES, CHECKED,
                                               replace=False)
        for shape in mesh_shapes:
            t0 = time.perf_counter()
            mesh = card_mesh(shape)
            r = serve(g, seeds, mesh)
            shard_cases(f"serve_{tag} {shape}", mesh)
            check(np.array_equal(r["counts"], base["counts"]),
                  f"mesh_serve_{tag} {shape}: rows differ from unsharded")
            for i in pick:
                check(int(r["counts"][i]) == want(tmpl, int(seeds[i])),
                      f"mesh_serve_{tag} {shape}: query {i} != BFS oracle")
            need = r["batches"] * 2 * mesh.size      # two hops a batch
            check(r["launches"][kernel] >= need and need > 0,
                  f"mesh_serve_{tag} {shape}: {kernel} launched "
                  f"{r['launches'][kernel]} times, needs {need}")
            check(r["host_transfers"] == 0,
                  f"mesh_serve_{tag} {shape}: {r['host_transfers']} host "
                  f"transfers in the batch")
            h.emit_phase(phase=f"mesh_serve_{tag}", card=card, **geometry(mesh),
                         n=g.n, nnz=A.nvals, fmt=A.fmt, queries=QUERIES,
                         seconds=r["seconds"], qps=r["qps"],
                         p50_ms=r["p50_ms"], p99_ms=r["p99_ms"],
                         batches=r["batches"],
                         launches={kernel: r["launches"][kernel]},
                         launches_needed=need,
                         host_transfers=r["host_transfers"],
                         rows_equal_unsharded=True, checked=CHECKED,
                         unsharded_qps=base["qps"],
                         unsharded_p99_ms=base["p99_ms"],
                         setup_s=r["setup_s"],
                         elapsed_s=time.perf_counter() - t0)
        return A

    def local_case(sh, kernel, tag):
        """The word kernel at position 0's local shapes (the path's
        handle: the stored transpose the pull hops read) against its
        plain version, bit for bit, and the hop's times: the word
        all-gather, the local kernel, the whole hop."""
        mesh = sh.store.mesh
        T = sh.T
        n = sh.shape[0]
        spec = ("data", None)
        xw = torch.from_numpy(np.random.default_rng(3).integers(
            0, 2 ** 32, size=(n, 16), dtype=np.uint64).astype(np.uint32)
            .view(np.int32)).to(DEVICE)
        xp = _pad_words(T.store, xw, n)
        gathered = M.all_gather(mesh, M.shard(mesh, xp, spec), "data")
        local = T.store.local[0]
        case = h.ell_case if kernel == "ell_mxv_packed" else h.bitadj_case
        row = case(local, 16, f"mesh {tuple(mesh.shape.values())} position "
                   f"0 local {tag}", timed=True, earlier=False)
        x0 = gathered[0].contiguous()
        if kernel == "ell_mxv_packed":
            got = bitmap_mxv.ell_mxv_packed(local, x0)
            want = ops.ell_mxm_packed(local, x0)
        else:
            got = bitadj_mxv.bitadj_mxv_packed(local, x0)
            want = bitadj.mxm_words(local, x0)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{kernel} == plain on the gathered "
              f"frontier of position 0 ({tag})")
        gather_ms = time_ms(torch, lambda: M.all_gather(
            mesh, M.shard(mesh, xp, spec), "data"))
        kernel_ms = row["kernel_ms"]
        hop_ms = time_ms(torch, lambda: grb.mxm_words(sh, xw,
                                                      transpose_a=True))
        dsz = mesh.shape["data"]
        k_pad = xp.shape[0]
        # what the all-gather moves into each position: the other row
        # shards' blocks, as words and as float32 indicators
        packed = (dsz - 1) * (k_pad // dsz) * xw.shape[1] * 4
        floats = packed * 32
        rec = dict(shape=list(local.shape), W=16, equal=True,
                   max_abs_err=row["max_abs_err"], kernel_ms=kernel_ms,
                   bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                   plain_ms=row["plain_ms"], library_ms=None,
                   gather_ms=gather_ms, hop_ms=hop_ms,
                   allgather_bytes_per_position=packed,
                   allgather_float_bytes_per_position=floats)
        shapes[kernel][tag] = rec
        h.emit_phase(phase="mesh_kernels", card=card, kernel=kernel, tag=tag,
                     **geometry(mesh), **rec)

    t_all = time.perf_counter()
    # -- mesh_serve_ell: R-MAT s16, fmt="auto" (ELL) ---------------------------
    g = rmat_graph(MESH_SCALE, fmt="auto", device=DEVICE)
    check(g.relations["KNOWS"].A.fmt == "ell", "mesh s16 fmt='auto' not ell")
    A = serve_cell(g, "ell_mxv_packed", MESH_SHAPES, "ell")

    # -- mesh_algo: BFS, k-hop, WCC, PageRank, SSSP on s16 ELL at (1, 4, 1) --
    t0 = time.perf_counter()
    mesh = card_mesh(MESH_SHAPES[0])
    sh = grb.distribute(A, mesh)
    seeds = np.random.default_rng(17).choice(g.n, MESH_ALGO_SOURCES,
                                             replace=False)
    res, algo_launches = {}, 0
    for name, fn in (
            ("bfs_levels", lambda X: algo.bfs_levels(X, seeds)),
            ("khop_counts", lambda X: algo.khop_counts(X, seeds, k=2)),
            ("wcc", lambda X: algo.wcc(X))):
        got, dt, launched = counted(lambda: fn(sh))
        algo_launches += launched["ell_mxv_packed"]
        check(torch.equal(got, fn(A)), f"mesh_algo {name} != unsharded")
        res[name] = dt
    check(algo_launches > 0, "mesh_algo: ell_mxv_packed never launched")
    pr, dt, _ = counted(lambda: algo.pagerank(sh))
    l1 = float((pr - algo.pagerank(A)).abs().sum())
    check(l1 <= 1e-5, f"mesh_algo pagerank L1 {l1} > 1e-5")
    res["pagerank"] = dt
    def weighted(e, forward):
        """The relation's ELL with weights 1-3 from its edge (src, dst),
        sharing the structure: the stored transpose reads its edges
        swapped, so the twin carries the same weights."""
        rows = torch.arange(e.shape[0], device=e.device)[:, None]
        src_, dst_ = (rows, e.indices) if forward else (e.indices, rows)
        w = (1 + (src_ * 7 + dst_ * 3) % 3).to(torch.float32)
        return ELL(shape=e.shape, indices=e.indices, mask=e.mask,
                   values=torch.where(e.mask, w, 0.0), nnz=e.nnz)

    Aw = grb.GBMatrix(weighted(A.store, True), name="ROAD")
    Aw.link_transpose(grb.GBMatrix(weighted(A.T.store, False),
                                   name="ROAD^T"))
    shw = grb.distribute(Aw, mesh)
    sssp_seeds = seeds[:MESH_SSSP_SOURCES]
    dist, dt, _ = counted(lambda: algo.sssp(shw, sssp_seeds))
    check(torch.equal(dist, algo.sssp(Aw, sssp_seeds)),
          "mesh_algo sssp differs")
    res["sssp"] = dt
    shard_cases("algo", mesh)
    h.emit_phase(phase="mesh_algo", card=card, **geometry(mesh), n=g.n,
                 nnz=A.nvals, sources=MESH_ALGO_SOURCES,
                 sssp_sources=MESH_SSSP_SOURCES, seconds=res,
                 pagerank_l1=l1, exact=True,
                 launches={"ell_mxv_packed": algo_launches},
                 elapsed_s=time.perf_counter() - t0)
    del Aw, shw, dist, pr

    # -- mesh_transposed: unlinked TRANSPOSE_A against the linked twin --------
    t0 = time.perf_counter()
    rng = np.random.default_rng(18)
    Xv = torch.from_numpy(np.where(rng.random((g.n, MESH_TRANSPOSED_F))
                                   < 1e-3, rng.integers(1, 3, (
                                       g.n, MESH_TRANSPOSED_F)), 0)
                          .astype(np.float32)).to(DEVICE)
    cases, used = {}, set()
    for data, srs in ((MESH_SHAPES[0][1], (S.OR_AND, S.PLUS_TIMES,
                                           S.MIN_PLUS)),
                      (MESH_WIDE_DATA, (S.OR_AND,))):
        m_ = card_mesh((1, data, 1))
        used.update(str(d) for d in m_.devices.reshape(-1))
        linked = grb.distribute(A, m_)
        un = grb.distribute(grb.GBMatrix(A.store), m_)
        check(un._T is None, "mesh_transposed: the handle has a twin")
        for sr in srs:
            x = (Xv > 0).float() if sr is S.OR_AND else Xv[:, :8]
            (got, dt, _) = counted(lambda: grb.mxm(un, x, sr,
                                                    grb.TRANSPOSE_A),
                                   path=False)
            want = grb.mxm(linked, x, sr, grb.TRANSPOSE_A)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"mesh_transposed {sr.name} data={data} != linked twin")
            body = ("nibble words" if sr is S.OR_AND
                    and data <= NIBBLE_MAX_SHARDS else
                    "float partials" if sr is S.OR_AND else
                    "pmin" if sr is S.MIN_PLUS else "psum_scatter")
            cases[f"{sr.name} data={data}"] = dict(F=x.shape[1], body=body,
                                                   seconds=dt, equal=True)
        del linked, un
    h.emit_phase(phase="mesh_transposed", card=card, n=g.n, cases=cases,
                 distinct_devices=len(used),
                 elapsed_s=time.perf_counter() - t0)

    # -- mesh_kernels: kernel 1 at a position's local shapes -----------------
    local_case(sh, "ell_mxv_packed", "s16 ELL")
    del sh, g, A
    h.release()

    # -- mesh_database: Database.query(mesh=) on s16 with pending deltas -----
    t0 = time.perf_counter()
    src, dst, n = rmat_edges(MESH_SCALE)
    key = np.unique(src * n + dst)
    db = Database(device=DEVICE)
    mg = db._graph("g")
    mg.fmt = "ell"              # the mesh's format: its deltas are pending
    for s, d in zip(src.tolist(), dst.tolist()):
        mg.create_edge(s, "KNOWS", d)
    mg.freeze()                                   # the base, built once
    wr = np.random.default_rng(SEED + 9)
    live = key[wr.choice(len(key), MESH_WRITES // 2, replace=False)]
    dels = [(int(k // n), int(k % n)) for k in live]
    adds = []
    keyset = set(key.tolist())
    while len(adds) < MESH_WRITES // 2:
        a, b = (int(x) for x in wr.integers(0, n, 2))
        if a * n + b not in keyset and (a, b) not in adds:
            adds.append((a, b))
    for kind, pairs in (("DELETE", dels), ("CREATE", adds)):
        for i in range(0, len(pairs), WRITE_COMMAND):
            db.query("g", f"{kind} " + ", ".join(
                f"({s})-[:KNOWS]->({d})"
                for s, d in pairs[i:i + WRITE_COMMAND]))
    view = mg.freeze()
    Ad = view.relations["KNOWS"].A
    check(isinstance(Ad.store, DeltaMatrix) and Ad.store.pending > 0,
          "mesh_database: no pending deltas before the mesh read")
    mesh = card_mesh(MESH_SHAPES[0])
    qs = [tmpl.replace("RETURN", f"WHERE id(a) = {s} RETURN")
          for s, _ in dels[:8]] + [
        "MATCH (a)-[:KNOWS*1..2]->(b) WHERE id(a) IN "
        f"[{', '.join(str(s) for s, _ in adds[:16])}] "
        "RETURN a, count(DISTINCT b)"]
    want = [db.query("g", q).rows for q in qs]
    got, dt, launched = counted(lambda: [db.query("g", q, mesh=mesh).rows
                                         for q in qs])
    check(got == want, "mesh_database: rows differ from the unsharded "
          "delta-served query")
    shard_cases("database", mesh)
    ctx = db.context("g", mesh=mesh)
    M_ = ctx.matrix("KNOWS")
    check(M_.fmt == "sharded" and isinstance(
        ctx.graph.relations["KNOWS"].A.store, ELL),
        "mesh_database: the mesh view is not compacted ELL")
    h.emit_phase(phase="mesh_database", card=card, **geometry(mesh), n=n,
                 writes=MESH_WRITES, pending=Ad.store.pending,
                 queries=len(qs), seconds=dt, rows_equal=True,
                 launches=launched["ell_mxv_packed"],
                 elapsed_s=time.perf_counter() - t0)
    del db, mg, view, Ad, ctx, M_
    h.release()

    # -- mesh_serve_bitadj: R-MAT s18 BitELL at (1, 4, 1) ---------------------
    g, _ = h.bitadj_graph(MESH_BITADJ_SCALE)
    A = serve_cell(g, "bitadj_mxv_packed", (MESH_BITADJ_SHAPE,), "bitadj")
    local_case(grb.distribute(A, card_mesh(MESH_BITADJ_SHAPE)),
               "bitadj_mxv_packed", "s18 BitELL")
    del g, A
    h.release()
    h.emit_phase(phase="mesh_total", card=card,
                 distinct_devices=len(devices),
                 launches=dict(words),
                 elapsed_s=time.perf_counter() - t_all)
    return words, shapes


def probe_cells(torch, h):
    """The paper's own workload on the card: the ``graph500_s21`` config
    (``configs.graph500``) at its published widths through the
    ``distr.graph2d`` probes (``probe_graph500``), then the graph dry-run
    (``dryrun_graph``). Each probe call is driven once with the launch
    counts at 0 and read just after, and held against ``scipy.sparse``
    oracles on the same edges; the tensors each call shards and gathers
    are recorded and held against the dry-run's layout accounting of the
    same mesh. Returns kernel 1's launches under the probes and its rows
    at the probes' shard shapes (position 0 timed, every shard-local
    handle checked bit for bit)."""
    import scipy.sparse as sp
    from repro_torch.configs.graph500 import GRAPH_CONFIG
    from repro_torch.core import bitmap
    from repro_torch.core.shard import local_map
    from repro_torch.distr import graph2d
    from repro_torch.distr import mesh as M
    from repro_torch.distr.mesh import Mesh
    from repro_torch.graph.datagen import rmat_edges
    from repro_torch.launch import dryrun

    card = h.card
    cfg = GRAPH_CONFIG
    n, deg, F, k = (cfg[a] for a in ("n_vertices", "max_deg", "queries",
                                     "k"))
    scale = n.bit_length() - 1
    t_all = time.perf_counter()

    # -- the data: R-MAT in-neighbours, each row's first deg by source id ---
    t0 = time.perf_counter()
    src, dst, _ = rmat_edges(scale, PROBE_EDGE_FACTOR, PROBE_SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generated = len(src)
    # rows by dst, then src, duplicates dropped: a sort, since np.unique
    # of these 33.5 M keys took 103.5 s on the card's host (numpy 2.3.5;
    # the sort 0.57 s)
    key = np.sort(dst * n + src)
    key = key[np.concatenate([[True], key[1:] != key[:-1]])]
    del src, dst
    d, s_ = key // n, key % n
    in_deg = np.bincount(d, minlength=n)
    starts = np.zeros(n + 1, dtype=np.int64)
    starts[1:] = np.cumsum(in_deg)
    pos = np.arange(len(key)) - starts[d]         # slot within the row
    keep = pos < deg
    slot = pos[keep]
    d, s_ = d[keep], s_[keep]
    idx = np.zeros((n, deg), dtype=np.int32)
    msk = np.zeros((n, deg), dtype=bool)
    idx[d, slot] = s_
    msk[d, slot] = True
    out_deg = np.bincount(s_, minlength=n)
    seeds = np.random.default_rng(PROBE_SEED).choice(
        np.nonzero(out_deg >= 1)[0], F, replace=False)
    layout_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx_d = torch.from_numpy(idx).to(DEVICE)
    msk_d = torch.from_numpy(msk).to(DEVICE)
    idx_s = torch.where(msk_d, idx_d, n)
    fr_d = torch.zeros((n, F), dtype=torch.int8, device=DEVICE)
    fr_d[torch.from_numpy(seeds).to(DEVICE),
         torch.arange(F, device=DEVICE)] = 1
    deg_d = torch.from_numpy(out_deg.astype(np.float32)).to(DEVICE)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del idx, msk, slot, pos

    # -- the oracles: k hops of scipy products, float64 PageRank ------------
    t0 = time.perf_counter()
    A = sp.csr_matrix((np.ones(len(d), np.float64), (d, s_)), shape=(n, n))
    front = sp.csc_matrix((np.ones(F), (seeds, np.arange(F))), shape=(n, F))
    seen = front.copy()
    for _ in range(k):
        reach = A @ front
        reach.data[:] = 1
        front = reach - reach.multiply(seen)
        front.eliminate_zeros()
        seen = seen + front
    want = np.asarray(seen.sum(axis=0)).ravel().astype(np.int64) - 1
    rank = np.full(n, 1.0 / n)
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1), 0.0)
    for _ in range(PROBE_PR_ITERS):
        rank = (1.0 - 0.85) / n + 0.85 * (A @ (rank * inv)
                                          + rank[out_deg == 0].sum() / n)
    oracle_s = time.perf_counter() - t0
    h.emit_phase(phase="probe_graph500_data", card=card, config=cfg["name"],
                 scale=scale, n=n, max_deg=deg, queries=F, k=k,
                 edge_factor=PROBE_EDGE_FACTOR, edges_generated=generated,
                 edges_distinct=len(key), edges_kept=int(keep.sum()),
                 dropped_edge_share=1.0 - float(keep.mean()),
                 truncated_row_share=float((in_deg > deg).mean()),
                 rows_without_in_edges=float((in_deg == 0).mean()),
                 count_mean=float(want.mean()), count_max=int(want.max()),
                 generate_s=gen_s, layout_s=layout_s, upload_s=upload_s,
                 oracle_s=oracle_s)
    del key, keep, d, s_, A, front, seen, reach

    def card_mesh(shape, names):
        return Mesh(np.array([torch.device(DEVICE)] * int(np.prod(shape)),
                             dtype=object).reshape(shape), names)

    ran = {}            # (id(shard-local handle), W) -> (handle, W)
    held = {"shard": [], "gather": []}

    def counted(fn):
        """(fn(), seconds, kernel 1's launches, the position-0 bytes of
        every block the call sharded and gathered) with the launch counts
        at 0 just before; each (shard-local handle, word width) the call
        hands the word product is kept in ``ran``."""
        real = (M.shard, M.all_gather, graph2d._words)

        def shard(mesh, x, spec):
            out = real[0](mesh, x, spec)
            held["shard"].append(out[0].nbytes)
            return out

        def gather(mesh, xs, axis):
            out = real[1](mesh, xs, axis)
            held["gather"].append(out[0].nbytes)
            return out

        def words(local, xg):
            ran.setdefault((id(local), xg.shape[1]), (local, xg.shape[1]))
            return real[2](local, xg)

        held["shard"], held["gather"] = [], []
        h.zero_launches()
        torch.cuda.synchronize()
        M.shard, M.all_gather, graph2d._words = shard, gather, words
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            M.shard, M.all_gather, graph2d._words = real
        return out, dt, h.launches_now()["ell_mxv_packed"], dict(held)

    words_total, shapes, layout = 0, {"shards": []}, []
    mesh42 = card_mesh((4, 2), ("data", "model"))
    runs = [("khop", mesh42, False, False),
            ("khop_bitmap", mesh42, True, False),
            ("khop_bitmap_sentinel", mesh42, True, True),
            ("khop_bitmap", card_mesh((2, 2, 2), ("pod", "data", "model")),
             True, False)]
    for kind, mesh, packed, sentinel in runs:
        t0 = time.perf_counter()
        tag = f"{kind} {tuple(mesh.shape.values())}"
        args = (idx_s if sentinel else idx_d, msk_d, fr_d)

        def probe(hops):
            return graph2d.khop_counts_2d(mesh, n, hops, packed=packed,
                                          sentinel=sentinel)(*args)

        got, dt, launched, seen_ = counted(lambda: probe(k))
        need = mesh.size * k if packed else 0
        check(launched == need, f"probe {tag}: ell_mxv_packed launched "
              f"{launched} times, not {need}")
        words_total += launched
        got = got.cpu().numpy()
        check(got.shape == (F,) and np.array_equal(got, want),
              f"probe {tag}: {int((got != want).sum())} of {F} counts "
              f"differ from the scipy oracle")
        if mesh is mesh42 and not sentinel:
            layout.append((kind, dryrun.khop_layout(
                mesh, n, deg, F, k, packed=packed), seen_))
        # one hop's parts on the call's own layout: the frontier's
        # all-gather, the local pull at position 0, and the whole hop
        # (gather, every position's pull, and-not visited, or)
        call_ms = wall_ms(torch, lambda: probe(k))
        spec = graph2d.shardings_2d(mesh, n, deg, F)
        rows_l = M.shard(mesh, args[0], spec[0])
        msk_l = M.shard(mesh, msk_d, spec[1])
        seeds_l = M.shard(mesh, fr_d, spec[2])
        fr_l = [bitmap.pack(x) for x in seeds_l] if packed else seeds_l
        f_l = seeds_l[0].shape[1]
        if packed:
            local = local_map(
                lambda i, m: graph2d._probe_ell(i, m, n, sentinel),
                rows_l, msk_l)

            def pull(x_full):
                if sentinel:
                    x_full = local_map(graph2d._zero_row, x_full)
                return [bitmap.word_andnot(graph2d._words(e, x), v)
                        for e, x, v in zip(local, x_full, fr_l)]
        else:
            def pull(x_full):
                return [graph2d._gather_max(i, m, x).masked_fill_(v > 0, 0)
                        for i, m, x, v in zip(rows_l, msk_l, x_full, fr_l)]

        def hop():
            nxt = pull(M.all_gather(mesh, fr_l, "data"))
            return [(bitmap.word_or if packed else torch.maximum)(v, y)
                    for v, y in zip(fr_l, nxt)]

        xg = M.all_gather(mesh, fr_l, "data")
        gather_ms = time_ms(torch, lambda: M.all_gather(mesh, fr_l, "data"))
        hop_ms = time_ms(torch, hop, reps=10 if packed else 3, warmup=1)
        rec = dict(tag=tag, kind=kind, F_l=f_l, call_ms=call_ms,
                   hop_ms=hop_ms, gather_ms=gather_ms,
                   allgather_bytes_per_position=seen_["gather"][0],
                   int8_bytes_per_position=n * f_l,
                   float32_bytes_per_position=n * f_l * 4)
        if packed:
            cases = list(ran.values())
            ran.clear()
            local0, w = cases[0]              # position 0's handle
            row = h.ell_case(local0, w, f"probe {tag} position 0 local "
                             f"{tuple(local0.shape)}", timed=True,
                             earlier=False)
            for local_, w_ in cases[1:]:
                h.ell_case(local_, w_, f"probe {tag} shard "
                           f"{tuple(local_.shape)}", timed=False)
            for local_, w_ in cases:
                shapes["shards"].append(dict(tag=tag, shape=list(
                    local_.shape), W=w_, nnz=local_.nnz, equal=True))
            check(len(cases) == mesh.shape["data"],
                  f"probe {tag}: {len(cases)} shard handles ran, not one "
                  f"per row block ({mesh.shape['data']})")
            shapes[tag] = {key_: row[key_] for key_ in (
                "shape", "W", "equal", "max_abs_err", "kernel_ms",
                "loop_ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
                "items", "split_rows", "longest_row")}
            rec.update(local_ms=row["kernel_ms"],
                       bytes_vs_int8=n * f_l / seen_["gather"][0],
                       bytes_vs_float32=4 * n * f_l / seen_["gather"][0])
            del local, cases, local0
        else:
            rec["local_ms"] = time_ms(torch, lambda: graph2d._gather_max(
                rows_l[0], msk_l[0], xg[0]), reps=3, warmup=1)
        del xg, fr_l, seeds_l, rows_l, msk_l
        h.emit_phase(phase="probe_graph500", card=card,
                     mesh=dict(mesh.shape), positions=mesh.size,
                     distinct_devices=mesh.distinct_devices, n=n,
                     max_deg=deg, queries=F, k=k, seconds=dt,
                     launches={"ell_mxv_packed": launched},
                     launches_needed=need, counts_equal_oracle=True, **rec,
                     elapsed_s=time.perf_counter() - t0)

    # -- PageRank, float32 and bfloat16 push, on (4, 2) --------------------
    for name, pd in (("float32", None), ("bfloat16", torch.bfloat16)):
        t0 = time.perf_counter()
        fn = graph2d.pagerank_2d(mesh42, n, PROBE_PR_ITERS, push_dtype=pd)
        ranks, dt, launched, seen_ = counted(
            lambda: fn(idx_d, msk_d, deg_d))
        got = ranks.cpu().numpy().astype(np.float64)
        check(got.shape == (n,) and np.isfinite(got).all(),
              f"probe pagerank {name}: shape {got.shape} or non-finite")
        l1 = float(np.abs(got - rank).sum())
        if pd is None:
            check(l1 <= 1e-5, f"probe pagerank float32: L1 {l1} > 1e-5 "
                  f"against the float64 oracle")
        layout.append((f"pagerank {name}", dryrun.pagerank_layout(
            mesh42, n, deg, PROBE_PR_ITERS, push_dtype=pd), seen_))
        h.emit_phase(phase="probe_graph500_pagerank", card=card,
                     mesh=dict(mesh42.shape), positions=mesh42.size,
                     distinct_devices=mesh42.distinct_devices, push=name,
                     iters=PROBE_PR_ITERS, seconds=dt, l1=l1,
                     allgather_bytes_per_position=seen_["gather"][0],
                     call_ms=wall_ms(torch, lambda: fn(idx_d, msk_d, deg_d)),
                     elapsed_s=time.perf_counter() - t0)
    del idx_d, msk_d, idx_s, fr_d, deg_d, ranks
    h.release()

    # -- dryrun_graph: the 16 layout cells, and the one-card accounting ----
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "experiments", "dryrun_graph")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--graph", "--mesh", "both", "--out", out_dir],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    check(r.returncode == 0, f"dryrun_graph: exit {r.returncode}: "
          f"{r.stderr[-2000:]}")
    cells = sorted(f for f in os.listdir(out_dir) if f.endswith(".json"))
    check(len(cells) == 16, f"dryrun_graph: {len(cells)} cells, not 16")
    for name in cells:
        with open(os.path.join(out_dir, name)) as f:
            c = json.load(f)
        check(c["status"] == "ok" and not c["layout_only"]
              and c["cost"]["bytes_per_device"] > 0,
              f"dryrun_graph: {name} not ok or not counted")
        h.emit_phase(phase="dryrun_graph", card=card, cell=c["cell"],
                     positions=c["positions"],
                     argument_bytes_per_position=c[
                         "argument_bytes_per_position"],
                     output_bytes_per_position=c["output_bytes_per_position"],
                     gathered_bytes_per_position=c[
                         "gathered_bytes_per_position"],
                     collectives=c["collectives"], cost=c["cost"],
                     memory=c["memory"], roofline=c["roofline"],
                     fits_hbm=c["fits_hbm"], hbm=c["card"],
                     layout_only=False)
    for kind, rec, seen_ in layout:
        check(sum(seen_["shard"]) == rec["argument_bytes_per_position"]
              and set(seen_["gather"]) == {rec["gathered_bytes_per_position"]}
              and len(seen_["gather"]) == rec["collectives"]["all-gather"][
                  "count"],
              f"dryrun_graph: the (4, 2) accounting of {kind} "
              f"(arguments {rec['argument_bytes_per_position']}, gathered "
              f"{rec['gathered_bytes_per_position']}) differs from the "
              f"tensors the probe held ({sum(seen_['shard'])}, "
              f"{sorted(set(seen_['gather']))})")
    h.emit_phase(phase="dryrun_graph_total", card=card, cells=len(cells),
                 one_card_checked=[kind for kind, _, _ in layout],
                 one_card_equal=True, elapsed_s=time.perf_counter() - t0,
                 probe_elapsed_s=time.perf_counter() - t_all)
    return words_total, shapes


def model_cells(torch, h):
    """The models' serving path on the card (``repro_torch.models``,
    ``serve.serve_step``, ``launch.serve``). No TPU kernel lies on it: the
    JAX models compute in XLA, and the port's in plain torch.

    ``models_parity``: every arch at the serve entry point's tiny config,
    float32 (TF32 off), params from one seeded init on the CPU copied to the
    card: the prefill logits and MODEL_PARITY_STEPS decode steps equal the
    same calls on the CPU within 1e-4, and the decode steps equal one
    forward over the same tokens (``models.forward_reference``: moe at a
    capacity that drops nothing, as no decode step drops) within 1e-4.

    ``serve_qwen2``: qwen2-1.5b at its published widths and depth, bfloat16,
    through ``launch.serve.main`` with ``--tiny 0`` (a seeded init on the
    card) at each of SERVE_RUNS, twice each (the tokens must repeat); every
    token in the vocabulary; tokens/s, ms a decode step against the step's
    bound, the prefill's ms and the peak memory. Then teacher-forced decode
    over a SERVE_CHECK_PREFIX-token prefix against one forward (both also
    against the float32 forward of the same weights, printed), and
    PROFILED_STEPS decode steps under ``torch.profiler``: kernel launches
    and device-busy ms a step against its wall time.

    ``models_widths``: every other arch at its published widths, bfloat16,
    depth cut (WIDTH_LAYERS, else 2 layers): a WIDTHS_PROMPT-token prefill,
    teacher-forced decode over the prompt against one forward, then
    WIDTHS_STEPS greedy steps; every logit finite.

    The bfloat16 comparisons hold the largest logit difference under
    BF16_REL_TOL of the largest logit: each bfloat16 product rounds its
    output to 8 bits (2^-9 relative), and a decode step's products (one row
    a sequence) and the forward's (S rows) take other cuBLAS reductions, so
    one ulp differences enter at every layer and carry to the logits, which
    are themselves rounded to bfloat16 before the float32 cast. How far
    that goes is measured against the float32 forward of the same weights:
    on an H100 80GB HBM3 at 700 W, qwen2-1.5b's bfloat16 forward lands 3.0%
    of the largest logit from it, its decode steps 3.2%, and the two 2.6%
    from each other; both bfloat16 paths are held to BF16_REL_TOL of the
    float32 forward too."""
    import copy
    import dataclasses
    from repro_torch.configs.base import ARCHS, get_config
    from repro_torch.launch import serve
    from repro_torch.models import forward_reference, get_model
    from repro_torch.models.base import map_specs, zeros_from_specs
    from repro_torch.serve.serve_step import (decode_greedy, make_serve_step,
                                              teacher_forced_logits)
    card = h.card
    t_all = time.perf_counter()

    def batch_of(cfg, B, S, seed, device):
        rng = np.random.default_rng(seed)
        b = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                       dtype=torch.int32, device=device)}
        if cfg.family == "whisper":
            b["frames"] = torch.as_tensor(rng.normal(size=(
                B, cfg.n_audio_frames, cfg.d_frontend)), dtype=torch.float32,
                device=device)
        if cfg.family == "llava":
            b["patches"] = torch.as_tensor(rng.normal(size=(
                B, cfg.n_image_tokens, cfg.d_frontend)), dtype=torch.float32,
                device=device)
        return b

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    # -- models_parity: tiny configs, the card against the CPU ---------------
    t0 = time.perf_counter()
    for i, name in enumerate(ARCHS):
        cfg = serve.tiny_config(get_config(name))
        model = get_model(cfg)
        on_cpu = model.init(0, "cpu")
        on_card = model.init(0, "cpu").to(DEVICE)
        b = batch_of(cfg, 2, MODEL_PARITY_STEPS, 100 + i, "cpu")
        bc = {k: v.to(DEVICE) for k, v in b.items()}
        want, _ = model.prefill_fn(on_cpu, b)
        got, _ = model.prefill_fn(on_card, bc)
        check(got.device.type == torch.device(DEVICE).type,
              f"models_parity {name}: prefill left the card")
        e_prefill = abs_err(got.cpu(), want)
        cc = zeros_from_specs(model.cache_specs(2, MODEL_PARITY_STEPS), "cpu")
        gc_ = zeros_from_specs(model.cache_specs(2, MODEL_PARITY_STEPS),
                               DEVICE)
        e_decode, steps = 0.0, []
        for pos in range(MODEL_PARITY_STEPS):
            tok = b["tokens"][:, pos:pos + 1]
            want, cc = model.decode_fn(on_cpu, cc, {"tokens": tok}, pos)
            got, gc_ = model.decode_fn(on_card, gc_,
                                       {"tokens": tok.to(DEVICE)}, pos)
            e_decode = max(e_decode, abs_err(got.cpu(), want))
            steps.append(got[:, 0])
        ref = forward_reference(cfg).logits_fn(on_card,
                                               {"tokens": bc["tokens"]})
        e_fwd = abs_err(torch.stack(steps, dim=1), ref)
        check(max(e_prefill, e_decode, e_fwd) <= 1e-4,
              f"models_parity {name}: prefill {e_prefill}, decode "
              f"{e_decode}, decode against forward {e_fwd} (atol 1e-4)")
        h.emit_phase(phase="models_parity", card=card, arch=name,
                     family=cfg.family, dtype=cfg.dtype,
                     steps=MODEL_PARITY_STEPS, prefill_err=e_prefill,
                     decode_err=e_decode, decode_vs_forward_err=e_fwd,
                     atol=1e-4)
        del on_cpu, on_card, cc, gc_
    h.emit_phase(phase="models_parity_total", card=card, archs=len(ARCHS),
                 elapsed_s=time.perf_counter() - t0)

    # -- serve_qwen2: qwen2-1.5b at its published size ------------------------
    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    specs = get_model(cfg).param_specs()
    leaves = []
    map_specs(lambda _, s: leaves.append(s), specs)
    el = torch.tensor([], dtype=specs["ln_f"].dtype).element_size()
    param_bytes = sum(int(np.prod(s.shape)) for s in leaves) * el
    tok_bytes = cfg.vocab * cfg.d_model * el
    dense_params = (sum(int(np.prod(s.shape)) for s in leaves if
                        len(s.shape) == 2) - cfg.vocab * cfg.d_model)
    slot_bytes = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * el
    for B, P, N in SERVE_RUNS:
        argv = ["--arch", "qwen2-1.5b", "--tiny", "0", "--batch", str(B),
                "--prompt-len", str(P), "--max-new", str(N)]
        torch.cuda.reset_peak_memory_stats()
        res = serve.main(argv)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        again = serve.main(argv)
        toks = res.tokens
        check(toks.device.type == torch.device(DEVICE).type
              and tuple(toks.shape) == (B, N),
              f"serve_qwen2: tokens {tuple(toks.shape)} on {toks.device}")
        check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
              "serve_qwen2: a token outside the vocabulary")
        check(torch.equal(toks, again.tokens),
              f"serve_qwen2 batch {B}: two runs from seed 0 differ")
        # the decode step's least time: its weights (the token table only
        # for the B rows it gathers), the cache slots filled at the mean
        # decode position (read) and one slot (written), the logits
        # written; its operations: the products over those weights and the
        # attention over the filled slots
        steps = N - 1
        filled = P + 1 + (steps - 1) / 2
        nbytes = (param_bytes - tok_bytes + B * cfg.d_model * el
                  + B * filled * slot_bytes + B * slot_bytes
                  + B * cfg.vocab * 4)
        nops = (2 * B * dense_params + 4 * B * cfg.n_layers * cfg.n_heads
                * cfg.head_dim * filled)
        bound_ms, bound_by = bound(nbytes, nops, BF16_FLOPS_PER_S)
        step_ms = res.decode_ms / steps
        h.emit_phase(
            phase="serve_qwen2", card=card, arch=cfg.name, dtype=cfg.dtype,
            layers=cfg.n_layers, d_model=cfg.d_model, batch=B,
            prompt_len=P, new_tokens=N, tokens_per_s=res.tokens_per_s,
            decode_tokens_per_s=B * steps / (res.decode_ms / 1e3),
            decode_ms_per_step=step_ms, decode_steps=steps,
            prefill_ms=res.prefill_ms, prefill_ms_per_token=res.prefill_ms
            / P, step_bound_ms=bound_ms, step_bound_by=bound_by,
            step_bytes=nbytes, step_ops=nops, weight_bytes=param_bytes,
            cache_bytes=B * (P + N) * slot_bytes,
            step_over_bound=step_ms / bound_ms, deterministic=True,
            in_vocab=True, peak_run_gb=peak_gb)
        del res, again
        h.release()
    # teacher-forced decode over a prefix against one forward, both against
    # the float32 forward of the same weights
    model = get_model(cfg)
    params = model.init(0, DEVICE)
    tokens = batch_of(cfg, 4, SERVE_CHECK_PREFIX, 0, DEVICE)["tokens"]
    (tf, cache), tf_s = sync_s(lambda: teacher_forced_logits(
        model, params, tokens, SERVE_CHECK_PREFIX + 2 * PROFILED_STEPS))
    ref, fwd_s = sync_s(lambda: model.logits_fn(params, {"tokens": tokens}))
    r = rel(tf, ref)
    check(bool(torch.isfinite(tf).all()) and r <= BF16_REL_TOL,
          f"serve_qwen2: decode against forward {r} of the largest logit "
          f"(limit {BF16_REL_TOL})")
    ref32 = get_model(dataclasses.replace(cfg, dtype="float32")).logits_fn(
        copy.deepcopy(params).float(), {"tokens": tokens})
    r_tf32, r_fwd32 = rel(tf, ref32), rel(ref, ref32)
    check(max(r_tf32, r_fwd32) <= BF16_REL_TOL,
          f"serve_qwen2: against the float32 forward, decode {r_tf32} and "
          f"forward {r_fwd32} of the largest logit (limit {BF16_REL_TOL})")
    # where a decode step's time goes: PROFILED_STEPS steps timed, then as
    # many under the profiler, device time summed over their kernels
    busy_ms = launches = None
    step = make_serve_step(model)
    tok = tf[:, -1].argmax(-1).to(torch.int32)[:, None]

    def steps(first):
        nonlocal tok, cache
        for pos in range(first, first + PROFILED_STEPS):
            nxt, cache = step(params, cache, {"tokens": tok}, pos)
            tok = nxt[:, None]

    _, plain_s = sync_s(lambda: steps(SERVE_CHECK_PREFIX))
    wall_ms = 1e3 * plain_s / PROFILED_STEPS
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, prof_s = sync_s(lambda: steps(SERVE_CHECK_PREFIX
                                         + PROFILED_STEPS))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:
        busy_us = sum(e.self_device_time_total
                      if hasattr(e, "self_device_time_total")
                      else e.self_cuda_time_total for e in kernels)
        busy_ms = busy_us / 1e3 / PROFILED_STEPS
        launches = len(kernels) / PROFILED_STEPS
    decode_cost_check(torch, h, model, params, cache, tok,
                      SERVE_CHECK_PREFIX + 2 * PROFILED_STEPS, wall_ms)
    h.emit_phase(phase="serve_qwen2_check", card=card, batch=4,
                 prefix=SERVE_CHECK_PREFIX, max_abs_err=float(
                     (tf - ref).abs().max()), mean_abs_err=float(
                     (tf - ref).abs().mean()), max_abs_logit=float(
                     ref.abs().max()), rel_err=r, rel_tol=BF16_REL_TOL,
                 argmax_agree=float((tf.argmax(-1) == ref.argmax(-1))
                                    .float().mean()),
                 decode_vs_float32_rel_err=r_tf32,
                 forward_vs_float32_rel_err=r_fwd32,
                 teacher_forced_s=tf_s, forward_s=fwd_s,
                 profiled_steps=PROFILED_STEPS, step_wall_ms=wall_ms,
                 step_profiled_wall_ms=1e3 * prof_s / PROFILED_STEPS,
                 step_device_busy_ms=busy_ms, step_kernel_launches=launches,
                 device_idle_share=None if busy_ms is None
                 else 1 - busy_ms / wall_ms,
                 elapsed_s=time.perf_counter() - t0)
    del model, params, tf, ref, ref32, cache, prof
    h.release()

    # -- models_widths: every other arch at its published widths -------------
    t0 = time.perf_counter()
    for i, name in enumerate(ARCHS):
        if name == "qwen2-1.5b":
            continue
        base = get_config(name)
        cut = WIDTH_LAYERS.get(name, {"n_layers": 2})
        cfg = dataclasses.replace(base, **cut)
        model = get_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params, init_s = sync_s(lambda: model.init(0, DEVICE))
        b = batch_of(cfg, 2, WIDTHS_PROMPT, 200 + i, DEVICE)
        (pre, _), prefill_s = sync_s(lambda: model.prefill_fn(params, b))
        cache_len = WIDTHS_PROMPT + WIDTHS_STEPS + 1
        (tf, cache), tf_s = sync_s(lambda: teacher_forced_logits(
            model, params, b["tokens"], cache_len))
        ref = forward_reference(cfg).logits_fn(params,
                                               {"tokens": b["tokens"]})
        r = rel(tf, ref)
        out, greedy_s = sync_s(lambda: decode_greedy(
            model, params, tf[:, -1:], cache, WIDTHS_PROMPT,
            WIDTHS_STEPS + 1))
        finite = bool(torch.isfinite(pre).all() and torch.isfinite(tf).all()
                      and torch.isfinite(ref).all())
        check(finite, f"models_widths {name}: a logit is not finite")
        check(r <= BF16_REL_TOL, f"models_widths {name}: decode against "
              f"forward {r} of the largest logit (limit {BF16_REL_TOL})")
        check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab,
              f"models_widths {name}: a token outside the vocabulary")
        h.emit_phase(
            phase="models_widths", card=card, arch=name, family=cfg.family,
            dtype=cfg.dtype, layers=cfg.n_layers,
            published_layers=base.n_layers,
            encoder_layers=cfg.encoder_layers or None, d_model=cfg.d_model,
            vocab=cfg.vocab, batch=2, prompt_len=WIDTHS_PROMPT,
            params=sum(p_.numel() for p_ in params.parameters()),
            init_s=init_s, prefill_ms=1e3 * prefill_s,
            teacher_forced_ms_per_step=1e3 * tf_s / WIDTHS_PROMPT,
            decode_ms_per_step=1e3 * greedy_s / WIDTHS_STEPS,
            decode_steps=WIDTHS_STEPS, max_abs_err=float(
                (tf - ref).abs().max()), max_abs_logit=float(
                ref.abs().max()), rel_err=r, rel_tol=BF16_REL_TOL,
            finite=finite, peak_run_gb=torch.cuda.max_memory_allocated()
            / 1e9)
        del model, params, pre, tf, cache, ref, out
        h.release()
    h.emit_phase(phase="models_total", card=card,
                 widths_elapsed_s=time.perf_counter() - t0,
                 elapsed_s=time.perf_counter() - t_all)


def train_cells(torch, h):
    """The training path on the card (``repro_torch.train``,
    ``distr.compression``, the models' ``loss_fn``, ``launch.train``). No
    TPU kernel lies on it: the JAX package computes loss, backward and
    update in XLA, the port in plain torch with autograd.

    ``train_parity``: every arch at the serve entry point's tiny config,
    float32 (TF32 off), params from one seeded init on the CPU copied to
    the card, batches from ``train.data``'s stream: the loss and every
    gradient leaf, then TRAIN_PARITY_STEPS steps of the arch's optimizer
    (AdamW; Adafactor for llama4), TRAIN_PARITY_DENSE with microbatches=2
    and int8 compression, each step's loss and the params after them held
    to the CPU's. Tolerances: the loss within 1e-5 (the steps' losses
    1e-4); a gradient leaf within 1e-5 plus 1e-4 of its largest CPU value;
    the params within 1% of TRAIN_PARITY_LR a step, but for at most 1e-4
    of them, each within 2 lr a step. Adam's step m / sqrt(v) does not
    scale with the gradient, so an element whose gradient is at rounding
    level (a near-zero true gradient) steps by the sign and ratio of that
    rounding, which the two devices' sums order differently; under int8
    compression a gradient within rounding of a half step of the scale
    also takes the neighbouring code on one device. The line prints how
    many elements passed the 1% and their first step's gradient against
    their leaf's largest (rounding level, about 1e-7 of it). llama4 routes
    top-1: its routing weight p / p is 1, so its router's gradient is
    rounding (held under 1e-8) and Adafactor's first step, g / |g|, moves
    it by that rounding's sign (held to 2 lr; the arch takes one step: the
    next would route on the moved router).

    ``train_qwen2``: qwen2-1.5b at its published widths and depth,
    bfloat16, AdamW, remat on, through ``launch.train.run`` (``main``'s
    body) with ``--tiny 0 --batch TRAIN_BATCH --seq TRAIN_SEQ --steps
    TRAIN_SAVED_AT``: the loss a step (finite), each step's ms and
    tokens/s (host clock, synchronised) against the step's operations at
    the bfloat16 peak, the peak memory. Then one checkpoint of the params
    and the optimizer state (``train.checkpoint.AsyncCheckpointer``) in a
    directory of the checkout: its host-copy and write seconds and bytes; a
    restore into a fresh state (seed 1), held to the saved state bit for
    bit; the last TRAIN_STEPS - TRAIN_SAVED_AT steps of the same schedule
    from the saved state (uninterrupted) and from the restored one
    (resumed), their losses within TRAIN_RESUME_RTOL (the first resumed
    step sees bit-equal inputs; backward's atomic adds may order sums
    otherwise after it); the loss falling: each of those four steps lowers
    its own batch's loss (a fresh batch's loss falls only about 0.02 in
    the 12 steps, inside one batch's noise; printed, first against last);
    one more step under ``torch.profiler``: kernel
    launches and device-busy ms against the step's wall time. The
    directory is removed afterwards; a disk that cannot hold the
    checkpoint fails the phase."""
    import shutil
    import tempfile
    from repro_torch.configs.base import ARCHS, ShapeConfig, get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import get_model, jax_leaves
    from repro_torch.models.base import tree_leaves, tree_unflatten
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.data import synthetic_batch, to_device
    from repro_torch.train.train_step import make_train_step
    card = h.card
    t_all = time.perf_counter()

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def grads_of(model, params, batch):
        params.requires_grad_(True)
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return float(loss.detach()), jax_leaves(tree_unflatten(params, grads))

    # -- train_parity: tiny configs, the card against the CPU -----------------
    t0 = time.perf_counter()
    B, S = TRAIN_PARITY_SHAPE
    shape = ShapeConfig("parity", S, B, "train")
    lr = TRAIN_PARITY_LR
    for i, name in enumerate(ARCHS):
        cfg = serve.tiny_config(get_config(name))
        model = get_model(cfg)
        on_cpu = model.init(0, "cpu")
        on_card = model.init(0, "cpu").to(DEVICE)
        batch = synthetic_batch(cfg, shape, 200)        # the first step's
        l_cpu, g_cpu = grads_of(model, on_cpu, to_device(batch, "cpu"))
        l_card, g_card = grads_of(model, on_card, to_device(batch, DEVICE))
        e_loss = abs(l_card - l_cpu)
        g_ratio, router_grad = 0.0, None
        for (path, gc_, _), (_, gg, _) in zip(g_cpu, g_card):
            for c, g in zip(gc_, gg):
                check(g.device.type == torch.device(DEVICE).type,
                      f"train_parity {name}: a gradient left the card")
                g_ratio = max(g_ratio, abs_err(g.cpu(), c)
                              / (1e-5 + 1e-4 * float(c.abs().max())))
            if path.endswith("['router']"):
                router_grad = max(float(x.abs().max()) for x in gc_ + [
                    y.cpu() for y in gg])
        check(e_loss <= 1e-5 and g_ratio <= 1.0,
              f"train_parity {name}: loss {e_loss} (atol 1e-5), gradients "
              f"{g_ratio} of their tolerance")
        top1 = cfg.family == "moe" and cfg.experts_per_token == 1
        if top1:
            check(router_grad <= 1e-8, f"train_parity {name}: the top-1 "
                  f"router's gradient {router_grad} is not rounding")
        kw = ({"microbatches": 2, "compress_grads": True}
              if name == TRAIN_PARITY_DENSE else {})
        steps = 1 if top1 else TRAIN_PARITY_STEPS
        opt_cfg = opt_mod.OptConfig(name=cfg.optimizer, lr=lr,
                                    warmup_steps=1, total_steps=steps)
        losses = {}
        for dev, params in (("cpu", on_cpu), (DEVICE, on_card)):
            step_fn = make_train_step(model, opt_cfg, **kw)
            state = opt_mod.init_fn(cfg.optimizer)(params)
            err, losses[dev] = None, []
            for k in range(steps):
                b = to_device(synthetic_batch(cfg, shape, 200 + k), dev)
                if kw:
                    params, state, m, err = step_fn(params, state, b, err)
                else:
                    params, state, m = step_fn(params, state, b)
                losses[dev].append(float(m["loss"]))
        e_steps = max(abs(a - b) for a, b in zip(losses[DEVICE],
                                                  losses["cpu"]))
        atol = 0.01 * lr * steps
        worst, past, numel, router_moved = 0.0, 0, 0, None
        # the first step's gradient of the elements past atol, over their
        # leaf's largest
        past_grad = 0.0
        for (path, pc, _), (_, pg, _), (_, gc_, _) in zip(
                jax_leaves(on_cpu), jax_leaves(on_card), g_cpu):
            d = torch.cat([(a.detach() - b.detach().cpu()).abs().flatten()
                           for a, b in zip(pc, pg)])
            if top1 and path.endswith("['router']"):
                router_moved = float(d.max())
                continue
            worst = max(worst, float(d.max()))
            out = d > atol
            past += int(out.sum())
            numel += d.numel()
            if out.any():
                g0 = torch.cat([g.abs().flatten() for g in gc_])
                past_grad = max(past_grad, float(
                    g0[out].max() / torch.clamp(g0.max(), min=1e-30)))
        allowed = int(1e-4 * numel)
        check(e_steps <= 1e-4 and past <= allowed
              and worst <= 2 * lr * steps,
              f"train_parity {name}: step losses {e_steps} (atol 1e-4), "
              f"{past} params past {atol} (allowed {allowed}), largest "
              f"{worst}")
        if top1:
            check(router_moved <= 2 * lr * 1.001,
                  f"train_parity {name}: router moved {router_moved}")
        h.emit_phase(phase="train_parity", card=card, arch=name,
                     family=cfg.family, dtype=cfg.dtype,
                     optimizer=cfg.optimizer, steps=steps, lr=lr,
                     microbatches=kw.get("microbatches", 1),
                     compress_grads=bool(kw), loss_err=e_loss,
                     grad_err_over_tol=g_ratio, step_losses=losses[DEVICE],
                     step_loss_err=e_steps, params_max_err=worst,
                     params_atol=atol, params_past_atol=past,
                     params_past_allowed=allowed, params=numel,
                     past_grad_rel=past_grad if past else None,
                     router_grad=router_grad, router_moved=router_moved)
        del on_cpu, on_card
    h.emit_phase(phase="train_parity_total", card=card, archs=len(ARCHS),
                 elapsed_s=time.perf_counter() - t0)

    # -- train_qwen2: qwen2-1.5b at its published size -------------------------
    t0 = time.perf_counter()
    argv = ["--arch", "qwen2-1.5b", "--tiny", "0", "--device", DEVICE,
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    cfg = get_config("qwen2-1.5b")
    model = get_model(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.reset_peak_memory_stats()
    run = train.run(argv + ["--steps", str(TRAIN_SAVED_AT)])
    torch.cuda.synchronize()
    peak_run_gb = torch.cuda.max_memory_allocated() / 1e9
    params, state = run.params, run.opt_state
    check(all(np.isfinite(run.losses)),
          f"train_qwen2: losses {run.losses} not finite")
    leaves = tree_leaves((params, state))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    n_params = sum(p.numel() for p in params.parameters())
    # the step's least time: its products' operations at the bfloat16 peak
    # (forward and backward: 6 per weight a token, the token table a
    # lookup; attention's QK and PV over every position pair)
    mm_params = n_params - cfg.vocab * cfg.d_model
    nops = (6 * mm_params * tokens + 12 * cfg.n_layers * TRAIN_BATCH
            * TRAIN_SEQ ** 2 * cfg.n_heads * cfg.head_dim)
    bound_ms, bound_by = bound(state_bytes, nops, BF16_FLOPS_PER_S)

    ckdir = tempfile.mkdtemp(prefix=".train_ckpt_", dir=ROOT)
    try:
        free = shutil.disk_usage(ckdir).free
        check(free >= 1.05 * state_bytes,
              f"train_qwen2: {free / 1e9:.1f} GB free on the checkout's "
              f"disk; one checkpoint takes {state_bytes / 1e9:.1f} GB")
        writer = ckpt.AsyncCheckpointer(ckdir, keep=1)
        _, host_s = sync_s(lambda: writer.save((params, state),
                                               TRAIN_SAVED_AT))
        t1 = time.perf_counter()
        writer.wait()
        write_s = time.perf_counter() - t1
        step_dir = os.path.join(ckdir, f"step_{TRAIN_SAVED_AT}")
        ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                       for f in os.listdir(step_dir))
        fresh = model.init(1, DEVICE)
        fresh_state = opt_mod.init_fn(cfg.optimizer)(fresh)
        (_, at), restore_s = sync_s(lambda: ckpt.restore(
            (fresh, fresh_state), ckdir))
        equal = at == TRAIN_SAVED_AT and all(
            torch.equal(a, b) for a, b in zip(
                leaves, tree_leaves((fresh, fresh_state))))
        check(equal, "train_qwen2: the restored state differs from the "
              "saved one")
        # the last steps of the same schedule, from the saved state and from
        # the restored one
        step_fn = make_train_step(model, train.opt_config(cfg, train.parse_args(
            argv + ["--steps", str(TRAIN_STEPS)])))
        shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")

        def last_steps(p, st):
            """The steps' losses and seconds, and each batch's loss after its
            own step."""
            out, secs, after = [], [], []
            for k in range(TRAIN_SAVED_AT, TRAIN_STEPS):
                b = to_device(synthetic_batch(cfg, shape, k), DEVICE)
                (p, st, m), sec = sync_s(lambda: step_fn(p, st, b))
                out.append(float(m["loss"]))
                secs.append(sec)
                with torch.no_grad():
                    after.append(float(model.loss_fn(p, b)))
            return out, secs, after

        run_losses, run_s = run.losses, run.step_s
        kept, kept_s, kept_after = last_steps(params, state)
        del run, params, state, leaves
        h.release()
        resumed, resumed_s, resumed_after = last_steps(fresh, fresh_state)
        resume_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, kept))
        check(all(np.isfinite(resumed)) and resume_rel <= TRAIN_RESUME_RTOL,
              f"train_qwen2: resumed losses {resumed} against {kept} "
              f"(rtol {TRAIN_RESUME_RTOL})")
        check(all(np.isfinite(kept_after + resumed_after)) and all(
            a < b for a, b in zip(kept_after + resumed_after, kept + resumed)),
              f"train_qwen2: a step did not lower its own batch's loss: "
              f"{kept + resumed} -> {kept_after + resumed_after}")
        # one more step under the profiler: its kernels' device time
        b = to_device(synthetic_batch(cfg, shape, TRAIN_STEPS), DEVICE)
        busy_ms = launches = None
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, prof_s = sync_s(lambda: step_fn(fresh, fresh_state, b))
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            busy_ms = sum(e.self_device_time_total
                          if hasattr(e, "self_device_time_total")
                          else e.self_cuda_time_total for e in kernels) / 1e3
            launches = len(kernels)
        # the steady steps: all but the run's first (which warms the card up)
        steady_ms = 1e3 * float(np.median(run_s[1:] + kept_s + resumed_s))
        h.emit_phase(
            phase="train_qwen2", card=card, arch=cfg.name, dtype=cfg.dtype,
            optimizer=cfg.optimizer, remat=cfg.remat, layers=cfg.n_layers,
            d_model=cfg.d_model, vocab=cfg.vocab, params=n_params,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, tokens_per_step=tokens,
            losses=run_losses + kept, resumed_losses=resumed,
            first_loss=run_losses[0], last_loss=kept[-1],
            batch_loss_after_its_step=kept_after,
            resumed_batch_loss_after_its_step=resumed_after,
            resume_rel_err=resume_rel, resume_rtol=TRAIN_RESUME_RTOL,
            step_ms=[1e3 * x for x in run_s + kept_s],
            resumed_step_ms=[1e3 * x for x in resumed_s],
            steady_step_ms=steady_ms, tokens_per_s=tokens / (steady_ms / 1e3),
            step_ops=nops, step_bound_ms=bound_ms, step_bound_by=bound_by,
            step_over_bound=steady_ms / bound_ms, peak_run_gb=peak_run_gb,
            state_bytes=state_bytes, checkpoint_bytes=ck_bytes,
            checkpoint_host_copy_s=host_s, checkpoint_write_s=write_s,
            restore_s=restore_s, disk_free_gb=free / 1e9,
            restored_bit_for_bit=equal, profiled_step_wall_ms=1e3 * prof_s,
            step_device_busy_ms=busy_ms, step_kernel_launches=launches,
            device_idle_share=None if busy_ms is None
            else 1 - busy_ms / steady_ms, elapsed_s=time.perf_counter() - t0)
        del _
        h.release()
        train_cost_check(torch, h, model, fresh, fresh_state, b,
                         train.opt_config(cfg, train.parse_args(
                             argv + ["--steps", str(TRAIN_STEPS)])),
                         steady_ms, bound_ms)
        # the mesh phase restores the checkpoint and steps from the
        # state train_qwen2 restored (it owns them from here: no other
        # name may hold them, the restore's and the profiled step's
        # results included)
        ref = [fresh, fresh_state]
        del fresh, fresh_state, prof, b
        h.release()
        placed = train_mesh_cells(torch, h, ckdir, ref, argv)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    dryrun_model_cells(torch, h, placed)
    h.emit_phase(phase="train_total", card=card,
                 elapsed_s=time.perf_counter() - t_all)

def one_position_mesh(torch):
    """A ("data", "model") mesh of one position: the card."""
    from repro_torch.distr.mesh import Mesh
    return Mesh(np.full((1, 1), torch.device(DEVICE), dtype=object),
                ("data", "model"))


def dryrun_cell(cfg, shape, mesh):
    """The dry-run's record of one cell on ``mesh``: its layout, cost,
    memory (the peak: held bytes plus the counted temporaries) and
    roofline."""
    from repro_torch.launch import dryrun
    lay = dryrun.model_layout(cfg, shape, mesh, activations=False)
    return dict(layout=lay, **dryrun.cell_cost(cfg, shape, mesh, lay))


def train_cost_check(torch, h, model, params, state, batch, opt_cfg,
                     step_ms, hand_ms):
    """``train_cost``: the dry-run's count of qwen2-1.5b's train step at
    TRAIN_BATCH x TRAIN_SEQ tokens on a one-position mesh (one part of
    every row; ``launch.dryrun``: meta tensors at 1 and 2 layers,
    extrapolated to 28) held against the card. One more step's forward and
    backward (``train_step.part_grads``, what the sharded step runs a part)
    under the dry-run's counters (``dryrun.count_ops``) on the card: its
    FLOPs and bytes must equal the dry-run's as integers. Then one sharded
    step on a one-position mesh of the card (params, AdamW state and batch
    placed: views): the bytes it placed must equal the dry-run's
    arguments, and those plus the step's peak above the bytes live before
    it must lie within 10% of the dry-run's ``peak_per_device_bytes``.
    Printed beside the roofline's bound: the measured steady step and the
    hand formula's operations bound."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distr import sharding as sh
    from repro_torch.distr.shardctx import ShardCtx, use
    from repro_torch.launch import dryrun
    from repro_torch.models.base import tree_leaves
    from repro_torch.train.train_step import make_train_step, part_grads
    t_all = time.perf_counter()
    cfg = model.cfg
    shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    one = one_position_mesh(torch)
    t0 = time.perf_counter()
    dry = dryrun_cell(cfg, shape, one)
    dry_s = time.perf_counter() - t0
    cost, mem, rl = dry["cost"], dry["memory"], dry["roofline"]
    whole = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flops, nbytes, _ = dryrun.count_ops(
        lambda: part_grads(model, params, whole, batch))
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    del whole
    check(flops == cost["flops_per_device"]
          and nbytes == cost["bytes_per_device"],
          f"train_cost: the card's step counts {flops} FLOPs and {nbytes} "
          f"bytes, the dry-run {cost['flops_per_device']} and "
          f"{cost['bytes_per_device']}")
    h.release()
    placed = (sh.place(params, sh.param_shardings(params, one, cfg.vocab),
                       one),
              sh.place(state, sh.opt_state_shardings(state, one, cfg.vocab),
                       one),
              sh.place(batch, sh.batch_shardings(batch, one), one))
    held = sh.position_bytes(placed, 0)
    check(held == dry["layout"]["argument_bytes_per_position"],
          f"train_cost: {held} bytes placed, the dry-run's arguments "
          f"{dry['layout']['argument_bytes_per_position']}")
    step = make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with use(ShardCtx(one)):
        m = step(*placed)[2]
    torch.cuda.synchronize()
    mesh_step_ms = 1e3 * (time.perf_counter() - t0)
    above = torch.cuda.max_memory_allocated() - before
    check(np.isfinite(float(m["loss"])), "train_cost: the loss is not "
          "finite")
    measured = held + above
    err = mem["peak_per_device_bytes"] / measured - 1
    check(abs(err) <= 0.1, f"train_cost: the dry-run's peak "
          f"{mem['peak_per_device_bytes']} bytes against {measured} "
          f"measured ({err:+.3f})")
    del placed, m
    h.release()
    h.emit_phase(
        phase="train_cost", card=h.card, arch=cfg.name, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, counted_flops=flops, counted_bytes=nbytes,
        dryrun_flops=cost["flops_per_device"],
        dryrun_bytes=cost["bytes_per_device"], equal=True,
        dryrun_s=dry_s, counted_step_s=counted_s,
        dryrun_temp_bytes=mem["temp_size_in_bytes"],
        dryrun_peak_bytes=mem["peak_per_device_bytes"],
        measured_held_bytes=held, measured_above_bytes=above,
        measured_peak_bytes=measured, peak_rel_err=err,
        mesh_step_ms=mesh_step_ms, roofline=rl,
        roofline_bound_ms=1e3 * rl["bound_s"], steady_step_ms=step_ms,
        hand_formula_bound_ms=hand_ms,
        step_over_roofline=step_ms / (1e3 * rl["bound_s"]),
        elapsed_s=time.perf_counter() - t_all)


def decode_cost_check(torch, h, model, params, cache, tok, T, step_ms):
    """``decode_cost``: the dry-run's count of one qwen2-1.5b decode step at
    batch 4 over the check's cache of ``T`` slots, on a one-position mesh,
    held against the card: one more serve step (``make_serve_step``, at the
    cache's last slot, as the dry-run counts it) under
    ``dryrun.count_ops``: its FLOPs and bytes equal the dry-run's as
    integers; the params, cache and token bytes plus the step's peak above
    the bytes live before it within 10% of the dry-run's
    ``peak_per_device_bytes``. Printed beside the roofline's bound: the
    measured step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.base import tree_leaves
    from repro_torch.serve.serve_step import make_serve_step
    t_all = time.perf_counter()
    cfg = model.cfg
    B = tok.shape[0]
    shape = ShapeConfig("decode", T, B, "decode")
    t0 = time.perf_counter()
    dry = dryrun_cell(cfg, shape, one_position_mesh(torch))
    dry_s = time.perf_counter() - t0
    cost, mem, rl = dry["cost"], dry["memory"], dry["roofline"]
    step = make_serve_step(model)
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves(params) + tree_leaves(cache) + [tok])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    flops, nbytes, _ = dryrun.count_ops(
        lambda: step(params, cache, {"tokens": tok}, T - 1))
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - before
    check(flops == cost["flops_per_device"]
          and nbytes == cost["bytes_per_device"],
          f"decode_cost: the card's step counts {flops} FLOPs and {nbytes} "
          f"bytes, the dry-run {cost['flops_per_device']} and "
          f"{cost['bytes_per_device']}")
    measured = held + above
    err = mem["peak_per_device_bytes"] / measured - 1
    check(abs(err) <= 0.1, f"decode_cost: the dry-run's peak "
          f"{mem['peak_per_device_bytes']} bytes against {measured} "
          f"measured ({err:+.3f})")
    h.emit_phase(
        phase="decode_cost", card=h.card, arch=cfg.name, batch=B,
        cache_len=T, counted_flops=flops, counted_bytes=nbytes,
        dryrun_flops=cost["flops_per_device"],
        dryrun_bytes=cost["bytes_per_device"], equal=True, dryrun_s=dry_s,
        dryrun_temp_bytes=mem["temp_size_in_bytes"],
        dryrun_peak_bytes=mem["peak_per_device_bytes"],
        measured_held_bytes=held, measured_above_bytes=above,
        measured_peak_bytes=measured, peak_rel_err=err, roofline=rl,
        roofline_bound_ms=1e3 * rl["bound_s"], step_wall_ms=step_ms,
        step_over_roofline=step_ms / (1e3 * rl["bound_s"]),
        elapsed_s=time.perf_counter() - t_all)


def train_mesh_cells(torch, h, ckdir, ref, argv):
    """``train_mesh``: qwen2-1.5b's training state on a ("data", "model")
    mesh of the card's positions (``distr.sharding``, ``distr.shardctx``,
    the sharded ``train.train_step``, ``train.checkpoint.restore(shardings=,
    mesh=)``, ``launch.elastic``). No TPU kernel lies on it: the JAX
    package places and steps its models through XLA.

    From ``train_qwen2``'s checkpoint (step TRAIN_SAVED_AT) and its
    restored state (``ref``: params and AdamW state, which this phase
    owns), under deterministic algorithms: the checkpoint restored onto
    TRAIN_MESH (32 positions, four simulated workers of 8), its gather
    held to the manifest's sha1 of every leaf, each position's bytes to
    the dry-run's accounting; the reference: ``ref`` set to that
    placement's leaves (so to the checkpoint) and stepped unsharded with
    microbatches = 2 on the step's 8 x 1,024-token batch, its result then
    moved to the host; one sharded step with one microbatch a data block
    (the same two 4 x 1,024 gradients, summed in float32 in the same
    order), its collectives to the dry-run's; then a fleet of four workers
    under a fake clock, one of which stops beating: ``plan_restart`` must
    give (1, 16), the checkpoint restored onto it and stepped with
    microbatches = 2. Each mesh's step against the reference and the two
    meshes' against each other: the loss, the gradient norm, and every
    param and moment within ``train_parity``'s bounds (per element within
    2 lr, or for a bfloat16 param one unit in its last place: its float32
    update differs in the last bits where the norm's sums run per block,
    and may round to the neighbouring bfloat16 value; the count past 0.01
    lr printed, at most 1e-4 of them), the largest differences printed.
    Returns the bytes each position held, by mesh."""
    import warnings
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.distr import sharding as sh
    from repro_torch.distr.mesh import Mesh
    from repro_torch.distr.shardctx import ShardCtx, use
    from repro_torch.launch import dryrun, elastic, train
    from repro_torch.models import get_model, jax_leaves
    from repro_torch.models.base import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.data import synthetic_batch, to_device
    from repro_torch.train.train_step import make_train_step
    card = h.card
    t_all = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    model = get_model(cfg)
    opt_cfg = train.opt_config(cfg, train.parse_args(
        argv + ["--steps", str(TRAIN_STEPS)]))
    shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = to_device(synthetic_batch(cfg, shape, TRAIN_SAVED_AT), DEVICE)
    with open(os.path.join(ckdir, f"step_{TRAIN_SAVED_AT}",
                           "manifest.json")) as f:
        sha1s = [m["sha1"] for m in json.load(f)["leaves"]]
    like = (model.param_specs(),
            opt_mod.adamw_init(sh.as_meta(model.param_specs())))

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def whole_leaves(tree, device):
        """Each JAX leaf of a tree (placed or not) whole on ``device``, one
        at a time."""
        for _, ts, stacked in jax_leaves(tree):
            out = torch.empty(((len(ts),) if stacked else ())
                              + tuple(ts[0].shape), dtype=ts[0].dtype,
                              device=device)
            for i, t in enumerate(ts):
                ckpt._copy_into(out[i] if stacked else out, t)
            yield out

    def sha1s_of(tree):
        """The sha1 of each JAX leaf's bytes, as the manifest states them."""
        with ckpt._pool() as pool:
            return list(pool.map(lambda x: ckpt._sha1(ckpt.host_array(x)),
                                 whole_leaves(tree, "cpu")))

    def compare(tree, other, lr):
        """A placed tree's leaves against another tree's (placed, or host
        tensors), leaf by leaf on the card: the largest difference, the
        count of elements past 0.01 lr, the element count, whether every
        one is equal, and the elements past 2 lr: a bfloat16 param whose
        float32 update differs in its last bits may round to the
        neighbouring bfloat16 value, one unit in the last place of it
        (``ulp_flips`` counts those, ``past_bound`` any other)."""
        worst, past, numel, equal, flips, beyond = 0.0, 0, 0, True, 0, 0
        want = (iter(other) if isinstance(other, list)
                else whole_leaves(other, DEVICE))
        for a, b in zip(whole_leaves(tree, DEVICE), want):
            b = b.to(DEVICE)
            d = (a.float() - b.float()).abs()
            worst = max(worst, float(d.max()))
            past += int((d > 0.01 * lr).sum())
            numel += d.numel()
            equal &= bool(torch.equal(a, b))
            far = d > 2 * lr
            if b.dtype == torch.bfloat16 and bool(far.any()):
                mag = torch.maximum(a.float().abs(), b.float().abs())
                ulp = torch.exp2(torch.floor(torch.log2(
                    torch.clamp(mag, min=1e-30))) - 7)
                flip = far & (d <= ulp)
                flips += int(flip.sum())
                far &= ~flip
            beyond += int(far.sum())
            del a, b, d, far
        return {"max_abs_err": worst, "past_0.01lr": past, "elements": numel,
                "bit_for_bit": equal, "ulp_flips": flips,
                "past_bound": beyond}

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    caught = warnings.catch_warnings(record=True)
    seen = caught.__enter__()
    warnings.simplefilter("always")
    def reference(P, St):
        """train_qwen2's restored state set to the checkpoint from the
        placement just held to it (its leaves copied in), stepped unsharded
        with microbatches = 2, its result moved to the host."""
        ref_p, ref_s = ref
        mine, placed = tree_leaves((ref_p, ref_s)), tree_leaves((P, St))
        check([tuple(t.shape) for t in mine] == [x.shape for x in placed],
              "train_mesh: the reference's leaves are not the placement's")
        with torch.no_grad():
            _, set_s = sync_s(lambda: [sh.gather_leaf(x, out=t)
                                       for t, x in zip(mine, placed)])
        torch.cuda.reset_peak_memory_stats()
        (_, _, rm), step_s = sync_s(lambda: make_train_step(
            model, opt_cfg, microbatches=2)(ref_p, ref_s, batch))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        host = list(whole_leaves((ref_p, ref_s), "cpu"))
        ref.clear()
        return rm, host, dict(set_s=set_s, step_ms=1e3 * step_s,
                              peak_gb=peak_gb)

    try:
        # -- the meshes: restore, check, step (the reference before the
        # first step) ----------------------------------------------------------
        rm = None
        policy_t = [0.0]
        policy = elastic.RestartPolicy(timeout_s=60.0,
                                       clock=lambda: policy_t[0])
        workers = [f"w{i}" for i in range(TRAIN_MESH[0] * TRAIN_MESH[1]
                                          // TRAIN_MESH_WORKER)]
        for w in workers:
            policy.heartbeat(w, 1.0)
        rows, placed_bytes, stepped = {}, {}, {}
        plan = None
        for shape_, mb in ((TRAIN_MESH, 1), (None, 2)):
            if shape_ is None:      # a worker stops beating: re-plan
                policy_t[0] = 30.0
                for w in workers[:-1]:
                    policy.heartbeat(w, 1.0)
                policy_t[0] = 90.0
                check(policy.should_restart()
                      and policy.dead_workers() == [workers[-1]],
                      f"train_mesh: dead workers {policy.dead_workers()}")
                plan = policy.plan_restart(
                    chips_per_worker=TRAIN_MESH_WORKER)
                check(plan == ((1, 16), ("data", "model")),
                      f"train_mesh: plan_restart gave {plan}")
                shape_ = plan[0]
            name = "x".join(map(str, shape_))
            mesh = Mesh(np.full(shape_, torch.device(DEVICE),
                                dtype=object), ("data", "model"))
            specs = (sh.param_shardings(like[0], mesh, cfg.vocab),
                     sh.opt_state_shardings(like[1], mesh, cfg.vocab))
            torch.cuda.reset_peak_memory_stats()
            ((P, St), at), restore_s = sync_s(lambda: ckpt.restore(
                like, ckdir, TRAIN_SAVED_AT, shardings=specs, mesh=mesh))
            check(at == TRAIN_SAVED_AT, f"train_mesh {name}: step {at}")
            t0 = time.perf_counter()
            got = sha1s_of((P, St))
            gather_check_s = time.perf_counter() - t0
            check(got == sha1s, f"train_mesh {name}: the placed state does "
                  f"not gather to the checkpoint")
            Bt, place_s = sync_s(lambda: sh.place(
                batch, sh.batch_shardings(batch, mesh), mesh))
            held = [sh.position_bytes((P, St, Bt), pos)
                    for pos in range(mesh.size)]
            lay = dryrun.model_layout(
                dataclasses.replace(cfg, microbatches=mb), shape, mesh,
                activations=False)
            check(set(held) == {lay["argument_bytes_per_position"]},
                  f"train_mesh {name}: positions hold {min(held)}-"
                  f"{max(held)} bytes, the dry-run "
                  f"{lay['argument_bytes_per_position']}")
            placed_bytes[name] = held
            if rm is None:
                rm, host_ref, ref_row = reference(P, St)
                lr = float(rm["lr"])
                h.release()
            torch.cuda.reset_peak_memory_stats()
            step = make_train_step(model, opt_cfg, microbatches=mb)
            with use(ShardCtx(mesh)):
                (P, St, m), step_s = sync_s(lambda: step(P, St, Bt))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            check(m["collectives"] == lay["collectives"],
                  f"train_mesh {name}: collectives {m['collectives']} "
                  f"against the dry-run's {lay['collectives']}")
            res = compare((P, St), host_ref, lr)
            rows[name] = dict(
                mesh=list(shape_), microbatches=mb, positions=mesh.size,
                restore_s=restore_s, gather_check_s=gather_check_s,
                batch_place_s=place_s, step_ms=1e3 * step_s,
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                loss_err=abs(float(m["loss"]) - float(rm["loss"])),
                grad_norm_err=abs(float(m["grad_norm"])
                                  - float(rm["grad_norm"])),
                against_reference=res, collectives=m["collectives"],
                bytes_per_position_max=max(held),
                bytes_per_position_min=min(held), peak_gb=peak_gb)
            allowed = int(1e-4 * res["elements"])
            check(rows[name]["loss_err"] <= 1e-5
                  and res["past_bound"] == 0
                  and res["past_0.01lr"] <= allowed,
                  f"train_mesh {name}: against the unsharded step {res}, "
                  f"loss {rows[name]['loss_err']} (allowed {allowed} past)")
            if stepped:
                between = compare((P, St), stepped.popitem()[1], lr)
            else:
                stepped[name] = (P, St)
            del P, St, Bt, m
            h.release()
        check(between["past_bound"] == 0
              and between["past_0.01lr"] <= int(1e-4 * between["elements"]),
              f"train_mesh: the two meshes' steps differ: {between}")
    finally:
        caught.__exit__(None, None, None)
        torch.use_deterministic_algorithms(prev)
    nondet = sorted({str(w.message).split(".")[0][:160] for w in seen
                     if "deterministic" in str(w.message)})
    h.emit_phase(
        phase="train_mesh", card=card, arch=cfg.name, dtype=cfg.dtype,
        optimizer=cfg.optimizer, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        step=TRAIN_SAVED_AT, lr=lr, reference_microbatches=2,
        reference_loss=float(rm["loss"]),
        reference_grad_norm=float(rm["grad_norm"]),
        reference_set_s=ref_row["set_s"],
        reference_step_ms=ref_row["step_ms"],
        reference_peak_gb=ref_row["peak_gb"],
        meshes=rows, between_meshes=between, plan_restart=plan,
        workers=len(workers), chips_per_worker=TRAIN_MESH_WORKER,
        nondeterministic_ops=nondet, elapsed_s=time.perf_counter() - t_all)
    return placed_bytes


def dryrun_model_cells(torch, h, placed_bytes):
    """``dryrun_models``: ``launch.dryrun --all --mesh both --no-cost``
    (every arch x shape x production mesh on meta positions; nothing
    allocated: the layout), each cell ok, then qwen2-1.5b's cells again
    with their cost, memory and roofline (counting every cell takes
    minutes); then qwen2-1.5b's train cell re-run on each mesh
    ``train_mesh`` placed, with its batch, against the bytes each position
    held there."""
    import shutil
    import tempfile
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.distr.mesh import Mesh
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix=".dryrun_", dir=ROOT)
    try:
        rc = dryrun.main(["--all", "--mesh", "both", "--out", out,
                          "--no-cost"])
        cells_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        rc_cost = dryrun.main(["--arch", "qwen2-1.5b", "--mesh", "both",
                               "--out", out])
        cost_s = time.perf_counter() - t1
        cells = [json.load(open(os.path.join(out, n)))
                 for n in sorted(os.listdir(out))]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    bad = [c["cell"] for c in cells if c["status"] != "ok"]
    check(rc == 0 and rc_cost == 0 and not bad,
          f"dryrun_models: cells not ok: {bad}")
    cfg = get_config("qwen2-1.5b")
    counted = {f"{c['shape']}/{c['mesh']}": {
        k: c[k] for k in ("cost", "memory", "roofline", "fits_hbm",
                          "model_flops_per_device", "useful_flops_ratio")}
        for c in cells if c["arch"] == cfg.name}
    check(len(counted) == 6 and all(
        np.isfinite(c["roofline"]["bound_s"]) and c["cost"]["flops_per_device"]
        > 0 for c in counted.values()),
          f"dryrun_models: qwen2-1.5b's cells without a cost: {counted}")
    shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    held = {}
    for name, got in placed_bytes.items():
        dims = tuple(int(x) for x in name.split("x"))
        mesh = Mesh(np.full(dims, torch.device("meta"), dtype=object),
                    ("data", "model"))
        lay = dryrun.model_layout(cfg, shape, mesh, activations=False)
        held[name] = {"dryrun": lay["argument_bytes_per_position"],
                      "placed_min": min(got), "placed_max": max(got),
                      "parts": lay["argument_parts"]}
        check(set(got) == {lay["argument_bytes_per_position"]},
              f"dryrun_models {name}: {held[name]}")
    q = {c["mesh"]: {k: c[k] for k in (
        "argument_bytes_per_position", "collective_bytes_per_device",
        "layout_bytes_per_position", "fits_hbm")}
        for c in cells if c["arch"] == cfg.name and c["shape"] == "train_4k"}
    h.emit_phase(phase="dryrun_models", card=h.card, cells=len(cells),
                 archs=len({c["arch"] for c in cells}), cells_s=cells_s,
                 qwen2_cost_s=cost_s,
                 fits_layout_only=sum(c["fits_hbm"] for c in cells
                                      if c["layout_only"]),
                 qwen2_train_4k=q, qwen2_counted=counted,
                 train_mesh_held=held, elapsed_s=time.perf_counter() - t0)


if __name__ == "__main__":
    if "--seed" in sys.argv:
        SEED = int(sys.argv[sys.argv.index("--seed") + 1])
    sys.exit(main())

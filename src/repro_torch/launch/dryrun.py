"""The dry-run: layout accounting, cost, memory and roofline of the model
cells and of the paper's graph workload cells. Port of
``repro.launch.dryrun``.

The model cells: every (arch x ``shapes_for(cfg)`` x mesh) cell but the
arch's ``skip_shapes``, on a production mesh (``launch.mesh``) of meta
positions, with the JAX package's policy (``distr.sharding``,
``distr.shardctx``). Each cell writes one JSON with, per position:

  * the argument bytes: params, optimizer state (train), batch, caches and
    the position scalar (decode), each leaf's block under its spec;
  * the output bytes: the metrics (train; params and state alias their
    inputs, as the JAX step donates them), the last position's logits
    (prefill), the next tokens (decode; the caches alias theirs);
  * the collective bytes by kind under the port's schedule
    (``train.train_step.step_collectives`` for train; the params gathered
    for compute, and a decode's cache gathered over its non-data axes, for
    serving), in the per-device convention of ``collective_stats``;
  * the whole params (and a decode's whole cache per data block) that the
    schedule gathers for compute, and a train step's gradient blocks;
  * the activation layouts the shard context logged (``(logical axes,
    shape, spec)``, each distinct one once) from one forward on meta
    tensors at the cell's shapes, the stacks cut to one layer each (every
    layer logs the same; the time scans give their shapes only);
  * ``cost`` (``cost_stats``): one position's step under the port's
    schedule, every position computing one batch block with whole params:
    a train cell's forward and backward of one part (``global_batch`` /
    data blocks / ``microbatches`` rows, remat as configured;
    ``train_step.part_grads``) times ``microbatches``, a prefill's forward,
    a decode's serve step over the block's whole cache. Counted on meta
    tensors by ``count_ops``: FLOPs by the formulas of torch's
    ``FlopCounterMode``, bytes the eager run's traffic (each aten op's
    operands and results; the counterpart of XLA's "bytes accessed"),
    at the smallest depth that repeats each stack's pattern and one pattern
    more (``depth_points``), extrapolated to the config's depth. The same
    ops on card tensors count the same: ``chip_smoke.py`` holds qwen2-1.5b's
    train and decode steps to it. The update, the gradient sums and the
    collectives are not counted;
  * ``memory`` (``mem_stats``, the JAX keys): arguments, outputs (aliased
    ones included), the counted run's temporaries (the peak of the bytes
    it allocates) and ``peak_per_device_bytes``, the held bytes above plus
    the temporaries, which ``fits_hbm`` judges against one card's memory
    (``torch.cuda`` when a card is present, else an H100's 80 GB, named so
    in the record);
  * ``roofline`` (``roofline``): the cost at the H100 SXM's data-sheet
    rates (``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW`` for the collectives),
    the dominant term and ``bound_s``; ``model_flops_per_device`` and
    ``useful_flops_ratio`` as the JAX module defines them.

The graph cells: each is one probe
of ``distr.graph2d`` (PageRank, or k-hop in the int8, bitmap and bitmap +
sentinel forms) on one of the paper's two graphs (``configs.graph500``,
``configs.twitter``) over a production mesh (``launch.mesh``): one pod of
16 x 16 positions or two. Nothing is allocated: the probe's inputs are
meta tensors (``graph2d.input_specs_2d`` / ``pagerank_specs_2d``) sharded
by ``distr.mesh.shard`` over a mesh of ``torch.device("meta")``
positions. Each cell writes one JSON with, per position:

  * the argument and output bytes of the sharded layout;
  * the bytes of one all-gathered frontier (or push vector);
  * the collective result bytes by kind, counted from the probe's
    collectives (k all-gathers and one all-reduce for k-hop, ``iters`` x
    (all-gather + all-reduce) for PageRank), the per-device convention of
    the JAX package's ``collective_stats``;
  * position 0's cost over the k hops or ``iters`` iterations: the plain
    torch body by ``count_ops`` on meta tensors, each hop's
    ``ell_mxv_packed`` launch (the bitmap forms) by
    ``kernels.bitmap_mxv.launch_cost`` with every padded slot valid, its
    int32 operations at ``INT32_OPS_PER_S`` in the roofline's compute term;
    its memory and roofline as above.

``--no-cost`` writes the layout alone (``layout_only``): seconds for every
cell, where counting them takes minutes (the time scans of rwkv6 and
zamba2 the most). A cell that cannot be counted is recorded as an error.
``collective_stats``, the HLO text parser, is kept for reading the JAX
package's modules.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --mesh both --out DIR
  python -m repro_torch.launch.dryrun --all --mesh both --out DIR
  python -m repro_torch.launch.dryrun --graph --mesh both --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import sys
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import graph500, twitter
from repro_torch.configs.base import (ARCHS, SHAPES, get_config,
                                      shapes_for)
from repro_torch.core import bitmap
from repro_torch.core.bitmap import n_words
from repro_torch.core.shard import frontier_spec
from repro_torch.distr import graph2d
from repro_torch.distr import mesh as M
from repro_torch.distr import sharding as sh
from repro_torch.distr.mesh import Mesh
from repro_torch.distr.shardctx import ShardCtx, use
from repro_torch.kernels import bitmap_mxv
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.models.base import (shapes_only, tree_leaves,
                                     zeros_from_specs)
from repro_torch.serve.serve_step import make_serve_step
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import layouts, part_grads, step_collectives

H100_BYTES = 80e9     # an H100's device memory (data sheet), without a card
# the roofline's denominators: NVIDIA H100 SXM data-sheet figures, a card
PEAK_FLOPS = 989e12   # dense bfloat16 on the tensor cores
HBM_BW = 3.35e12      # HBM3, bytes/s
# bytes/s a link: one 400 Gb/s ConnectX-7 port a GPU on a DGX H100. A
# 16-wide mesh axis spans two 8-GPU nodes, so the network bounds its
# collectives (inside a node NVLink 4 moves 450 GB/s a direction).
LINK_BW = 50e9
# the word kernels' 32-bit OR and bit tests run on the integer pipes: 64
# results a clock an SM for compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput) x 132 SMs x the data sheet's
# 1.98 GHz boost clock, about 16.7e12 a second
INT32_OPS_PER_S = 64 * 132 * 1.98e9
ALLOC_BLOCK = 512     # bytes: the CUDA caching allocator's smallest block

# name: (n_vertices, max_deg, F queries, k)
GRAPH_CELLS = {cfg["name"]: (cfg["n_vertices"], cfg["max_deg"],
                             cfg["queries"], cfg["k"])
               for cfg in (graph500.GRAPH_CONFIG, twitter.GRAPH_CONFIG)}
PAGERANK_ITERS = 10


_COLL = re.compile(
    r"(\w+)\[([\d,]*)\]\S*\s+(all-gather|all-reduce|reduce-scatter|"
    r"all-to-all|collective-permute)", re.IGNORECASE)
_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}


def collective_stats(hlo_text: str):
    """Sum result-buffer bytes of every collective op in partitioned HLO
    text (per-device convention): (total, {kind: {"count", "bytes"}})."""
    by_kind = {}
    total = 0
    for m in _COLL.finditer(hlo_text):
        dt, dims, kind = m.group(1), m.group(2), m.group(3).lower()
        sz = _DTYPE_BYTES.get(dt, 4)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        b = n * sz
        e = by_kind.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += b
        total += b
    return total, by_kind


def roofline(nchips, flops_dev, bytes_dev, coll_bytes_dev, int_ops_dev=0):
    """The least time of a cell's step per device: the larger of its
    FLOPs at ``PEAK_FLOPS`` (plus the word kernels' integer operations at
    ``INT32_OPS_PER_S``), its bytes at ``HBM_BW`` and its collective bytes
    at ``LINK_BW`` (``repro.launch.dryrun.roofline`` with these
    constants)."""
    del nchips
    compute_s = flops_dev / PEAK_FLOPS + int_ops_dev / INT32_OPS_PER_S
    memory_s = bytes_dev / HBM_BW
    coll_s = coll_bytes_dev / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


def _leaves(x, out):
    """The leaves of an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(x, (tuple, list)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


class _Layout(tuple):
    """A result's (shape, stride, dtype) in ``_META_RESULTS``."""


def _layout_of(x):
    if isinstance(x, torch.Tensor):
        return _Layout((tuple(x.shape), x.stride(), x.dtype))
    if isinstance(x, (tuple, list)):
        return type(x)(_layout_of(y) for y in x)
    return x


def _from_layout(x):
    if isinstance(x, _Layout):
        return torch.empty_strided(x[0], x[1], dtype=x[2], device="meta")
    if isinstance(x, (tuple, list)):
        return type(x)(_from_layout(y) for y in x)
    return x


# (op, its operands' shapes, strides and dtypes, its other arguments) -> its
# results' layouts: an op that neither views nor writes its operands makes
# results whose layout these fix. Many meta kernels run in Python, and a
# time scan repeats the same ops at the same shapes thousands of times.
_META_RESULTS = {}


def _meta_key(func, leaves):
    """The op's ``_META_RESULTS`` key, or None: an operand off the meta
    device, or none at all (a factory's device is an argument)."""
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    if not tensors or not all(t.is_meta for t in tensors):
        return None
    key = (func,) + tuple((tuple(x.shape), x.stride(), x.dtype)
                          if isinstance(x, torch.Tensor) else x
                          for x in leaves)
    try:
        hash(key)
    except TypeError:
        return None
    return key


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it (an eager op is one kernel):

    * ``flops``: by the formulas of torch's ``FlopCounterMode``
      (``torch.utils.flop_counter.flop_registry``: products, convolutions,
      attention);
    * ``bytes``: each op's operand and result bytes, the eager run's
      traffic (the counterpart of XLA's "bytes accessed"). An op that only
      views or aliases its operands, or only allocates (``empty``), moves
      none;
    * ``peak``: the most bytes at once of the storages the run allocated
      (an op's result whose storage is none of its operands'), each live
      until it is freed (weakly keyed on its storage) and rounded up to the
      caching allocator's ALLOC_BLOCK.

    It runs on any device, meta tensors included: the same ops on the same
    shapes count the same. On meta operands an op that neither views nor
    writes them takes its results' layout from ``_META_RESULTS`` once
    seen."""

    _EMPTY = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.live = self.peak = 0
        self._held = {}

    def _free(self, key, nbytes, _ref):
        self._held.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:            # no bytes moved, nothing allocated
            return func(*args, **kwargs)
        ins = _leaves((args, kwargs), [])
        mutable = func._schema.is_mutable
        key = None if mutable else _meta_key(func, ins)
        if key is not None and key in _META_RESULTS:
            out = _from_layout(_META_RESULTS[key])
        else:
            out = func(*args, **kwargs)
        ins = [t for t in ins if isinstance(t, torch.Tensor)]
        outs = [t for t in _leaves(out, []) if isinstance(t, torch.Tensor)]
        seen = {id(t.untyped_storage()) for t in ins}
        fresh = {id(t.untyped_storage()): t.untyped_storage() for t in outs
                 if id(t.untyped_storage()) not in seen}
        if key is not None and len(fresh) == len(outs):
            _META_RESULTS.setdefault(key, _layout_of(out))
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if fresh and packet.__name__ not in self._EMPTY or (
                not fresh and mutable):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for k, st in fresh.items():
            if k in self._held:
                continue
            nb = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
            self._held[k] = weakref.ref(st, functools.partial(self._free, k,
                                                              nb))
            self.live += nb
            self.peak = max(self.peak, self.live)
        return out


def count_ops(fn):
    """``(flops, bytes, temp)`` of one call of ``fn`` by ``OpCounter``:
    its FLOPs, bytes and the peak of the bytes it allocated."""
    with OpCounter() as ops:
        fn()
    return ops.flops, ops.bytes, ops.peak


def khop_kind(packed: bool, sentinel: bool) -> str:
    return "khop" + ("_bitmap" if packed else "") + \
        ("_sentinel" if sentinel else "")


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def meta_mesh(multi_pod: bool) -> Mesh:
    """A production mesh of meta positions."""
    return make_production_mesh(multi_pod=multi_pod,
                                devices=[torch.device("meta")] * 512)


def card_memory():
    """(bytes, what they are) of one card's memory."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                f"torch.cuda: {torch.cuda.get_device_name(0)}")
    return H100_BYTES, "no card present: an H100's 80 GB (data sheet)"


def _as_meta(mesh: Mesh) -> Mesh:
    """A mesh of ``mesh``'s shape and axes over meta positions."""
    return Mesh(np.full(mesh.devices.shape, torch.device("meta"),
                        dtype=object), mesh.axis_names)


def _position0(mesh, specs, shards):
    """Position 0's blocks of each global spec (meta views)."""
    return [M.shard(mesh, x, sp)[0] for x, sp in zip(specs, shards)]


def _record(mesh, args, out, gathered, collectives):
    held = sum(a.nbytes for a in args) + out.nbytes + gathered
    mem, source = card_memory()
    return dict(
        positions=mesh.size, mesh_shape=dict(mesh.shape),
        argument_bytes_per_position=sum(a.nbytes for a in args),
        argument_shapes=[list(a.shape) for a in args],
        output_bytes_per_position=out.nbytes,
        gathered_bytes_per_position=gathered,
        collectives=collectives,
        collective_bytes_per_device=sum(c["bytes"]
                                        for c in collectives.values()),
        layout_bytes_per_position=held, card_bytes=mem, card=source,
        fits_hbm=held < mem)


def khop_layout(mesh, n: int, max_deg: int, f: int, k: int,
                packed: bool = False, sentinel: bool = False) -> dict:
    """Per-position layout of ``graph2d.khop_counts_2d`` on a mesh of
    ``mesh``'s shape (meta positions: nothing is allocated): the sharded
    input specs, the (F_l,) int32 counts, one gathered frontier (n rows of
    F_l int8, or of ceil(F_l / 32) words), k all-gathers and the psum of
    the counts."""
    del sentinel   # the zero row is appended after the gather
    mesh = _as_meta(mesh)
    args = _position0(mesh, graph2d.input_specs_2d(n, max_deg, f),
                      graph2d.shardings_2d(mesh, n, max_deg, f))
    rows_l, f_l = args[2].shape
    out = M.shard(mesh, torch.empty((f,), dtype=torch.int32,
                                    device="meta"), (frontier_spec(mesh),))[0]
    row_bytes = n_words(f_l) * 4 if packed else f_l
    gathered = rows_l * mesh.shape["data"] * row_bytes
    return _record(mesh, args, out, gathered, {
        "all-gather": {"count": k, "bytes": k * gathered},
        "all-reduce": {"count": 1, "bytes": out.nbytes}})


def pagerank_layout(mesh, n: int, max_deg: int, iters: int,
                    push_dtype=None) -> dict:
    """Per-position layout of ``graph2d.pagerank_2d`` on a mesh of
    ``mesh``'s shape (meta positions): the sharded specs, the (n_l,)
    float32 ranks, one gathered push vector in ``push_dtype``, and
    ``iters`` x (all-gather + psum of a float32 scalar)."""
    mesh = _as_meta(mesh)
    specs, shards = graph2d.pagerank_specs_2d(mesh, n, max_deg)
    args = _position0(mesh, specs, shards)
    out = M.shard(mesh, specs[2], shards[2])[0]
    item = torch.empty((), dtype=push_dtype or torch.float32).element_size()
    gathered = args[2].shape[0] * mesh.shape["data"] * item
    return _record(mesh, args, out, gathered, {
        "all-gather": {"count": iters, "bytes": iters * gathered},
        "all-reduce": {"count": iters, "bytes": iters * 4}})


def khop_cost(mesh, n: int, max_deg: int, f: int, k: int,
              packed: bool = False, sentinel: bool = False):
    """``(cost, temp)`` of position 0's ``k`` hops of
    ``graph2d.khop_counts_2d`` on meta tensors: its plain torch body
    (``graph2d.int8_hop`` / ``packed_hop``, the packing and the counts) by
    ``count_ops``, and each hop's ``ell_mxv_packed`` launch (the bitmap
    forms) by ``bitmap_mxv.launch_cost``, every padded slot valid. The
    gathered frontier is the layout's (allocated before); the kernel's
    output and the shard-local ELL's forms built once a call (its values,
    the CSR ids and the item plan's row words) are allocated in the run,
    their build not counted."""
    mesh = _as_meta(mesh)
    idx, msk, seeds = _position0(mesh, graph2d.input_specs_2d(n, max_deg, f),
                                 graph2d.shardings_2d(mesh, n, max_deg, f))
    rows, f_l = seeds.shape
    width = n_words(f_l) if packed else f_l
    x_full = torch.empty((rows * mesh.shape["data"], width), device="meta",
                         dtype=torch.int32 if packed else torch.int8)

    def body():
        # the shard-local ELL's values and the kernel's forms, live
        # through the hops
        forms = [torch.empty((rows, max_deg), device="meta"),
                 torch.empty((2, rows * max_deg), dtype=torch.int32,
                             device="meta")] if packed else []
        visited = bitmap.pack(seeds) if packed else seeds
        for _ in range(k):
            x = graph2d._zero_row(x_full) if sentinel else x_full
            if packed:
                words = torch.empty((rows, width), dtype=torch.int32,
                                    device="meta")
                _, visited = graph2d.packed_hop(words, visited)
            else:
                _, visited = graph2d.int8_hop(idx, msk, x, visited)
        graph2d.column_counts(visited, packed, f_l)
        return forms

    flops, nbytes, temp = count_ops(body)
    ops = 0
    if packed:
        kb, kops = bitmap_mxv.launch_cost(rows, max_deg, width,
                                          x_full.shape[0] + int(sentinel))
        nbytes, ops = nbytes + k * kb, k * kops
    return {"flops_per_device": flops, "int32_ops_per_device": ops,
            "bytes_per_device": nbytes,
            "bytes_counted": "eager aten traffic of the plain torch body"
                             + (" and each hop's ell_mxv_packed launch"
                                if packed else ""),
            "hops": k}, temp


def pagerank_cost(mesh, n: int, max_deg: int, iters: int,
                  push_dtype=None):
    """``(cost, temp)`` of position 0's ``iters`` PageRank steps of
    ``graph2d.pagerank_2d`` on meta tensors, all plain torch
    (``pagerank_init`` / ``push`` / ``_gather_sum`` / ``dangling_mass``
    / ``update``) by ``count_ops``; the gathered push vector is the
    layout's, the dangling mass's psum a scalar."""
    mesh = _as_meta(mesh)
    specs, shards = graph2d.pagerank_specs_2d(mesh, n, max_deg)
    idx, msk, deg = _position0(mesh, specs, shards)
    full = torch.empty((idx.shape[0] * mesh.shape["data"],),
                       dtype=push_dtype or torch.float32, device="meta")
    mass = torch.empty((), device="meta")

    def body():
        r, inv, dangling = graph2d.pagerank_init(deg, n)
        for _ in range(iters):
            graph2d.pagerank_push(r, inv, push_dtype)
            graph2d.dangling_mass(dangling, r)
            r = graph2d.pagerank_update(graph2d._gather_sum(idx, msk, full),
                                        mass, 0.85, n)

    flops, nbytes, temp = count_ops(body)
    return {"flops_per_device": flops, "int32_ops_per_device": 0,
            "bytes_per_device": nbytes,
            "bytes_counted": "eager aten traffic of the plain torch body",
            "iters": iters}, temp


def _write(outdir: str, rec: dict) -> dict:
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, rec["cell"] + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _cell(name, kind, multi_pod, outdir, layout, cost_of, cost=True):
    t0 = time.time()
    cell = f"graph_{name}__{kind}__{mesh_name(multi_pod)}"
    print(f"[dryrun] {cell} ...", flush=True)
    try:
        mesh = meta_mesh(multi_pod)
        lay = layout(mesh)
        rec = dict(cell=cell, arch=f"graph_{name}", shape=kind,
                   mesh=mesh_name(multi_pod), chips=lay["positions"],
                   kind="graph", status="ok", layout_only=not cost, **lay)
        if cost:
            c, temp = cost_of(mesh)
            mem = mem_stats(lay, temp)
            rl = roofline(lay["positions"], c["flops_per_device"],
                          c["bytes_per_device"],
                          lay["collective_bytes_per_device"],
                          c["int32_ops_per_device"])
            rec.update(cost=c, memory=mem, roofline=rl,
                       fits_hbm=mem["peak_per_device_bytes"]
                       < lay["card_bytes"])
            print(f"  ok: dom={rl['dominant']} "
                  f"bound={rl['bound_s'] * 1e3:.2f}ms  "
                  f"mem={mem['peak_per_device_bytes'] / 1e9:.2f}GB",
                  flush=True)
        else:
            print(f"  ok: args {lay['argument_bytes_per_position'] / 1e6:.1f}"
                  f" MB  gathered {lay['gathered_bytes_per_position'] / 1e6:.1f}"
                  f" MB  collectives "
                  f"{lay['collective_bytes_per_device'] / 1e6:.1f} MB per "
                  f"position", flush=True)
    except Exception as e:          # record failures as cells too
        rec = dict(cell=cell, arch=f"graph_{name}", shape=kind,
                   mesh=mesh_name(multi_pod), status="error",
                   error=f"{type(e).__name__}: {e}")
        print(f"  ERROR: {type(e).__name__}: {str(e)[:300]}", flush=True)
    rec["seconds"] = time.time() - t0
    return _write(outdir, rec)


def run_graph_cell(name: str, multi_pod: bool, outdir: str,
                   packed: bool = False, sentinel: bool = False,
                   cost: bool = True) -> dict:
    n, max_deg, fq, k = GRAPH_CELLS[name]
    form = dict(packed=packed, sentinel=sentinel)
    return _cell(name, khop_kind(packed, sentinel), multi_pod, outdir,
                 lambda mesh: khop_layout(mesh, n, max_deg, fq, k, **form),
                 lambda mesh: khop_cost(mesh, n, max_deg, fq, k, **form),
                 cost)


def run_pagerank_cell(name: str, multi_pod: bool, outdir: str,
                      iters: int = PAGERANK_ITERS, cost: bool = True) -> dict:
    n, max_deg, _, _ = GRAPH_CELLS[name]
    return _cell(name, "pagerank", multi_pod, outdir,
                 lambda mesh: pagerank_layout(mesh, n, max_deg, iters),
                 lambda mesh: pagerank_cost(mesh, n, max_deg, iters), cost)


# -- the model cells -----------------------------------------------------------------
_ACCUM = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LOGGED = {}        # (arch, shape, decode pos) -> the forward's annotations


def _one_layer(cfg):
    """``cfg`` with each layer stack cut to one layer (zamba2: one mamba
    block in each of two segments, so the shared block runs twice)."""
    kw = {"n_layers": 1}
    if cfg.family == "whisper":
        kw["encoder_layers"] = 1
    if cfg.family == "zamba2":
        kw = {"n_layers": 2, "shared_attn_every": 1}
    return dataclasses.replace(cfg, **kw)


def _annotations(cfg, shape):
    """``[(logical axes, shape)]`` of one forward of the cell on meta
    tensors (stacks cut to one layer), in call order."""
    key = (cfg.name, shape.name, shape.seq_len, shape.global_batch)
    if key not in _LOGGED:
        c = _one_layer(cfg)
        model = get_model(c)
        params = sh.as_meta(model.param_specs())
        rec = ShardCtx(_as_meta(Mesh(np.array([torch.device("meta")],
                                               dtype=object), ("model",))))
        with use(rec), torch.no_grad(), shapes_only():
            if shape.kind == "train":
                model.loss_fn(params, sh.as_meta(model.train_input_specs(
                    shape)))
            elif shape.kind == "prefill":
                b = sh.as_meta(model.train_input_specs(shape))
                b.pop("labels", None)
                model.prefill_fn(params, b)
            else:
                caches = sh.as_meta(model.cache_specs(shape.global_batch,
                                                      shape.seq_len))
                model.decode_fn(params, caches, sh.as_meta(
                    model.decode_input_specs(shape)), 0)
        _LOGGED[key] = [(lg, s) for lg, s, _ in rec.log]
    return _LOGGED[key]


def activation_layouts(cfg, shape, mesh, rules=None) -> list:
    """The distinct ``(logical axes, shape, spec)`` a forward of the cell
    logs under ``ShardCtx(mesh, rules)``, in order of first appearance."""
    ctx = ShardCtx(mesh, rules=rules)
    out = []
    for lg, s in _annotations(cfg, shape):
        if any(ctx.rules.get(l) == "skip" for l in lg if l):
            continue
        e = [list(lg), list(s), [list(a) if isinstance(a, tuple) else a
                                 for a in ctx.pspec(s, *lg)]]
        if e not in out:
            out.append(e)
    return out


def whole_of(t) -> int:
    return int(np.prod(t.shape or (1,))) * t.element_size()


def model_layout(cfg, shape, mesh, seq_to_model: bool = True, rules=None,
                 activations: bool = True) -> dict:
    """Per-position layout of one model cell on a mesh of ``mesh``'s shape
    (meta positions: nothing is allocated)."""
    mesh = _as_meta(mesh)
    model = get_model(cfg)
    params = sh.as_meta(model.param_specs())
    pshard = sh.param_shardings(params, mesh, cfg.vocab)
    whole = sum(whole_of(t) for t, s in sh.tree_items(params, pshard)
                if sh.spec_blocks(mesh, s) > 1)
    parts = {"params": sh.layout_bytes(params, pshard, mesh)}
    collectives = {}
    extra = {}
    if shape.kind == "train":
        state = opt_mod.init_fn(cfg.optimizer)(params)
        oshard = sh.opt_state_shardings(state, mesh, cfg.vocab)
        batch = sh.as_meta(model.train_input_specs(shape))
        bshard = sh.batch_shardings(batch, mesh)
        parts["opt_state"] = sh.layout_bytes(state, oshard, mesh)
        parts["batch"] = sh.layout_bytes(batch, bshard, mesh)
        out_bytes = 3 * 4                   # the metrics; the rest aliased
        accum = _ACCUM[cfg.grad_accum_dtype]
        blocks = sh.spec_blocks(mesh, bshard["tokens"][:1])
        collectives = step_collectives(
            layouts(params, pshard), mesh, batch_blocks=blocks,
            vocab=cfg.vocab, microbatches=cfg.microbatches,
            hoist=cfg.hoist_weight_gather, accum_dtype=accum,
            optimizer=cfg.optimizer,
            opt_cfg=opt_mod.OptConfig(name=cfg.optimizer))
        # the step keeps one part's gradient as autograd gives it (and a
        # hoisted one in the params' dtype)
        own = cfg.hoist_weight_gather or blocks * cfg.microbatches == 1
        gdt = lambda t: t.dtype if own else accum
        extra["gradient_bytes_per_position"] = sum(
            sh.block_bytes(tuple(t.shape), gdt(t), s, mesh)
            for t, s in sh.tree_items(params, pshard))
    else:
        # serving: each sharded param gathered whole for compute, and a
        # decode's cache gathered over its non-data axes
        gathers = [whole_of(t) for t, s in sh.tree_items(params, pshard)
                   if sh.spec_blocks(mesh, s) > 1]
        if shape.kind == "prefill":
            batch = sh.as_meta(model.train_input_specs(shape))
            batch.pop("labels", None)
            out_shape = (shape.global_batch, 1, cfg.vocab)
            out_spec = ShardCtx(mesh, rules).pspec(out_shape, "batch", None,
                                                   "vocab")
            out_bytes = sh.block_bytes(out_shape, torch.float32, out_spec,
                                       mesh)
        else:
            batch = sh.as_meta(model.decode_input_specs(shape))
            caches = sh.as_meta(model.cache_specs(shape.global_batch,
                                                  shape.seq_len))
            cshard = sh.cache_shardings(caches, mesh, shape.global_batch,
                                        seq_to_model)
            parts["caches"] = sh.layout_bytes(caches, cshard, mesh)
            parts["position"] = 4
            tok = (shape.global_batch,)
            out_bytes = sh.block_bytes(tok, torch.int32,
                                       sh.batch_pspec(tok, mesh), mesh)
            daxes = set(sh.data_axes(mesh))
            cache_gathers = []
            for t, s in sh.tree_items(caches, cshard):
                rest = [e if not (set(sh.axes_of(e)) & daxes) else None
                        for e in s]
                if sh.spec_blocks(mesh, rest) > 1:
                    cache_gathers.append(sh.spec_blocks(mesh, rest) * (
                        sh.block_bytes(tuple(t.shape), t.dtype, s, mesh)))
            extra["gathered_cache_bytes_per_position"] = sum(cache_gathers)
            gathers += cache_gathers
        bshard = sh.batch_shardings(batch, mesh)
        parts["batch"] = sh.layout_bytes(batch, bshard, mesh)
        if gathers:
            collectives["all-gather"] = {"count": len(gathers),
                                         "bytes": sum(gathers)}
    args = sum(parts.values())
    held = (args + out_bytes + whole
            + extra.get("gradient_bytes_per_position", 0)
            + extra.get("gathered_cache_bytes_per_position", 0))
    mem, source = card_memory()
    rec = dict(
        positions=mesh.size, mesh_shape=dict(mesh.shape),
        argument_bytes_per_position=args, argument_parts=parts,
        output_bytes_per_position=out_bytes,
        gathered_params_bytes_per_position=whole, **extra,
        collectives=collectives,
        collective_bytes_per_device=sum(c["bytes"]
                                        for c in collectives.values()),
        layout_bytes_per_position=held, card_bytes=mem, card=source,
        fits_hbm=held < mem)
    if activations:
        rec["activation_layouts"] = activation_layouts(cfg, shape, mesh,
                                                       rules)
    return rec


# -- the model cells' cost: one part counted on meta tensors -----------------------
_COUNTS = {}        # (cfg, kind, seq_len, part rows) -> (flops, bytes, temp)


def depth_points(cfg) -> list:
    """``[(cfg cut in depth, weight)]``: a count at ``cfg``'s depth is the
    weighted sum of the counts at these depths. Every layer of a stack runs
    the same ops, so a count is linear in each stack's layers, and the
    smallest depth that repeats each stack's pattern with one more pattern
    of each stack fixes it exactly: gemma2's (local, global) pair; whisper's
    encoder and decoder layers; zamba2's mamba blocks and the shared
    block's runs (one before each segment of ``shared_attn_every``)."""
    rep = dataclasses.replace
    if cfg.family == "whisper":
        e, d = cfg.encoder_layers, cfg.n_layers
        pts = [(rep(cfg, encoder_layers=1, n_layers=1), 3 - e - d),
               (rep(cfg, encoder_layers=2, n_layers=1), e - 1),
               (rep(cfg, encoder_layers=1, n_layers=2), d - 1)]
    elif cfg.family == "zamba2":
        m = cfg.n_layers
        s = -(-m // cfg.shared_attn_every)
        pts = [(rep(cfg, n_layers=1, shared_attn_every=1), 2 - m),
               (rep(cfg, n_layers=2, shared_attn_every=2), m - s),
               (rep(cfg, n_layers=2, shared_attn_every=1), s - 1)]
    else:
        p = 2 if cfg.local_global_alternating else 1
        if cfg.n_layers % p:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"repeat its {p}-layer pattern")
        k = cfg.n_layers // p
        pts = [(rep(cfg, n_layers=p), 2 - k), (rep(cfg, n_layers=2 * p),
                                               k - 1)]
    return [(c, w) for c, w in pts if w]


def part_fn(cfg, shape, rows: int, device="meta"):
    """One part of a cell at ``rows`` rows, as the port's schedule runs it
    with whole params: a train part's forward and backward
    (``train_step.part_grads``), a prefill's forward, a decode's serve
    step over the rows' whole cache (at its last slot). Its inputs are
    made before, on ``device`` (meta: nothing allocated; else the seed-0
    init and zero batches and caches)."""
    model = get_model(cfg)
    dev = torch.device(device)
    params = (sh.as_meta(model.param_specs()) if dev.type == "meta"
              else model.init(0, dev))
    part = dataclasses.replace(shape, global_batch=rows)
    if shape.kind == "train":
        batch = zeros_from_specs(model.train_input_specs(part), dev)
        whole = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        return lambda: part_grads(model, params, whole, batch)
    if shape.kind == "prefill":
        batch = zeros_from_specs(model.train_input_specs(part), dev)
        batch.pop("labels", None)
        return lambda: model.prefill_fn(params, batch)
    caches = zeros_from_specs(model.cache_specs(rows, shape.seq_len), dev)
    batch = zeros_from_specs(model.decode_input_specs(part), dev)
    step = make_serve_step(model)

    def decode():
        with torch.no_grad():
            step(params, caches, batch, shape.seq_len - 1)
    return decode


def part_count(cfg, shape, rows: int):
    """``(flops, bytes, temp)`` of one part (``part_fn``) at ``cfg``'s
    depth from the counts at ``depth_points`` (cached per config, kind,
    length and rows): the FLOPs and bytes exactly. The temporaries of a
    train part peak as the backward starts, every layer's saved inputs
    live: linear in depth too (exact for one stack; zamba2's shared block
    and whisper's two stacks move the peak by a few percent). Serving frees
    a layer's temporaries before the next layer runs: their peak is the
    points' largest."""
    key = (repr(cfg), shape.kind, shape.seq_len, rows)
    if key not in _COUNTS:
        got = [(count_ops(part_fn(c, shape, rows)), w)
               for c, w in depth_points(cfg)]
        flops, nbytes, temp = (sum(w * n[i] for n, w in got)
                               for i in range(3))
        if shape.kind != "train":
            temp = max(n[2] for n, _ in got)
        _COUNTS[key] = (flops, nbytes, temp)
    return _COUNTS[key]


def part_rows(cfg, shape, mesh):
    """``(rows, parts)`` a position computes under the port's schedule: its
    batch block (dim 0 over the data axes), a train cell's in
    ``cfg.microbatches`` parts."""
    model = get_model(cfg)
    specs = (model.decode_input_specs(shape) if shape.kind == "decode"
             else model.train_input_specs(shape))
    spec0 = sh.batch_shardings(sh.as_meta(specs), _as_meta(mesh))["tokens"]
    rows = shape.global_batch // sh.spec_blocks(mesh, spec0[:1])
    if shape.kind == "train":
        return rows // cfg.microbatches, cfg.microbatches
    return rows, 1


def cost_stats(cfg, shape, mesh):
    """``(cost, temp)`` of one cell a position (every position computes
    one batch block, so one stands for all): ``parts`` x one part's count
    (``part_count``; the update, the gradient sums and the collectives
    are not counted), and one part's temporaries."""
    rows, parts = part_rows(cfg, shape, mesh)
    flops, nbytes, temp = part_count(cfg, shape, rows)
    return {"flops_per_device": parts * flops,
            "bytes_per_device": parts * nbytes,
            "bytes_counted": "eager aten traffic: each op's operands and "
                             "results",
            "parts": parts, "part_rows": rows}, temp


def mem_stats(lay: dict, temp: int, alias: int = 0) -> dict:
    """The JAX module's memory keys for a cell: its arguments, its outputs
    (``alias`` bytes of them are arguments updated in place), the counted
    run's temporaries, and the peak: the layout's held bytes plus the
    temporaries."""
    return {"argument_size_in_bytes": lay["argument_bytes_per_position"],
            "output_size_in_bytes": lay["output_bytes_per_position"] + alias,
            "temp_size_in_bytes": temp,
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": alias,
            "peak_per_device_bytes": lay["layout_bytes_per_position"] + temp}


def cell_cost(cfg, shape, mesh, lay: dict) -> dict:
    """A model cell's ``cost``, ``memory`` and ``roofline`` on ``mesh``,
    whose layout (``model_layout``) is ``lay``: a train step updates the
    params and optimizer state in place, a decode step its caches."""
    cost, temp = cost_stats(cfg, shape, mesh)
    parts = lay["argument_parts"]
    alias = (parts["params"] + parts["opt_state"] if shape.kind == "train"
             else parts.get("caches", 0))
    return {"cost": cost, "memory": mem_stats(lay, temp, alias),
            "roofline": roofline(lay["positions"], cost["flops_per_device"],
                                 cost["bytes_per_device"],
                                 lay["collective_bytes_per_device"])}


def model_flops(cfg, shape, chips: int, flops_per_device=None) -> dict:
    """The JAX module's model FLOPs of a cell: 6 (train) or 2 (serving) x
    the active params x the tokens (one a sequence in decode), their share
    a chip and, given the counted FLOPs a device, the share of those they
    are."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    flops = (6 if shape.kind == "train" else 2) * cfg.active_param_count() \
        * tokens
    out = {"model_flops": flops, "model_flops_per_device": flops / chips}
    if flops_per_device is not None:
        out["useful_flops_ratio"] = (out["model_flops_per_device"]
                                     / max(flops_per_device, 1.0))
    return out


def cell_name(arch: str, shape_name: str, multi_pod: bool,
              tag: str = "") -> str:
    return f"{arch}__{shape_name}__{mesh_name(multi_pod)}{tag}"


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             seq_to_model: bool = True, tag: str = "", rules=None,
             cfg=None, cost: bool = True) -> dict:
    t0 = time.time()
    cell = cell_name(arch, shape_name, multi_pod, tag)
    print(f"[dryrun] {cell} ...", flush=True)
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    try:
        mesh = meta_mesh(multi_pod)
        lay = model_layout(cfg, shape, mesh, seq_to_model=seq_to_model,
                           rules=rules)
        chips = lay["positions"]
        rec = dict(cell=cell, arch=arch, shape=shape_name,
                   mesh=mesh_name(multi_pod), chips=chips,
                   kind=shape.kind, status="ok", layout_only=not cost,
                   **lay, n_params=cfg.param_count(),
                   n_active_params=cfg.active_param_count())
        counted = cell_cost(cfg, shape, mesh, lay) if cost else {}
        rec.update(counted, **model_flops(cfg, shape, chips, counted[
            "cost"]["flops_per_device"] if counted else None))
        if cost:
            mem, rl = rec["memory"], rec["roofline"]
            rec["fits_hbm"] = mem["peak_per_device_bytes"] < lay["card_bytes"]
            print(f"  ok: dom={rl['dominant']} "
                  f"bound={rl['bound_s'] * 1e3:.2f}ms  "
                  f"mem={mem['peak_per_device_bytes'] / 1e9:.2f}GB",
                  flush=True)
        else:
            print(f"  ok: args {lay['argument_bytes_per_position'] / 1e9:.2f}"
                  f" GB  collectives "
                  f"{lay['collective_bytes_per_device'] / 1e9:.2f} GB  held "
                  f"{lay['layout_bytes_per_position'] / 1e9:.2f} GB per "
                  f"position", flush=True)
    except Exception as e:          # record failures as cells too
        rec = dict(cell=cell, arch=arch, shape=shape_name,
                   mesh=mesh_name(multi_pod), status="error",
                   error=f"{type(e).__name__}: {e}")
        print(f"  ERROR: {type(e).__name__}: {str(e)[:300]}", flush=True)
    rec["seconds"] = time.time() - t0
    return _write(outdir, rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists and is ok")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--seq-to-model", default="1")
    ap.add_argument("--rule", action="append", default=[],
                    help="logical-axis rule override, e.g. seq_shard=skip "
                         "or batch=pod,data")
    ap.add_argument("--tag", default="", help="suffix for output cell names")
    ap.add_argument("--no-cost", action="store_true",
                    help="layout accounting only: no cost, memory or "
                         "roofline (seconds for all cells, where counting "
                         "takes minutes)")
    args = ap.parse_args(argv)
    if not (args.graph or args.arch or args.all):
        ap.error("nothing to run: pass --graph, --arch or --all")
    rules = {}
    for r in args.rule:
        k, v = r.split("=", 1)
        rules[k] = "skip" if v == "skip" else tuple(a for a in v.split(",")
                                                   if a)
    rules = rules or None
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    def done(cell):
        p = os.path.join(args.out, cell + ".json")
        if not os.path.exists(p):
            return False
        with open(p) as f:
            return json.load(f).get("status") == "ok"

    kinds = [("pagerank", None)] + [
        (khop_kind(*form), form)
        for form in ((False, False), (True, False), (True, True))]
    written = skip = err = 0
    for kind, form in (kinds if args.graph else []):
        for name in GRAPH_CELLS:
            for mp in meshes:
                if args.resume and done(
                        f"graph_{name}__{kind}__{mesh_name(mp)}"):
                    skip += 1
                    continue
                if form is None:
                    rec = run_pagerank_cell(name, mp, args.out,
                                            cost=not args.no_cost)
                else:
                    rec = run_graph_cell(name, mp, args.out, *form,
                                         cost=not args.no_cost)
                written += 1
                err += rec["status"] != "ok"
    archs = ARCHS if args.all else ([args.arch] if args.arch else [])
    for arch in archs:
        cfg = get_config(arch)
        shape_list = ([args.shape] if args.shape
                      else [s.name for s in shapes_for(cfg)])
        for shape_name in shape_list:
            if shape_name in cfg.skip_shapes:
                print(f"[dryrun] skip {arch} x {shape_name} (documented)")
                continue
            for mp in meshes:
                if args.resume and done(cell_name(arch, shape_name, mp,
                                                  args.tag)):
                    skip += 1
                    continue
                rec = run_cell(arch, shape_name, mp, args.out,
                               seq_to_model=args.seq_to_model == "1",
                               tag=args.tag, rules=rules, cfg=cfg,
                               cost=not args.no_cost)
                written += 1
                err += rec["status"] != "ok"
    print(f"[dryrun] done: {written} written ({err} errors), {skip} skipped "
          f"(resume)")
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())

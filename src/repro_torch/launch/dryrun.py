"""The dry-run: layout accounting of the model cells and of the paper's
graph workload cells. Port of ``repro.launch.dryrun``.

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
    layer logs the same);
  * ``fits``: arguments, outputs not aliased, the gathered params and
    gradient blocks against one card's memory (activations not counted).

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
  * whether arguments, outputs and one gathered frontier fit one card's
    memory (``torch.cuda`` when a card is present, else an H100's 80 GB,
    named so in the record).

XLA's ``memory_analysis`` / ``cost_analysis`` (``mem_stats``,
``cost_stats``) have no torch counterpart, and no roofline time is stated
(``roofline``): the TPU constants of the JAX module do not carry over and
no multi-card measurement exists. ``collective_stats``, the HLO text
parser, is kept for reading the JAX package's modules.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --mesh both --out DIR
  python -m repro_torch.launch.dryrun --all --mesh both --out DIR
  python -m repro_torch.launch.dryrun --graph --mesh both --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

import numpy as np
import torch

from repro_torch.configs import graph500, twitter
from repro_torch.configs.base import (ARCHS, SHAPES, get_config,
                                      shapes_for)
from repro_torch.core.bitmap import n_words
from repro_torch.core.shard import frontier_spec
from repro_torch.distr import graph2d
from repro_torch.distr import mesh as M
from repro_torch.distr import sharding as sh
from repro_torch.distr.mesh import Mesh
from repro_torch.distr.shardctx import ShardCtx, use
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import layouts, step_collectives

H100_BYTES = 80e9     # an H100's device memory (data sheet), without a card

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


def _write(outdir: str, rec: dict) -> dict:
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, rec["cell"] + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _cell(name, kind, multi_pod, outdir, layout):
    t0 = time.time()
    cell = f"graph_{name}__{kind}__{mesh_name(multi_pod)}"
    print(f"[dryrun] {cell} ...", flush=True)
    rec = dict(cell=cell, arch=f"graph_{name}", shape=kind,
               mesh=mesh_name(multi_pod), kind="graph", status="ok",
               layout_only=True, **layout(meta_mesh(multi_pod)))
    rec["seconds"] = time.time() - t0
    print(f"  ok: args {rec['argument_bytes_per_position'] / 1e6:.1f} MB  "
          f"gathered {rec['gathered_bytes_per_position'] / 1e6:.1f} MB  "
          f"collectives {rec['collective_bytes_per_device'] / 1e6:.1f} MB "
          f"per position", flush=True)
    return _write(outdir, rec)


def run_graph_cell(name: str, multi_pod: bool, outdir: str,
                   packed: bool = False, sentinel: bool = False) -> dict:
    n, max_deg, fq, k = GRAPH_CELLS[name]
    return _cell(name, khop_kind(packed, sentinel), multi_pod, outdir,
                 lambda mesh: khop_layout(mesh, n, max_deg, fq, k,
                                          packed=packed, sentinel=sentinel))


def run_pagerank_cell(name: str, multi_pod: bool, outdir: str,
                      iters: int = PAGERANK_ITERS) -> dict:
    n, max_deg, _, _ = GRAPH_CELLS[name]
    return _cell(name, "pagerank", multi_pod, outdir,
                 lambda mesh: pagerank_layout(mesh, n, max_deg, iters))


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
        with use(rec), torch.no_grad():
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
        gdt = lambda t: t.dtype if cfg.hoist_weight_gather else accum
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


def cell_name(arch: str, shape_name: str, multi_pod: bool,
              tag: str = "") -> str:
    return f"{arch}__{shape_name}__{mesh_name(multi_pod)}{tag}"


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             seq_to_model: bool = True, tag: str = "", rules=None,
             cfg=None) -> dict:
    t0 = time.time()
    cell = cell_name(arch, shape_name, multi_pod, tag)
    print(f"[dryrun] {cell} ...", flush=True)
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    try:
        lay = model_layout(cfg, shape, meta_mesh(multi_pod),
                           seq_to_model=seq_to_model, rules=rules)
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        n_active = cfg.active_param_count()
        rec = dict(cell=cell, arch=arch, shape=shape_name,
                   mesh=mesh_name(multi_pod), chips=lay["positions"],
                   kind=shape.kind, status="ok", layout_only=True, **lay,
                   n_params=cfg.param_count(), n_active_params=n_active,
                   model_flops=(6 if shape.kind == "train" else 2)
                   * n_active * tokens)
        print(f"  ok: args {rec['argument_bytes_per_position'] / 1e9:.2f} GB"
              f"  collectives {rec['collective_bytes_per_device'] / 1e9:.2f}"
              f" GB  held {rec['layout_bytes_per_position'] / 1e9:.2f} GB "
              f"per position", flush=True)
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
                    run_pagerank_cell(name, mp, args.out)
                else:
                    run_graph_cell(name, mp, args.out, *form)
                written += 1
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
                               tag=args.tag, rules=rules, cfg=cfg)
                written += 1
                err += rec["status"] != "ok"
    print(f"[dryrun] done: {written} written ({err} errors), {skip} skipped "
          f"(resume)")
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())

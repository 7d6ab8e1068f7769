"""The graph dry-run: layout accounting of the paper's workload cells.

Port of the graph half of ``repro.launch.dryrun``. Each cell is one probe
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

XLA's ``memory_analysis`` / ``cost_analysis`` have no torch counterpart,
and no roofline time is stated: the TPU constants of the JAX module do
not carry over and no multi-card measurement exists. The model cells of
the JAX dry-run are not ported (``--arch`` / ``--all`` raise).

Usage:
  python -m repro_torch.launch.dryrun --graph --mesh both --out DIR
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import graph500, twitter
from repro_torch.core.bitmap import n_words
from repro_torch.core.shard import frontier_spec
from repro_torch.distr import graph2d
from repro_torch.distr import mesh as M
from repro_torch.distr.mesh import Mesh
from repro_torch.launch.mesh import make_production_mesh

H100_BYTES = 80e9     # an H100's device memory (data sheet), without a card

# name: (n_vertices, max_deg, F queries, k)
GRAPH_CELLS = {cfg["name"]: (cfg["n_vertices"], cfg["max_deg"],
                             cfg["queries"], cfg["k"])
               for cfg in (graph500.GRAPH_CONFIG, twitter.GRAPH_CONFIG)}
PAGERANK_ITERS = 10


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists and is ok")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if args.arch or args.all:
        ap.error("the model cells (--arch / --all) are not ported: they "
                 "wait for the models and their steps, ROADMAP section "
                 "1.A.4")
    if not args.graph:
        ap.error("nothing to run: pass --graph")
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
    written = skip = 0
    for kind, form in kinds:
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
    print(f"[dryrun] done: {written} written, {skip} skipped (resume)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

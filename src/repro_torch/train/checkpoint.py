"""Atomic, async checkpointing (built in-repo) in the JAX package's layout.
Port of ``repro.train.checkpoint``.

Layout:   <dir>/step_<N>/
            manifest.json        # leaf paths, shapes, dtypes, hashes
            leaf_<i>.npy         # one file per JAX leaf
          <dir>/LATEST           # atomic pointer (write-tmp + rename)

Leaves are the JAX package's (``models.jax_leaves``): a stacked layer leaf
is one array, the port's per-layer tensors stacked on axis 0, written in
``jax.tree_util``'s flatten order under its keystr paths. The JAX restore
zips the manifest's leaves with its tree's by position, so that order is
what lets each package restore the other's checkpoints. A bfloat16 leaf is
written as ``np.save`` writes the JAX package's: its 2-byte patterns
(``|V2``) with ``"dtype": "bfloat16"`` in the manifest. The port reads it
back by that name; the JAX restore cannot (``jnp.asarray`` refuses
``|V2``).

Fault tolerance: writes go to step_<N>.tmp then a single atomic rename; a
crash mid-write never corrupts LATEST. ``restore`` checks each leaf's path,
shape and dtype against the tree it fills, and its sha1. Leaves are
written, read and hashed on a few threads at once.

Elastic restore: ``restore(..., shardings=)`` places each leaf onto the
mesh the restarted job has (``distr.sharding.place``), so the job can
resume on another data-parallel size; ``save`` takes a placed tree too and
writes it in the same layout (each distinct block copied to the host once).
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.distr import sharding as sh
from repro_torch.models.base import jax_leaves, tree_map
from repro_torch.models.convert import host_array


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _sha1(arr: np.ndarray) -> str:
    """sha1 of ``arr.tobytes()``, without the copy."""
    return hashlib.sha1(
        np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


def _copy_into(host: torch.Tensor, t):
    if isinstance(t, sh.Placed):
        sh.gather_leaf(t, out=host)
    else:
        host.copy_(t.detach())


def _host_leaves(tree):
    """``[(path, host array, dtype name)]``: copies of the tree's JAX
    leaves (tensors or ``Placed`` blocks), layers stacked, on the host."""
    out = []
    for path, ts, stacked in jax_leaves(tree):
        host = torch.empty(((len(ts),) if stacked else ())
                           + tuple(ts[0].shape), dtype=ts[0].dtype)
        for i, t in enumerate(ts):
            _copy_into(host[i] if stacked else host, t)
        out.append((path, host_array(host), _dtype_name(host)))
    return out


def _pool():
    """Threads for the leaves' files and hashes (both release the GIL)."""
    return concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1))


def _write(leaves, directory: str, step: int) -> str:
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)

    def leaf(i):
        path, arr, dtype = leaves[i]
        fn = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fn), arr)
        return {"path": path, "file": fn, "shape": list(arr.shape),
                "dtype": dtype, "sha1": _sha1(arr)}

    with _pool() as pool:
        manifest = {"step": step,
                    "leaves": list(pool.map(leaf, range(len(leaves))))}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # atomic LATEST pointer
    ptr_tmp = os.path.join(directory, "LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def save(tree, directory: str, step: int) -> str:
    """Write ``tree`` (a port tree of tensors: a ``ParamTree``, state, or
    a tuple of them) as step ``step``; returns the step's directory."""
    return _write(_host_leaves(tree), directory, step)


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


@torch.no_grad()
def restore(tree_like, directory: str, step: Optional[int] = None,
            shardings=None, verify: bool = True, mesh=None):
    """Copy a checkpoint into the tensors of ``tree_like``, in place:
    (tree_like, step). Each leaf's path, shape and dtype must equal the
    tree's, and (``verify``) its bytes the manifest's sha1.

    With ``shardings`` (a tree of specs in ``tree_like``'s nesting, from
    ``distr.sharding``) and ``mesh``, nothing is written into
    ``tree_like``, which may be meta tensors or ``Spec`` records: each
    leaf, read and checked, is placed onto the mesh (on a mesh of one
    device, copied there whole once, its blocks views of it; else each
    distinct block copied to each device once), and the placed tree is
    returned: (placed tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if shardings is not None:
        if mesh is None:
            raise ValueError("restore: shardings= needs the mesh (mesh=)")
        tree_like = sh.as_meta(tree_like)
        spec_of = {}
        tree_map(lambda t, s: spec_of.setdefault(id(t), s), tree_like,
                    shardings)
    groups = jax_leaves(tree_like)
    if len(manifest["leaves"]) != len(groups):
        raise ValueError(f"tree structure changed: {len(manifest['leaves'])} "
                         f"leaves in {d}, {len(groups)} in the tree")
    for meta, (path, ts, stacked) in zip(manifest["leaves"], groups):
        shape = ([len(ts)] if stacked else []) + list(ts[0].shape)
        want = (path, shape, _dtype_name(ts[0]))
        if (meta["path"], meta["shape"], meta["dtype"]) != want:
            raise ValueError(f"leaf {meta['file']} of {d} is {meta['path']} "
                             f"{meta['shape']} {meta['dtype']}; the tree's "
                             f"is {want}")

    def load(meta):
        arr = np.load(os.path.join(d, meta["file"]))
        if verify and _sha1(arr) != meta["sha1"]:
            raise IOError(f"checksum mismatch for {meta['path']}")
        return arr

    with _pool() as pool:           # every leaf checked before any is copied
        arrays = list(pool.map(load, manifest["leaves"]))
    placed = {}
    # one device: each tensor copied there once, its blocks views of it;
    # several: each distinct block copied to each device from the host
    to = mesh.home if shardings is not None and \
        mesh.distinct_devices == 1 else None
    for meta, (_, ts, stacked), arr in zip(manifest["leaves"], groups,
                                           arrays):
        if meta["dtype"] == "bfloat16":
            src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            src = torch.from_numpy(arr)
        for i, t in enumerate(ts):
            part = src[i] if stacked else src
            if shardings is None:
                t.copy_(part)
            else:
                placed[id(t)] = sh.place_leaf(
                    part if to is None else part.to(to), spec_of[id(t)],
                    mesh)
    if shardings is not None:
        return tree_map(lambda t: placed[id(t)], tree_like), step
    return tree_like, step


class AsyncCheckpointer:
    """Background-thread writer: training continues while the previous step
    serializes. The device-to-host copy happens on the caller's thread (the
    tensors may change after ``save`` returns); file IO and the removal of
    steps past the last ``keep`` happen off-thread. ``wait()`` joins the
    writer and raises what it raised."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, tree, step: int):
        leaves = _host_leaves(tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(leaves, step), daemon=True)
        self._thread.start()

    def _write(self, leaves, step):
        try:
            _write(leaves, self.directory, step)
            self._gc()
        except Exception as e:      # reported by wait()
            self._error = e

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

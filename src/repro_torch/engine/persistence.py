"""Snapshots and the append-only file (AOF): port of
``repro.engine.persistence``.

Snapshot + AOF tail = Redis-style point-in-time recovery: restore the
snapshot, then replay the AOF entries appended after it. ``engine.Database``
writes through the AOF helpers here: every mutating command is fsynced to
the log before ``Database.query`` returns, and replay streams the lines
back for the database to coalesce into deltas over one base build on the
first read (``Database._replay_aof``).

Both file formats are the JAX package's byte for byte (one command a line;
an ``np.savez_compressed`` archive with a JSON manifest), so each package
reads what the other wrote. Snapshots of delta-served graphs capture the
effective matrix: ``rel.A.to_coo()`` resolves to ``DeltaMatrix.to_coo``.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Iterator, Tuple

import numpy as np

from repro_torch.graph.graph import Graph, GraphBuilder


# -- AOF -----------------------------------------------------------------------
def aof_path(data_dir: str, name: str) -> str:
    return os.path.join(data_dir, f"{name}.aof")


def append_aof(path: str, text: str) -> None:
    """Append one mutating command, fsynced before the caller acks (the
    Redis appendfsync-always durability point)."""
    with open(path, "a") as f:
        f.write(text.replace("\n", " ") + "\n")
        f.flush()
        os.fsync(f.fileno())


def iter_aof(data_dir: str) -> Iterator[Tuple[str, str]]:
    """Yield (graph_name, command_line) across every AOF in the directory,
    in sorted-filename, append order: the replay stream."""
    for fn in sorted(os.listdir(data_dir)):
        if not fn.endswith(".aof"):
            continue
        name = fn[: -len(".aof")]
        with open(os.path.join(data_dir, fn)) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield name, line


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def save_snapshot(graph: Graph, path: str) -> None:
    """Atomic (write-temp + fsync + rename) snapshot, crash-safe like Redis
    RDB."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"n": np.asarray(graph.n)}
    manifest = {"n": graph.n, "relations": [], "labels": [], "props": []}
    for name, rel in graph.relations.items():
        r, c, v = rel.A.to_coo()
        payload[f"rel_{name}_r"] = np.asarray(r)
        payload[f"rel_{name}_c"] = np.asarray(c)
        payload[f"rel_{name}_v"] = np.asarray(v)
        manifest["relations"].append(name)
    for name, mask in graph.labels.items():
        payload[f"label_{name}"] = _host(mask)
        manifest["labels"].append(name)
    for name, col in graph.node_props.items():
        payload[f"prop_{name}"] = _host(col)
        manifest["props"].append(name)
    payload["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str, fmt: str = "auto", block: int = 64,
                  device="cuda") -> Graph:
    """The Graph a snapshot holds, built as ``fmt`` on ``device``."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        n = manifest["n"]
        b = GraphBuilder(n)
        for name in manifest["labels"]:
            b.add_label(name, np.nonzero(z[f"label_{name}"])[0])
        for name in manifest["props"]:
            col = z[f"prop_{name}"]
            ids = np.nonzero(~np.isnan(col))[0]
            b.set_prop(name, ids, col[ids])
        for name in manifest["relations"]:
            b.add_edges(name, z[f"rel_{name}_r"], z[f"rel_{name}_c"],
                        z[f"rel_{name}_v"])
        return b.build(fmt=fmt, block=block, device=device)

"""Property graph backed by sparse matrices — RedisGraph's data model.

Port of ``repro.graph.graph``: one boolean adjacency handle per relationship
type plus the union ``adj``, one boolean vector per node label, numeric
node properties as float32 columns (nan = absent), and an explicitly built
transpose linked into each handle. Every tensor of a graph lies on one
``device``; ``build`` places it on ``"cuda"`` unless told otherwise.

``from_arrays`` adopts storage arrays that already exist (for instance the
JAX package's, as ``np.asarray`` gives them) without rebuilding them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import bitmap, grb, ops
from repro_torch.core.bitadj import BitELL
from repro_torch.core.bsr import BSR
from repro_torch.core.ell import ELL


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the host")
    return dev


@dataclasses.dataclass
class Relation:
    name: str
    A: grb.GBMatrix    # row i -> out-neighbors; A.T is the linked transpose
    nnz: int

    @property
    def A_T(self) -> grb.GBMatrix:
        """Stored transpose, for pull-style traversals."""
        return self.A.T


@dataclasses.dataclass
class Graph:
    n: int
    relations: Dict[str, Relation]
    labels: Dict[str, torch.Tensor]            # label -> bool (n,)
    node_props: Dict[str, torch.Tensor]        # prop -> f32 (n,) (nan = absent)
    adj: Optional[Relation] = None             # union over relation types
    device: torch.device = torch.device("cpu")

    def relation(self, name: Optional[str]) -> Relation:
        if name is None:
            return self.adj
        return self.relations[name]

    def label_mask(self, label: Optional[str]) -> torch.Tensor:
        if label is None:
            return torch.ones(self.n, dtype=torch.bool, device=self.device)
        return self.labels[label]

    @property
    def nnz(self) -> int:
        return sum(r.nnz for r in self.relations.values())


class GraphBuilder:
    """Accumulates nodes/edges host-side, then freezes into device
    matrices."""

    def __init__(self, n: int):
        self.n = n
        self._edges: Dict[str, list] = {}
        self._labels: Dict[str, np.ndarray] = {}
        self._props: Dict[str, np.ndarray] = {}

    def add_label(self, label: str, node_ids) -> "GraphBuilder":
        mask = self._labels.setdefault(label, np.zeros(self.n, dtype=bool))
        mask[np.asarray(node_ids)] = True
        return self

    def set_prop(self, prop: str, node_ids, values) -> "GraphBuilder":
        col = self._props.setdefault(prop, np.full(self.n, np.nan, np.float32))
        col[np.asarray(node_ids)] = np.asarray(values, dtype=np.float32)
        return self

    def add_edges(self, rel: str, src, dst, weights=None) -> "GraphBuilder":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        w = (np.ones_like(src, dtype=np.float32) if weights is None
             else np.asarray(weights, dtype=np.float32))
        self._edges.setdefault(rel, []).append((src, dst, w))
        return self

    def build(self, fmt: str = "auto", block: int = 128,
              device="cuda") -> Graph:
        dev = _device(device)
        relations = {}
        all_src, all_dst = [], []
        for rel, chunks in self._edges.items():
            src = np.concatenate([c[0] for c in chunks])
            dst = np.concatenate([c[1] for c in chunks])
            w = np.concatenate([c[2] for c in chunks])
            src, dst, w = _dedup(src, dst, w, self.n)
            relations[rel] = Relation(
                rel, _make_handle(rel, src, dst, w, self.n, fmt, block, dev),
                nnz=len(src))
            all_src.append(src)
            all_dst.append(dst)
        adj = None
        if all_src:
            s = np.concatenate(all_src)
            d = np.concatenate(all_dst)
            s, d, w = _dedup(s, d, np.ones_like(s, np.float32), self.n)
            adj = Relation("", _make_handle("", s, d, w, self.n, fmt, block,
                                            dev), nnz=len(s))
        return Graph(
            n=self.n,
            relations=relations,
            labels={k: torch.from_numpy(v).to(dev)
                    for k, v in self._labels.items()},
            node_props={k: torch.from_numpy(v).to(dev)
                        for k, v in self._props.items()},
            adj=adj, device=dev)


def _dedup(src, dst, w, n):
    key = src * n + dst
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx], w[idx]


def _make(src, dst, w, n, fmt, block, device):
    if fmt == "bsr":
        return BSR.from_coo(src, dst, w, (n, n), block=block, device=device)
    if fmt == "ell":
        return ELL.from_coo(src, dst, w, (n, n), device=device)
    if fmt == "bitadj":
        return BitELL.from_coo(src, dst, w, (n, n), device=device)
    return ops.auto_format(src, dst, w, (n, n), block=block, device=device)


def _make_handle(name, src, dst, w, n, fmt, block,
                 device) -> grb.GBMatrix:
    """Build forward + transpose storage and link them into one handle."""
    A = grb.GBMatrix(_make(src, dst, w, n, fmt, block, device), name=name)
    A.link_transpose(grb.GBMatrix(_make(dst, src, w, n, fmt, block, device),
                                  name=name + "^T"))
    return A


# ---------------------------------------------------------------------------
# adopting existing storage arrays
# ---------------------------------------------------------------------------
def _store_from_arrays(arrays: dict, n: int, dev: torch.device):
    """ELL from ``indices/mask/values`` or BitELL from ``tiles/cols``
    (uint32 or int32 words), as numpy arrays, for an n x n relation."""
    if "tiles" in arrays:
        tiles = np.ascontiguousarray(arrays["tiles"]).view(np.int32)
        t = torch.from_numpy(tiles.copy()).to(dev)
        nnz = int(bitmap.popcount(t).sum())
        return BitELL(shape=(n, n), tiles=t,
                      cols=torch.from_numpy(
                          np.asarray(arrays["cols"], np.int32).copy()).to(dev),
                      nnz=nnz)
    mask = np.asarray(arrays["mask"], dtype=bool)
    return ELL(shape=(n, n),
               indices=torch.from_numpy(
                   np.asarray(arrays["indices"], np.int32).copy()).to(dev),
               mask=torch.from_numpy(mask.copy()).to(dev),
               values=torch.from_numpy(
                   np.asarray(arrays["values"], np.float32).copy()).to(dev),
               nnz=int(mask.sum()))


def from_arrays(n: int, relations: dict, adj=None, labels=None,
                node_props=None, device="cuda") -> Graph:
    """A Graph over existing storage arrays, rebuilding nothing.

    relations  name -> (forward, transpose), each a dict of numpy arrays:
               ``indices``/``mask``/``values`` (ELL) or ``tiles``/``cols``
               (BitELL, sentinel column tile C = ceil(n/32))
    adj        (forward, transpose) of the union relation, or None
    labels     label -> bool (n,);  node_props  prop -> float32 (n,)
    """
    dev = _device(device)

    def handle(name, pair):
        A = grb.GBMatrix(_store_from_arrays(pair[0], n, dev), name=name)
        A.link_transpose(grb.GBMatrix(_store_from_arrays(pair[1], n, dev),
                                      name=name + "^T"))
        return Relation(name, A, nnz=A.nvals)

    return Graph(
        n=n,
        relations={k: handle(k, v) for k, v in relations.items()},
        labels={k: torch.from_numpy(np.asarray(v, bool).copy()).to(dev)
                for k, v in (labels or {}).items()},
        node_props={k: torch.from_numpy(
            np.asarray(v, np.float32).copy()).to(dev)
            for k, v in (node_props or {}).items()},
        adj=handle("", adj) if adj is not None else None, device=dev)

"""A device mesh and its collectives, run by one controlling process.

This module stands where the JAX package uses ``jax.sharding.Mesh``,
``shard_map`` and ``jax.lax``'s collectives. A ``Mesh`` is an array of
``torch.device`` with one name per axis; the same device may fill several
positions, as the JAX tests force 8 host devices onto one CPU. One host
process drives every position: a sharded array is one tensor per position
(a Python list in the mesh's flat position order), and each collective is
an explicit tensor operation across the positions' devices. Between
distinct cards that is a peer copy; within one device a plain copy or sum,
and positions on one device that hold the same block share one tensor.

  shard / unshard     a global tensor <-> its per-position blocks under a
                      spec (one entry per dimension: None, an axis name or
                      a tuple of axis names, like ``PartitionSpec``);
  all_gather          tiled along dimension 0 over one axis;
  psum_scatter        tiled, ``scatter_dimension=0``;
  psum, pmin, pmax    the reduction over one axis, replicated;
  axis_index          each position's index along an axis.

A global tensor, the JAX package's GSPMD array, is a tensor on the mesh's
first device (``Mesh.home``). Nothing here imports ``torch.distributed``:
one process drives every card, so the engine above stays the JAX
package's single-controller engine.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An n-d array of ``torch.device`` (repeats allowed) with named axes.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does; two meshes are equal when their axis names, shapes and devices
    agree position by position. A bare ``"cuda"`` is the current card."""
    __slots__ = ("devices", "axis_names", "shape", "_key")

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        axis_names = tuple(axis_names)
        if len(axis_names) != arr.ndim:
            raise ValueError(f"Mesh: {len(axis_names)} axis names for a "
                             f"{arr.ndim}-d device array")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: repeated axis names {axis_names}")
        devs = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(arr.reshape(-1)):
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.reshape(-1)[i] = d
        self.devices = devs
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, arr.shape))
        self._key = (axis_names, arr.shape,
                     tuple(str(d) for d in devs.reshape(-1)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The first position's device: where global tensors live."""
        return self.devices.reshape(-1)[0]

    @property
    def device_list(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    @property
    def distinct_devices(self) -> int:
        return len({str(d) for d in self.device_list})

    def device_at(self, pos: int) -> torch.device:
        return self.devices.reshape(-1)[pos]

    def coords(self, pos: int) -> Dict[str, int]:
        """Position ``pos``'s index along every axis."""
        idx = np.unravel_index(pos, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {self.distinct_devices} device(s))"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_index(mesh: Mesh, coords: Dict[str, int], axes) -> int:
    """The block a position holds along a dimension sharded over ``axes``
    (the first axis major, as ``PartitionSpec`` orders a tuple)."""
    b = 0
    for a in axes:
        b = b * mesh.shape[a] + coords[a]
    return b


def _blocks(mesh: Mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes] or [1]))


def axis_index(mesh: Mesh, axis: str) -> List[int]:
    """Each position's index along ``axis``."""
    return [mesh.coords(i)[axis] for i in range(mesh.size)]


def shard(mesh: Mesh, x: torch.Tensor, spec) -> List[torch.Tensor]:
    """The per-position blocks of the global ``x`` under ``spec``: views
    where a position lies on ``x``'s device, one copy per (block, device)
    elsewhere. Every sharded dimension must divide evenly."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    cache: Dict[tuple, torch.Tensor] = {}
    out = []
    for i in range(mesh.size):
        c = mesh.coords(i)
        key, part = [], x
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if not axes:
                continue
            nb = _blocks(mesh, axes)
            if x.shape[dim] % nb:
                raise ValueError(f"shard: dimension {dim} of size "
                                 f"{x.shape[dim]} does not split over "
                                 f"{axes} ({nb} blocks)")
            b = _block_index(mesh, c, axes)
            size = x.shape[dim] // nb
            part = part.narrow(dim, b * size, size)
            key.append(b)
        dev = mesh.device_at(i)
        k = (tuple(key), str(dev))
        if k not in cache:
            cache[k] = part if part.device == dev else part.to(dev)
        out.append(cache[k])
    return out


def unshard(mesh: Mesh, xs: List[torch.Tensor], spec) -> torch.Tensor:
    """The global tensor on ``mesh.home`` from per-position blocks under
    ``spec`` (replicated dimensions are read from the first position that
    holds each block)."""
    home = mesh.home
    spec = tuple(spec) + (None,) * (xs[0].dim() - len(spec))
    nbs = [_blocks(mesh, _axes(e)) for e in spec]
    parts: Dict[tuple, torch.Tensor] = {}
    for i in range(mesh.size):
        c = mesh.coords(i)
        key = tuple(_block_index(mesh, c, _axes(e)) if _axes(e) else 0
                    for e in spec)
        parts.setdefault(key, xs[i])

    def build(prefix):
        d = len(prefix)
        if d == len(spec):
            t = parts[prefix]
            return t if t.device == home else t.to(home)
        pieces = [build(prefix + (b,)) for b in range(nbs[d])]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=d)

    return build(())


def _groups(mesh: Mesh, axis: str) -> List[List[int]]:
    """For each position, the positions of its group along ``axis`` (its
    coordinates on every other axis), in axis order."""
    ax = mesh.axis_names.index(axis)
    idx = np.arange(mesh.size).reshape(mesh.devices.shape)
    out = [None] * mesh.size
    lines = np.moveaxis(idx, ax, -1).reshape(-1, mesh.devices.shape[ax])
    for line in lines:
        members = [int(p) for p in line]
        for p in members:
            out[p] = members
    return out


def _per_group(mesh: Mesh, xs: List[torch.Tensor], axis: str, combine):
    """``combine(blocks on the position's device)`` once per (group,
    device), shared by the group's positions on that device."""
    groups = _groups(mesh, axis)
    cache: Dict[tuple, torch.Tensor] = {}
    out = []
    for i in range(mesh.size):
        dev = mesh.device_at(i)
        k = (tuple(groups[i]), str(dev))
        if k not in cache:
            cache[k] = combine([xs[j] if xs[j].device == dev else
                                xs[j].to(dev) for j in groups[i]])
        out.append(cache[k])
    return out


def all_gather(mesh: Mesh, xs: List[torch.Tensor], axis: str
               ) -> List[torch.Tensor]:
    """Tiled all-gather along dimension 0 over ``axis``: every position
    gets its group's blocks concatenated in axis order."""
    return _per_group(mesh, xs, axis,
                      lambda bs: bs[0] if len(bs) == 1 else torch.cat(bs))


def _fold(op):
    def combine(bs):
        acc = bs[0].clone()
        for b in bs[1:]:
            acc = op(acc, b)
        return acc
    return combine


def psum(mesh: Mesh, xs: List[torch.Tensor], axis: str) -> List[torch.Tensor]:
    """Sum over ``axis``, in axis order, replicated over the group."""
    return _per_group(mesh, xs, axis, _fold(torch.add))


def pmin(mesh: Mesh, xs: List[torch.Tensor], axis: str) -> List[torch.Tensor]:
    return _per_group(mesh, xs, axis, _fold(torch.minimum))


def pmax(mesh: Mesh, xs: List[torch.Tensor], axis: str) -> List[torch.Tensor]:
    return _per_group(mesh, xs, axis, _fold(torch.maximum))


def psum_scatter(mesh: Mesh, xs: List[torch.Tensor], axis: str
                 ) -> List[torch.Tensor]:
    """Tiled reduce-scatter along dimension 0 over ``axis``: the sum over
    the group, of which position k keeps row block k."""
    total = psum(mesh, xs, axis)
    size = mesh.shape[axis]
    rows = xs[0].shape[0]
    if rows % size:
        raise ValueError(f"psum_scatter: {rows} rows do not split over "
                         f"{axis!r} ({size})")
    step = rows // size
    return [t.narrow(0, k * step, step)
            for t, k in zip(total, axis_index(mesh, axis))]

"""Sharding policy: params / inputs / caches -> specs on the mesh, and the
placement of a tree onto a ``distr.mesh.Mesh``. Port of
``repro.distr.sharding``.

Scheme: 2D FSDP x TP for LM weights — "model" on the last divisible dim
(column parallel), the data axis-group on the largest remaining divisible
dim (FSDP); stacked layer dims (scan) never shard. Embeddings are
special-cased so logits come out vocab-sharded on "model". Optimizer state
inherits its parameter's spec. Caches: batch -> data group, sequence -> the
largest remaining group (flash-decode style; batch=1 long-context shards the
sequence over the whole mesh).

A spec is the tuple ``distr.mesh.shard`` takes (the JAX package's
``PartitionSpec``): one entry per dimension, ``None``, an axis name or a
tuple of axis names. The rules read the JAX package's leaves: its keystr
paths and stacked shapes (``models.jax_leaves``). A stacked JAX leaf is a
list of per-layer tensors here; its JAX spec has ``None`` on the layer dim,
and each layer tensor takes the rest of it. ``param_shardings`` and the
other ``*_shardings`` functions return a tree in the port's nesting (of a
``ParamTree``, state dicts, batch dicts, cache tuples and lists) holding
one spec per tensor; a tree of ``Spec`` records or of meta tensors gives
the same specs as real tensors, with nothing allocated.

``place`` is the port's ``jax.device_put(tree, shardings)``: each tensor
becomes a ``Placed`` leaf, its per-position blocks (``distr.mesh.shard``;
positions on one device that hold the same block share one tensor).
``gather`` is the inverse (the port's ``np.asarray`` of a sharded array).
"""
from __future__ import annotations

import functools
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distr import mesh as M
from repro_torch.models.base import Spec, jax_leaves, tree_map


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _prod(mesh, axes) -> int:
    p = 1
    for a in axes:
        p *= mesh.shape[a]
    return p


def _fits(dim: int, size: int) -> bool:
    return dim >= size and dim % size == 0


STACKED = re.compile(r"(layers|segments|enc_layers|dec_layers|seg\d+)")
EMBED = re.compile(r"(embed|tok|out)\b|vision_proj|front_proj")
# Row-parallel (Megatron pairing): these matrices CONSUME a model-sharded
# activation (ff hidden / attention heads), so "model" must sit on their
# contraction (second-to-last) dim; the generic greedy would put it on the
# output dim.
ROW_PARALLEL = re.compile(r"\['(wd|wo|wcv|out_proj)'\]")


def param_pspec(path: str, shape, mesh, vocab: Optional[int] = None) -> tuple:
    """The JAX package's spec of the leaf at keystr ``path`` with the JAX
    (stacked) ``shape``."""
    shape = tuple(shape)
    ndim = len(shape)
    spec = [None] * ndim
    if ndim == 0:
        return ()
    skip = set()
    if STACKED.search(path):
        skip.add(0)
    model = mesh.shape["model"]
    dgroup = data_axes(mesh)
    dsize = _prod(mesh, dgroup)

    # embeddings: model on the vocab-sized dim -> vocab-sharded logits
    if EMBED.search(path) and vocab is not None and vocab in shape:
        vdim = shape.index(vocab)
        if _fits(shape[vdim], model):
            spec[vdim] = "model"
        for i in reversed(range(ndim)):
            if i != vdim and i not in skip and _fits(shape[i], dsize):
                spec[i] = dgroup if len(dgroup) > 1 else dgroup[0]
                break
        return tuple(spec)

    # row-parallel down/out projections: model on the contraction dim
    if ROW_PARALLEL.search(path) and ndim >= 2 and _fits(shape[-2], model):
        spec[-2] = "model"
        if _fits(shape[-1], dsize):
            spec[-1] = dgroup if len(dgroup) > 1 else dgroup[0]
        return tuple(spec)

    # generic greedy: model -> last divisible dim; data -> largest remaining
    mdim = None
    for i in reversed(range(ndim)):
        if i not in skip and _fits(shape[i], model):
            mdim = i
            spec[i] = "model"
            break
    best, best_sz = None, 0
    for i in range(ndim):
        if i in skip or i == mdim:
            continue
        if _fits(shape[i], dsize) and shape[i] > best_sz:
            best, best_sz = i, shape[i]
    if best is not None:
        spec[best] = dgroup if len(dgroup) > 1 else dgroup[0]
    return tuple(spec)


# -- trees -----------------------------------------------------------------------
def tree_items(tree, *rest) -> list:
    """The leaves of ``tree`` (``models.base.tree_map``'s), with ``rest``'s
    alongside as tuples (their leaves may be specs: tuples), in its
    order."""
    out = []
    tree_map(lambda *x: out.append(x if rest else x[0]), tree, *rest)
    return out


def as_meta(tree):
    """A tree of ``Spec`` records (or tensors) as meta tensors of the same
    shapes and dtypes: what ``jax_leaves`` reads, with nothing allocated."""
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta"), tree)


class LayerSpec(tuple):
    """The spec of one layer of a stacked JAX leaf whose JAX spec shards
    the layer dim too (``param_pspec``'s row-parallel rule on a per-layer
    vector: Adafactor's factored statistics of ``wo`` / ``wd`` when the
    depth divides over "model"). The tuple is the layer tensor's spec;
    ``layer_axes`` shard the layers, and only the positions whose block
    along them is ``layer_block`` hold this layer."""
    layer_axes: tuple
    layer_block: int

    def __new__(cls, spec, layer_axes, layer_block):
        self = super().__new__(cls, spec)
        self.layer_axes = layer_axes
        self.layer_block = layer_block
        return self


def stacked_spec(specs, stacked: bool) -> tuple:
    """The JAX spec of a JAX leaf from its layers' specs."""
    s = specs[0]
    if not stacked:
        return tuple(s)
    first = None
    if isinstance(s, LayerSpec):
        first = s.layer_axes if len(s.layer_axes) > 1 else s.layer_axes[0]
    return (first,) + tuple(s)


def _path_specs(tree, mesh, vocab):
    """The port's nesting of ``tree`` with each tensor's spec from its JAX
    leaf's ``param_pspec`` (the layer dim dropped for stacked leaves)."""
    meta = as_meta(tree)
    by_id: Dict[int, tuple] = {}
    for path, ts, stacked in jax_leaves(meta):
        shape = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
        spec = param_pspec(path, shape, mesh, vocab)
        for i, t in enumerate(ts):
            if stacked and spec[0] is not None:
                axes = axes_of(spec[0])
                per = len(ts) // M._blocks(mesh, axes)
                by_id[id(t)] = LayerSpec(spec[1:], axes, i // per)
            else:
                by_id[id(t)] = spec[1:] if stacked else spec
    return tree_map(lambda t: by_id[id(t)], meta)


def param_shardings(params_or_specs, mesh, vocab: Optional[int] = None):
    """Each param tensor's spec, in the params' nesting (a ``ParamTree``, its
    ``param_specs()`` or any tree in their nesting)."""
    return _path_specs(params_or_specs, mesh, vocab)


def opt_state_shardings(opt_state, mesh, vocab: Optional[int] = None):
    """Optimizer moments shard like their parameters (same shapes -> same
    inference); factored Adafactor rows/cols and scalars get their own."""
    return _path_specs(opt_state, mesh, vocab)


def batch_pspec(shape, mesh) -> tuple:
    """Input batches: dim0 = batch over the data group (when divisible)."""
    dgroup = data_axes(mesh)
    spec = [None] * len(shape)
    if shape and _fits(shape[0], _prod(mesh, dgroup)):
        spec[0] = dgroup if len(dgroup) > 1 else dgroup[0]
    elif shape and "data" in mesh.axis_names and _fits(shape[0],
                                                       mesh.shape["data"]):
        spec[0] = "data"
    return tuple(spec)


def batch_shardings(batch_specs, mesh):
    return tree_map(lambda s: batch_pspec(tuple(s.shape), mesh), batch_specs)


def cache_pspec(shape, mesh, batch: int, seq_to_model: bool = True) -> tuple:
    """KV caches / recurrent states.

    batch > 1 : batch dim -> data group; longest (sequence) dim -> "model".
    batch == 1: longest dim -> the whole mesh (pod x data x model) — the
    long_500k layout; every position holds a slice of the one sequence.
    """
    shape = tuple(shape)
    ndim = len(shape)
    spec = [None] * ndim
    dgroup = data_axes(mesh)
    model = mesh.shape["model"]
    used = set()
    if batch > 1:
        for i, d in enumerate(shape):
            if d == batch and _fits(d, _prod(mesh, dgroup)):
                spec[i] = dgroup if len(dgroup) > 1 else dgroup[0]
                used.add(i)
                break
        if seq_to_model:
            # largest remaining dim gets "model"
            cands = [(d, i) for i, d in enumerate(shape)
                     if i not in used and i != 0 and _fits(d, model)]
            if cands:
                d, i = max(cands)
                spec[i] = "model"
    else:
        all_axes = dgroup + ("model",)
        total = _prod(mesh, all_axes)
        cands = [(d, i) for i, d in enumerate(shape)
                 if i != 0 and _fits(d, total)]
        if cands:
            d, i = max(cands)
            spec[i] = all_axes
        else:
            cands = [(d, i) for i, d in enumerate(shape)
                     if i != 0 and _fits(d, model)]
            if cands:
                d, i = max(cands)
                spec[i] = "model"
    return tuple(spec)


def cache_shardings(cache_specs_tree, mesh, batch: int,
                    seq_to_model: bool = True):
    return tree_map(
        lambda s: cache_pspec(tuple(s.shape), mesh, batch, seq_to_model),
        cache_specs_tree)


# -- placement ---------------------------------------------------------------------
def axes_of(entry) -> Tuple[str, ...]:
    return M._axes(entry)


def _nblocks(mesh, entry) -> int:
    n = 1
    for a in axes_of(entry):
        n *= mesh.shape[a]
    return n


def spec_blocks(mesh, spec) -> int:
    """How many blocks a spec cuts a tensor into."""
    n = 1
    for e in spec:
        n *= _nblocks(mesh, e)
    return n


def block_shape(shape, spec, mesh) -> tuple:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, e in zip(shape, spec):
        nb = _nblocks(mesh, e)
        if d % nb:
            raise ValueError(f"dimension of size {d} does not split over "
                             f"{axes_of(e)} ({nb} blocks)")
        out.append(d // nb)
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def _layout(mesh, spec: tuple, shape: tuple):
    """(block shape, each position's block index along each dim, each
    position's block as slices of the global tensor)."""
    bshape = block_shape(shape, spec, mesh)
    keys = [tuple(M._block_index(mesh, mesh.coords(pos), axes_of(e))
                  for e in spec) for pos in range(mesh.size)]
    slices = [tuple(slice(k * b, (k + 1) * b) for k, b in zip(key, bshape))
              for key in keys]
    return bshape, keys, slices


def block_bytes(shape, dtype, spec, mesh) -> int:
    """The bytes of one block; of a ``LayerSpec`` layer, its share of a
    position's (the layers spread evenly over the layer axes' blocks)."""
    item = torch.empty((), dtype=dtype).element_size()
    n = int(np.prod(block_shape(shape, spec, mesh) or (1,))) * item
    if isinstance(spec, LayerSpec):
        n //= _nblocks(mesh, spec.layer_axes)
    return n


class Placed:
    """A global tensor as its per-position blocks on a mesh: ``blocks[i]``
    is position i's (positions on one device that hold the same block
    share one tensor; ``None`` where a ``LayerSpec`` layer is not held).
    ``shape`` / ``dtype`` are the global tensor's."""
    __slots__ = ("mesh", "spec", "shape", "dtype", "blocks")

    def __init__(self, mesh, spec, shape, dtype, blocks):
        self.mesh = mesh
        self.spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks = list(blocks)

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def block_shape(self) -> tuple:
        return _layout(self.mesh, self.spec, self.shape)[0]

    def key(self, pos: int) -> tuple:
        """The block position ``pos`` holds: its index along each dim."""
        return _layout(self.mesh, self.spec, self.shape)[1][pos]

    def slices(self, pos: int) -> tuple:
        """Position ``pos``'s block as slices of the global tensor."""
        return _layout(self.mesh, self.spec, self.shape)[2][pos]

    def distinct(self) -> List[int]:
        """One position for each distinct block, in block order: what a
        reduction over the global tensor counts once."""
        seen = {}
        for pos in range(self.mesh.size):
            if self.blocks[pos] is not None:
                seen.setdefault(self.key(pos), pos)
        return [seen[k] for k in sorted(seen)]

    def local(self) -> List[int]:
        """One position for each distinct tensor (a block on a device): what
        an update in place writes once."""
        seen, out = set(), []
        for pos, t in enumerate(self.blocks):
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                out.append(pos)
        return out

    def nbytes_at(self, pos: int) -> int:
        t = self.blocks[pos]
        return 0 if t is None else t.numel() * t.element_size()

    def __repr__(self) -> str:
        return (f"Placed({list(self.shape)}, {self.dtype}, spec={self.spec}, "
                f"{len(self.local())} tensor(s))")


def place_leaf(x: torch.Tensor, spec, mesh) -> Placed:
    blocks = M.shard(mesh, x, tuple(spec))
    if isinstance(spec, LayerSpec):     # only the layer's holders keep it
        blocks = [t if M._block_index(mesh, mesh.coords(pos),
                                      spec.layer_axes) == spec.layer_block
                  else None for pos, t in enumerate(blocks)]
    return Placed(mesh, tuple(spec), tuple(x.shape), x.dtype, blocks)


def blocks_like(x: Placed, make) -> Placed:
    """A ``Placed`` of ``x``'s layout whose tensor for each distinct
    (block, device) is ``make(pos)``, shared as ``x``'s is."""
    made = {}
    for pos in x.local():
        made[id(x.blocks[pos])] = make(pos)
    t0 = next(iter(made.values()))
    return Placed(x.mesh, x.spec, x.shape, t0.dtype,
                  [None if t is None else made[id(t)] for t in x.blocks])


def place(tree, shardings, mesh):
    """``tree`` (a port tree of tensors) as a tree of ``Placed`` leaves
    under ``shardings`` (a tree of specs in its nesting)."""
    return tree_map(lambda t, s: place_leaf(t, s, mesh), tree, shardings)


def gather_leaf(x: Placed, device=None, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The global tensor of ``x`` on ``device`` (the mesh's home by
    default), or written into ``out``: each distinct block copied once,
    assembled on the mesh's home and then moved whole (a block is a
    strided slice of the global tensor: one copy a leaf, not a strided
    copy a block, crosses between devices)."""
    home = x.mesh.home
    dev = torch.device(out.device if out is not None
                       else device if device is not None else home)
    if dev != home:
        whole = gather_leaf(x)
        if out is None:
            return whole.to(dev)
        return out.copy_(whole)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=home)
    for pos in x.distinct():
        out[x.slices(pos)].copy_(x.blocks[pos])
    return out


def gather(tree, device=None):
    """The inverse of ``place``: a tree of global tensors."""
    return tree_map(lambda x: gather_leaf(x, device)
                    if isinstance(x, Placed) else x, tree)


def position_bytes(tree, pos: int) -> int:
    """The bytes position ``pos`` holds of a placed tree."""
    return sum(x.nbytes_at(pos) for x in tree_items(tree)
               if isinstance(x, Placed))


def layout_bytes(tree, shardings, mesh) -> int:
    """The bytes one position holds of ``tree`` (tensors, meta tensors or
    ``Spec`` records) under ``shardings``, without placing it: every
    position holds a block of the same size."""
    return sum(block_bytes(tuple(t.shape), t.dtype, s, mesh)
               for t, s in tree_items(tree, shardings))

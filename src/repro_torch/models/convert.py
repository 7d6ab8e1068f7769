"""The port's per-layer trees read as the JAX package's stacked ones.

The JAX package stacks a scan's layers on axis 0; the port keeps one entry
per layer: ``layers`` (transformer, rwkv6), zamba2's ``segments`` (a list
of segments, ``segments/seg{i}`` there) and whisper's ``enc_layers`` /
``dec_layers``. Gradients and optimizer state follow the params' nesting.

(``models.base.jax_leaves`` reads any such tree as the JAX package's
leaves.)

- ``params_from_numpy``: a JAX-layout tree of numpy arrays, as
  ``jax.tree.map(np.asarray, params)`` gives it, into the port's
  ``ParamTree``, every leaf checked against ``param_specs`` (shape and
  dtype) before it is placed;
- ``params_to_numpy``: its inverse, for the JAX side of the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.base import (ParamTree, as_tree, map_specs,
                                     resolve_device, tree_leaves)
from repro_torch.models.registry import get_model

_STACKED = ("layers", "enc_layers", "dec_layers")


def _unstack(node, n: int):
    if isinstance(node, dict):
        parts = {k: _unstack(v, n) for k, v in node.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return [node[i] for i in range(n)]


def _layer_count(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


def _port_layout(tree: dict) -> dict:
    out = {}
    for k, v in tree.items():
        if k in _STACKED:
            out[k] = _unstack(v, _layer_count(v))
        elif k == "segments":
            out[k] = [_unstack(v[f"seg{i}"], _layer_count(v[f"seg{i}"]))
                      for i in range(len(v))]
        else:
            out[k] = v
    return out


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy as numpy; bfloat16 as its 2-byte patterns
    (``|V2``: what ``np.save`` keeps of the JAX package's bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view("V2")
    return t.cpu().numpy()


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _n_leaves(node) -> int:
    if isinstance(node, dict):
        return sum(_n_leaves(v) for v in node.values())
    if isinstance(node, list):
        return sum(_n_leaves(v) for v in node)
    return 1


def params_from_numpy(cfg, tree: dict, device="cuda") -> ParamTree:
    """The port's params for ``cfg`` from the JAX package's param tree."""
    dev = resolve_device(device)
    layout = _port_layout(tree)
    specs = get_model(cfg).param_specs()
    if _n_leaves(layout) != _n_leaves(specs):
        raise ValueError(f"the tree has {_n_leaves(layout)} leaves, the "
                         f"port's {cfg.name} has {_n_leaves(specs)}")

    def leaf(path, s):
        node = layout
        for key in path:
            node = node[key]
        t = _tensor(node)
        if tuple(t.shape) != s.shape or t.dtype != s.dtype:
            raise ValueError(
                f"param {'/'.join(map(str, path))}: got {tuple(t.shape)} "
                f"{t.dtype}, the port's spec is {s.shape} {s.dtype}")
        return t.to(dev)

    return ParamTree(map_specs(leaf, specs))


def params_to_numpy(cfg, params) -> dict:
    """The JAX-layout tree of ``params`` (or of a tree in their nesting,
    such as gradients) as numpy arrays, layers stacked on axis 0: what the
    JAX package's functions take for ``cfg``."""
    tree = as_tree(params)
    want = []
    map_specs(lambda _, s: want.append(s.shape), get_model(cfg).param_specs())
    if [tuple(t.shape) for t in tree_leaves(tree)] != want:
        raise ValueError(f"the tree's leaves are not {cfg.name}'s params")

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    def jax_layout(node):
        if isinstance(node, dict):
            return {k: jax_layout(v) for k, v in node.items()}
        if isinstance(node, list):
            if isinstance(node[0], list):
                return {f"seg{i}": jax_layout(s) for i, s in enumerate(node)}
            return stack([jax_layout(x) for x in node])
        return host_array(node)

    return jax_layout(tree)

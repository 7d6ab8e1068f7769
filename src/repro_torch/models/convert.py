"""Carry a JAX-layout param tree across: nested dicts of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives them from the JAX package, into
the port's ``ParamTree``.

The JAX package stacks a scan's layers on axis 0; the port keeps one entry
per layer. So ``layers`` (transformer, rwkv6), zamba2's
``segments/seg{i}`` and whisper's ``enc_layers`` / ``dec_layers`` are
unstacked. Every leaf is checked against the port's ``param_specs`` (shape
and dtype) before it is placed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.base import ParamTree, map_specs, resolve_device
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

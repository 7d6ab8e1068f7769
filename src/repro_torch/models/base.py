"""Model bundle protocol shared by every family, spec-driven init and the
param tree: port of ``repro.models.base``.

Every family module exposes ``build(cfg) -> ModelBundle``. ``param_specs()``
returns the param tree as ``Spec`` records (shape, dtype), so a full
config's shapes are known without memory. Where the JAX package stacks a
scan's layers on axis 0, the port keeps a list with one entry per layer
(``layers``; zamba2's ``segments``, a list of segments each a list of
blocks; whisper's ``enc_layers`` and ``dec_layers``), and the params are a
``ParamTree``: an ``nn.Module`` with one submodule per layer.
``as_tree`` reads a ``ParamTree`` as plain nested dicts and lists of its
parameters; gradients and optimizer state are such trees, in the same
nesting (``tree_map``, ``tree_leaves``, ``tree_unflatten``), and
``jax_leaves`` reads any of them as the JAX package's stacked leaves.

The bundle carries the training half too: ``loss_fn`` (mean next-token
``cross_entropy``) and ``train_input_specs``. Its parameters are frozen:
training turns ``requires_grad_()`` on.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

# a CUDA device without a card raises: an entry point never falls back to
# the host
from repro_torch.graph.graph import _device as resolve_device


class Spec(NamedTuple):
    """A leaf's shape and dtype, without memory (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def spec(shape, dtype) -> Spec:
    return Spec(tuple(int(s) for s in shape), dtype)


def dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _module(node):
    if isinstance(node, dict):
        return ParamTree(node)
    return nn.ModuleList(_module(x) for x in node)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict keys are submodules or
    (frozen) parameters, lists are ``nn.ModuleList``s. ``tree["wq"]`` and
    ``"bq" in tree`` read it as the JAX package reads its dicts."""

    def __init__(self, items: dict):
        super().__init__()
        self._keys = tuple(items)         # the specs' order
        for k, v in items.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, _module(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def as_tree(node):
    """A ``ParamTree`` as nested dicts and lists of its parameters (the same
    tensors, in the specs' order); any other tree as it is."""
    if isinstance(node, ParamTree):
        return {k: as_tree(node[k]) for k in node._keys}
    if isinstance(node, nn.ModuleList):
        return [as_tree(x) for x in node]
    return node


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (and of
    ``rest``, trees of the same nesting), keeping the nesting. A ``Spec``
    record is a leaf."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """The tree of ``like``'s nesting holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def jax_leaves(tree, path: str = ""):
    """``[(keystr, tensors, stacked)]``: the JAX package's leaves of a port
    tree (a ``ParamTree``, or nested dicts, lists and tuples of tensors), in
    ``jax.tree_util``'s flatten order (tuple positions, then dict keys
    sorted as strings, so not the port's order). A stacked leaf's tensors
    are its layers, in order; any other leaf is one tensor. Its stacked
    rank is ``tensors[0].dim() + stacked``."""
    tree = as_tree(tree)
    if isinstance(tree, tuple):
        return [g for i, x in enumerate(tree)
                for g in jax_leaves(x, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [g for k in sorted(tree)
                for g in jax_leaves(tree[k], f"{path}['{k}']")]
    if isinstance(tree, list):
        if isinstance(tree[0], list):       # zamba2's segments
            return jax_leaves({f"seg{i}": s for i, s in enumerate(tree)},
                              path)
        layers = [jax_leaves(x, path) for x in tree]
        return [(p, [layer[j][1][0] for layer in layers], True)
                for j, (p, _, _) in enumerate(layers[0])]
    return [(path, [tree], False)]


def map_specs(fn, node, path=()):
    """``fn(path, spec)`` over a spec tree's leaves, in the tree's order
    (dict insertion order, list index), keeping its nesting."""
    if isinstance(node, Spec):
        return fn(path, node)
    if isinstance(node, dict):
        return {k: map_specs(fn, v, path + (k,)) for k, v in node.items()}
    return [map_specs(fn, v, path + (i,)) for i, v in enumerate(node)]


def init_from_specs(specs, seed: int = 0, device="cuda") -> ParamTree:
    """Deterministic init from one ``torch.Generator`` on ``device``: a leaf
    whose stacked rank is at most 1 (``ln_f``, a lone bias) zero, every
    other leaf normal(0, 0.02), as in the JAX init, which decides by the
    stacked leaf's rank (``jax_leaves``): per-layer norm gains and biases
    are (L, D) there, so they are drawn. (``jax.random``'s draws cannot be
    equalled; ``models.params_from_numpy`` carries the JAX package's params
    across.) Leaves are drawn in their own dtype, so no float32 copy of a
    large bfloat16 leaf is made."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = ParamTree(map_specs(
        lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=dev), specs))
    with torch.no_grad():
        for _, ts, stacked in jax_leaves(params):
            if ts[0].dim() + stacked > 1:
                for t in ts:
                    t.normal_(0.0, 0.02, generator=gen)
    return params


def zeros_from_specs(specs, device):
    """Zero tensors in the shape of a spec tree (caches), keeping tuples."""
    if isinstance(specs, Spec):
        return torch.zeros(specs.shape, dtype=specs.dtype, device=device)
    if isinstance(specs, dict):
        return {k: zeros_from_specs(v, device) for k, v in specs.items()}
    return type(specs)(zeros_from_specs(v, device) for v in specs)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -100) -> torch.Tensor:
    """Mean next-token CE over float32 logits; label ``ignore`` positions
    excluded (VLM frontends), an all-ignored batch 0. The gold logit is a
    gather (the JAX package's select-and-sum over the vocabulary adds exact
    zeros: the same value)."""
    logits = logits.float()
    valid = labels != ignore
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    tokloss = (lse - gold) * valid
    return tokloss.sum() / torch.clamp(valid.sum(), min=1)


def token_specs(batch: int, seq: int) -> dict:
    return {"tokens": spec((batch, seq), torch.int32),
            "labels": spec((batch, seq), torch.int32)}


_SHAPES_ONLY = contextvars.ContextVar("shapes_only", default=False)


@contextlib.contextmanager
def shapes_only():
    """Within it a time scan (rwkv6's, zamba2's) returns empty results of
    its output shapes without running its steps: for a pass that reads only
    shapes (the dry-run's annotation log), where a step-by-step scan over
    a long sequence of meta tensors takes minutes."""
    token = _SHAPES_ONLY.set(True)
    try:
        yield
    finally:
        _SHAPES_ONLY.reset(token)


def scan_shapes_only() -> bool:
    return _SHAPES_ONLY.get()


def remat(cfg, fn, *args):
    """``fn(*args)``, rematerialised in backward under ``cfg.remat`` when
    grad is on (the JAX package's ``jax.checkpoint`` around a layer); a
    plain call otherwise, so serving runs as it did."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


@dataclasses.dataclass
class ModelBundle:
    cfg: object
    param_specs: Callable[[], dict]
    loss_fn: Callable                 # (params, batch) -> scalar
    train_input_specs: Callable       # (ShapeConfig) -> batch spec dict
    prefill_fn: Optional[Callable] = None   # (params, batch) -> (logits, cache)
    decode_fn: Optional[Callable] = None    # (params, cache, batch, pos) -> (logits, cache)
    cache_specs: Optional[Callable] = None  # (batch, seq) -> cache spec tree
    decode_input_specs: Optional[Callable] = None  # (ShapeConfig) -> batch spec dict
    # (params, batch) -> (B, S, V) logits of one full forward without a
    # cache, at the state a served decode sees: what teacher-forced decode
    # steps are held to
    logits_fn: Optional[Callable] = None

    def init(self, seed: int = 0, device="cuda") -> ParamTree:
        return init_from_specs(self.param_specs(), seed, device)


def token_input_specs(shape) -> dict:
    """A decode step's batch: one token per sequence."""
    return {"tokens": spec((shape.global_batch, 1), torch.int32)}

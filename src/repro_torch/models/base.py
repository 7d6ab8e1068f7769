"""Model bundle protocol shared by every family, spec-driven init and the
param tree: port of ``repro.models.base``.

Every family module exposes ``build(cfg) -> ModelBundle``. ``param_specs()``
returns the param tree as ``Spec`` records (shape, dtype), so a full
config's shapes are known without memory. Where the JAX package stacks a
scan's layers on axis 0, the port keeps a list with one entry per layer
(``layers``; zamba2's ``segments``, a list of segments each a list of
blocks; whisper's ``enc_layers`` and ``dec_layers``), and the params are a
``ParamTree``: an ``nn.Module`` with one submodule per layer.

Serving only: the bundle carries no loss or training input specs yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
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


def map_specs(fn, node, path=()):
    """``fn(path, spec)`` over a spec tree's leaves, in the tree's order
    (dict insertion order, list index), keeping its nesting."""
    if isinstance(node, Spec):
        return fn(path, node)
    if isinstance(node, dict):
        return {k: map_specs(fn, v, path + (k,)) for k, v in node.items()}
    return [map_specs(fn, v, path + (i,)) for i, v in enumerate(node)]


def init_from_specs(specs, seed: int = 0, device="cuda") -> ParamTree:
    """Deterministic init from one ``torch.Generator`` on ``device``: 1-D
    leaves (norm gains, biases) zero, matrices normal(0, 0.02), as in the
    JAX init (whose draws ``jax.random`` makes and this cannot equal;
    ``models.params_from_numpy`` carries the JAX package's params across).
    Leaves are drawn in their own dtype, so no float32 copy of a large
    bfloat16 leaf is made."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def leaf(_, s):
        t = torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if len(s.shape) > 1:
            t.normal_(0.0, 0.02, generator=gen)
        return t

    return ParamTree(map_specs(leaf, specs))


def zeros_from_specs(specs, device):
    """Zero tensors in the shape of a spec tree (caches), keeping tuples."""
    if isinstance(specs, Spec):
        return torch.zeros(specs.shape, dtype=specs.dtype, device=device)
    if isinstance(specs, dict):
        return {k: zeros_from_specs(v, device) for k, v in specs.items()}
    return type(specs)(zeros_from_specs(v, device) for v in specs)


@dataclasses.dataclass
class ModelBundle:
    cfg: object
    param_specs: Callable[[], dict]
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

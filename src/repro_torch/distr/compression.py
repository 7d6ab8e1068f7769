"""int8 gradient compression with error feedback. Port of
``repro.distr.compression``.

Quantizing grads to int8 (an absmax scale) cuts data-parallel collective
bytes 4x against float32; the residual carried to the next step (error
feedback) keeps the sum of the compressed grads on the true sum. Here the
quantize -> dequantize round trip is applied to the gradient tree, as in
the JAX package, whose numerics the tests hold it to.

The scale is one per JAX leaf: a stacked layer leaf of the JAX package is
one scale over all the port's per-layer tensors of it
(``models.jax_leaves``). The residual is float32.
"""
from __future__ import annotations

import torch

from repro_torch.models.base import (jax_leaves, tree_leaves, tree_map,
                                     tree_unflatten)


def quantize(g, scale=None):
    """``g`` as int8 and its scale; ``scale`` given when ``g`` is one layer
    of a stacked leaf, whose absmax sets it."""
    if scale is None:
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


@torch.no_grad()
def compress_decompress(grads, error_fb=None):
    """Quantize each gradient leaf to int8 (+ error feedback residual):
    (the dequantized grads in their dtypes, the float32 residuals), both
    in the grads' nesting."""
    if error_fb is None:
        error_fb = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads)
    out, resid = {}, {}
    for (_, gs, _), (_, es, _) in zip(jax_leaves(grads),
                                      jax_leaves(error_fb)):
        g32 = [g.float() + e for g, e in zip(gs, es)]
        scale = torch.clamp(torch.stack([x.abs().max() for x in g32]).max(),
                            min=1e-12) / 127.0
        for g, x in zip(gs, g32):
            deq = dequantize(quantize(x, scale)[0], scale)
            out[id(g)] = deq.to(g.dtype)
            resid[id(g)] = x - deq
    leaves = tree_leaves(grads)
    return (tree_unflatten(grads, [out[id(g)] for g in leaves]),
            tree_unflatten(grads, [resid[id(g)] for g in leaves]))

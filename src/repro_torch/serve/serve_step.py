"""Serving steps: the greedy decode step and the generation loop used by
``launch.serve``. Port of ``repro.serve.serve_step``.

Caches are tensors allocated once from ``cache_specs`` (zeros) and written
in place at each step's cache slot, where the JAX package rebuilds them.
"""
from __future__ import annotations

import torch

from repro_torch.models.base import ModelBundle, zeros_from_specs


def make_serve_step(model: ModelBundle):
    """serve_step = one decode step then the greedy pick (argmax takes the
    first index on ties)."""

    def serve_step(params, cache, batch, pos):
        logits, cache = model.decode_fn(params, cache, batch, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step


@torch.no_grad()
def prefill_cache(model: ModelBundle, params, prompt, cache_len: int):
    """Fill a fresh cache from the prompt by teacher-forced decode steps:
    (the last step's logits, the cache)."""
    B, S = prompt.shape
    cache = zeros_from_specs(model.cache_specs(B, cache_len), prompt.device)
    logits = None
    for pos in range(S):
        logits, cache = model.decode_fn(params, cache,
                                        {"tokens": prompt[:, pos:pos + 1]},
                                        pos)
    return logits, cache


@torch.no_grad()
def teacher_forced_logits(model: ModelBundle, params, tokens, cache_len: int):
    """Decode steps over ``tokens`` from a fresh cache: (every position's
    logits (B, S, V), the cache). The logits are what ``model.logits_fn``
    over the same tokens must equal (the check of the cache path)."""
    B, S = tokens.shape
    cache = zeros_from_specs(model.cache_specs(B, cache_len), tokens.device)
    out = []
    for pos in range(S):
        logits, cache = model.decode_fn(params, cache,
                                        {"tokens": tokens[:, pos:pos + 1]},
                                        pos)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1), cache


@torch.no_grad()
def decode_greedy(model: ModelBundle, params, logits, cache, start: int,
                  max_new: int):
    """``max_new`` greedy tokens: the first from ``logits``, each next from
    a decode step at positions ``start``, ``start + 1``, ..."""
    step = make_serve_step(model)
    out = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)]
    for pos in range(start, start + max_new - 1):
        tok, cache = step(params, cache, {"tokens": out[-1][:, None]}, pos)
        out.append(tok)
    return torch.stack(out, dim=1)


def greedy_generate(model: ModelBundle, params, prompt, max_new: int,
                    cache_len: int):
    """Prefill by teacher-forced decode steps, then greedy decode:
    (B, max_new) int32 tokens."""
    logits, cache = prefill_cache(model, params, prompt, cache_len)
    return decode_greedy(model, params, logits, cache, prompt.shape[1],
                         max_new)

"""PyTorch port, the models' serving path, held against the JAX package:
every family of ``ARCHS`` at ``tests/test_arch_smoke.py``'s ``tiny_of``
shapes, with the JAX package's ``model.init(0)`` carried across by
``repro_torch.models.params_from_numpy``.

Tolerances: logits within atol 1e-4 (both sides compute in float32;
they differ in the order of their sums, about 1e-7 here, and 1e-4 still
fails on any wrong mask, position, cache slot or routing). The bfloat16
gemma cases are held to the same 1e-4: the port's dtypes equal JAX's, its
bfloat16 caches come out bit-equal to JAX's on these inputs and its logits
within 2e-7, while a bfloat16 residual stream (torch's own promotion of a
bfloat16 tensor times a Python float) misses by 1.5e-3 to 1.8e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCHS
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models import layers as TL
from repro_torch.models import params_from_numpy
from repro_torch.models.base import zeros_from_specs
from test_arch_smoke import tiny_of

ATOL = 1e-4


def pair(name, **kw):
    """(JAX cfg, port cfg, JAX bundle, port bundle, JAX params, port params)
    at the JAX tests' tiny shapes."""
    jc = dataclasses.replace(tiny_of(name), **kw)
    tc = dataclasses.replace(tget_config(name), **dataclasses.asdict(jc))
    jm, tm = jget_model(jc), tget_model(tc)
    jp = jm.init(0)
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jm, tm, jp, tp


def prompt_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "whisper":
        batch["frames"] = rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_frontend)).astype(np.float32)
    if cfg.family == "llava":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def jax_zero_cache(jm, B, T):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        jm.cache_specs(B, T),
                        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


def leaves(node):
    """A cache tree's tensors in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in leaves(v)]
    return [node]


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def run_decode(jm, tm, jp, tp, tokens, T, atol):
    """Teacher-forced decode steps from zero caches on both sides; each
    step's logits and the final caches compared."""
    B, S = tokens.shape
    jcache = jax_zero_cache(jm, B, T)
    tcache = zeros_from_specs(tm.cache_specs(B, T), "cpu")
    step = jax.jit(jm.decode_fn)
    for pos in range(S):
        tok = tokens[:, pos:pos + 1]
        jl, jcache = step(jp, jcache, {"tokens": jnp.asarray(tok)}, pos)
        tl, tcache = tm.decode_fn(tp, tcache,
                                  {"tokens": torch.from_numpy(tok.copy())},
                                  pos)
        assert tl.dtype == torch.float32 and tl.shape == (B, 1, tm.cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=atol, err_msg=f"decode pos {pos}")
    jleaves, tleaves = jax.tree.leaves(jcache), leaves(tcache)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_allclose(as_f32(t), as_f32(j), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax(name):
    """prefill_fn's last-position logits, then 6 decode steps from zero
    caches (the caches compared after them)."""
    jc, tc, jm, tm, jp, tp = pair(name)
    batch = prompt_batch(jc, 2, 6, seed=11)
    jl, _ = jax.jit(jm.prefill_fn)(jp, to_jax(batch))
    tl, _ = tm.prefill_fn(tp, to_torch(batch))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    run_decode(jm, tm, jp, tp, batch["tokens"], T=8, atol=ATOL)


def test_mixtral_decodes_past_its_ring():
    """A ring cache of the window (8 slots): sliding_window + 4 steps write
    slot pos % 8 over the oldest entry, and the window mask and
    cache_kv_positions(ring=True) must agree with JAX after the wrap."""
    jc, tc, jm, tm, jp, tp = pair("mixtral-8x7b")
    W = jc.sliding_window
    assert tm.cache_specs(2, 64)[0].shape[2] == W       # the ring's length
    tokens = np.random.default_rng(12).integers(
        0, jc.vocab, (2, W + 4)).astype(np.int32)
    run_decode(jm, tm, jp, tp, tokens, T=64, atol=ATOL)


@pytest.mark.parametrize("name", ["gemma-2b", "gemma2-9b"])
def test_bfloat16_gemma_follows_jax_promotion(name):
    """bfloat16 params: the embedding times gemma's np.float32 scale is a
    float32 residual stream in JAX, so every product takes float32
    activations against bfloat16 weights, and the caches hold bfloat16."""
    jc, tc, jm, tm, jp, tp = pair(name, dtype="bfloat16")
    assert tp["embed"]["tok"].dtype == torch.bfloat16
    batch = prompt_batch(jc, 2, 6, seed=13)
    jh = JL.embed(jp["embed"], jnp.asarray(batch["tokens"]), jc.d_model,
                  jc.embed_scale)
    th = TL.embed(tp["embed"], torch.from_numpy(batch["tokens"]), tc.d_model,
                  tc.embed_scale)
    assert jh.dtype == jnp.float32 and th.dtype == torch.float32
    jl, _ = jax.jit(jm.prefill_fn)(jp, to_jax(batch))
    tl, _ = tm.prefill_fn(tp, to_torch(batch))
    assert jl.dtype == jnp.float32 and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    run_decode(jm, tm, jp, tp, batch["tokens"], T=8, atol=ATOL)

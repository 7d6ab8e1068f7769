"""PyTorch port, the models' configs and building blocks, held against the
JAX package (``repro.configs.base``, ``repro.models.layers``).

Inputs come from numpy with fixed seeds and go through both packages in
float32. Configs are compared field by field, exactly. Layers are held to
atol 1e-5: both sides compute in float32 and differ only in the order of
their sums (einsum / matmul reductions over at most 64 terms of order 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import layers as JL
from repro_torch.configs import base as tcfg
from repro_torch.models import layers as TL

ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, want, atol=ATOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# -- configs ----------------------------------------------------------------------
@pytest.mark.parametrize("name", jcfg.ARCHS)
def test_config_fields_and_counts_equal_jax(name):
    j, p = jcfg.get_config(name), tcfg.get_config(name)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.param_count() == j.param_count()
    assert p.active_param_count() == j.active_param_count()
    assert p.attn_free == j.attn_free
    assert ([s.name for s in tcfg.shapes_for(p)]
            == [s.name for s in jcfg.shapes_for(j)])


def test_archs_shapes_and_overrides_equal_jax():
    assert tcfg.ARCHS == jcfg.ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()})
    pairs = ["n_layers=3", "remat=false", "rope_theta=5e5", "dtype=float32",
             "qkv_bias=yes"]
    j = jcfg.apply_overrides(dataclasses.replace(
        jcfg.get_config("qwen2-1.5b")), pairs)
    p = tcfg.apply_overrides(dataclasses.replace(
        tcfg.get_config("qwen2-1.5b")), pairs)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert (p.n_layers, p.remat, p.rope_theta) == (3, False, 5e5)
    # a frozen dataclass (a copy: SHAPES stays as it is)
    js = jcfg.apply_overrides(dataclasses.replace(jcfg.SHAPES["train_4k"]),
                              ["seq_len=128"])
    ps = tcfg.apply_overrides(dataclasses.replace(tcfg.SHAPES["train_4k"]),
                              ["seq_len=128"])
    assert dataclasses.asdict(ps) == dataclasses.asdict(js)
    assert ps.seq_len == 128 and tcfg.SHAPES["train_4k"].seq_len == 4096


# -- norms and rope ----------------------------------------------------------------
def test_rmsnorm_and_softcap_match_jax():
    rng = np.random.default_rng(0)
    x, w = normal(rng, 3, 5, 32, scale=3.0), normal(rng, 32, scale=0.1)
    close(TL.rmsnorm(t(x), t(w)), JL.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    close(TL.softcap(t(x), 2.5), JL.softcap(jnp.asarray(x), 2.5))
    close(TL.softcap(t(x), 0.0), x)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = normal(rng, 2, 7, 3, 16)
    pos = np.array([0, 1, 2, 5, 9, 100, 4095], np.int32)
    close(TL.rope(t(x), t(pos), theta),
          JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


# -- attention ---------------------------------------------------------------------
def _attn_inputs(rng, B=2, S=6, T=11, K=2, G=2, h=8):
    q = normal(rng, B, S, K, G, h)
    k = normal(rng, B, T, K, h)
    v = normal(rng, B, T, K, h)
    return q, k, v


CASES = [
    # (name, flavor kwargs, kv positions, softcap, runtime window)
    ("causal", {}, "linear", 0.0, None),
    ("empty slots", {}, "holes", 0.0, None),
    ("sliding window", {"sliding_window": 3}, "linear", 0.0, None),
    ("runtime window local", {}, "linear", 0.0, 4),
    ("runtime window global", {}, "linear", 0.0, 0),
    ("softcap", {}, "linear", 5.0, None),
    ("non-causal", {"causal": False}, "holes", 0.0, None),
]


@pytest.mark.parametrize("kv_chunk", [0, 4, 5])
@pytest.mark.parametrize("name,fkw,kvp,cap,win", CASES,
                         ids=[c[0] for c in CASES])
def test_chunked_attention_matches_jax(name, fkw, kvp, cap, win, kv_chunk):
    """kv_chunk 0 is one chunk; 4 and 5 pad T = 11 with -1 positions; the
    holes case leaves whole chunks empty (-1), so the NEG_INF arithmetic of
    a fully masked chunk is what is compared."""
    rng = np.random.default_rng(len(name) + kv_chunk)
    q, k, v = _attn_inputs(rng)
    qpos = np.arange(5, 11, dtype=np.int32)
    kpos = np.arange(11, dtype=np.int32)
    if kvp == "holes":
        kpos = np.where(np.isin(kpos, [0, 1, 2, 3, 7]), -1, kpos)
    jfl = JL.AttnFlavor(4, 2, 8, **fkw)
    tfl = TL.AttnFlavor(4, 2, 8, **fkw)
    want = jax.jit(JL.chunked_attention,
                   static_argnames=("fl", "kv_chunk", "softcap_val"))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        fl=jfl, kv_chunk=kv_chunk, softcap_val=cap,
        window_runtime=None if win is None else jnp.asarray(win))
    got = TL.chunked_attention(
        t(q), t(k), t(v), q_positions=t(qpos), kv_positions=t(kpos), fl=tfl,
        kv_chunk=kv_chunk, softcap_val=cap, window_runtime=win)
    close(got, want)


def test_a_query_with_every_slot_masked_matches_jax():
    """Query position 0 against keys that all lie in its future: every
    logit is NEG_INF, so the output is the plain mean of the values (p = 1
    per slot), as in the JAX package; a -inf mask would give NaN."""
    rng = np.random.default_rng(7)
    q, k, v = _attn_inputs(rng, S=1, T=6)
    qpos, kpos = np.array([0], np.int32), np.arange(1, 7, dtype=np.int32)
    fl = dict(n_heads=4, n_kv_heads=2, head_dim=8)
    want = JL.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        fl=JL.AttnFlavor(**fl), kv_chunk=0)
    got = TL.chunked_attention(t(q), t(k), t(v), q_positions=t(qpos),
                               kv_positions=t(kpos), fl=TL.AttnFlavor(**fl),
                               kv_chunk=0)
    close(got, want)
    assert torch.isfinite(got).all()
    close(got[:, 0, 0, 0], v.mean(axis=1)[:, 0])


@pytest.mark.parametrize("ring", [False, True])
def test_cache_kv_positions_match_jax(ring):
    T = 8
    for pos in [0, 3, 7, 8, 9, 15, 16, 30]:       # before and after the wrap
        want = JL.cache_kv_positions(pos, T, ring)
        got = TL.cache_kv_positions(pos, T, ring)
        assert np.array_equal(got.numpy(), np.asarray(want)), (pos, ring)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_layer_prefill_and_cached_step_match_jax(qkv_bias):
    rng = np.random.default_rng(3)
    B, S, D, T = 2, 5, 32, 9
    fl = dict(n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=qkv_bias)
    shapes = {"wq": (D, 32), "wk": (D, 16), "wv": (D, 16), "wo": (32, D)}
    if qkv_bias:
        shapes.update(bq=(32,), bk=(16,), bv=(16,))
    p = {k_: normal(rng, *s, scale=0.2) for k_, s in shapes.items()}
    x = normal(rng, B, S, D)
    pos = np.arange(S, dtype=np.int32)
    want, _ = JL.attention({k_: jnp.asarray(v_) for k_, v_ in p.items()},
                           jnp.asarray(x), JL.AttnFlavor(**fl),
                           positions=jnp.asarray(pos), kv_chunk=2)
    got, _ = TL.attention({k_: t(v_) for k_, v_ in p.items()}, t(x),
                          TL.AttnFlavor(**fl), positions=t(pos), kv_chunk=2)
    close(got, want)
    # one cached step at position 4 into a cache that holds 0..3
    ck, cv = normal(rng, B, T, 2, 8), normal(rng, B, T, 2, 8)
    kvp = np.asarray(JL.cache_kv_positions(4, T, False))
    (want, (jk, jv)) = JL.attention(
        {k_: jnp.asarray(v_) for k_, v_ in p.items()}, jnp.asarray(x[:, :1]),
        JL.AttnFlavor(**fl), positions=jnp.asarray([4]),
        cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_slot=4,
        kv_positions=jnp.asarray(kvp))
    tk, tv = t(ck.copy()), t(cv.copy())
    got, (gk, gv) = TL.attention(
        {k_: t(v_) for k_, v_ in p.items()}, t(x[:, :1]), TL.AttnFlavor(**fl),
        positions=torch.tensor([4]), cache=(tk, tv), cache_slot=4,
        kv_positions=t(kvp))
    close(got, want)
    assert gk is tk and gv is tv                   # written in place
    close(tk, jk)
    close(tv, jv)


# -- MLPs ------------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(kind):
    rng = np.random.default_rng(4)
    D, Fd = 32, 64
    shapes = {"wg": (D, Fd), "wu": (D, Fd), "wd": (Fd, D)}
    if kind == "gelu":
        del shapes["wg"]
    p = {k_: normal(rng, *s, scale=0.2) for k_, s in shapes.items()}
    x = normal(rng, 2, 5, D)
    close(TL.mlp({k_: t(v_) for k_, v_ in p.items()}, t(x), kind),
          JL.mlp({k_: jnp.asarray(v_) for k_, v_ in p.items()},
                 jnp.asarray(x), kind))


@pytest.mark.parametrize("S,E,k,cf,drops", [
    (12, 4, 2, 1.25, True),      # cap 8 of 24 decisions: a skewed router drops
    (12, 4, 2, 4.0, False),      # cap 24: nothing drops
    (1, 8, 2, 1.25, False),      # decode: cap 1, k distinct experts
    (9, 8, 1, 1.25, True),       # top-1 (llama4), cap 2
])
def test_moe_mlp_matches_jax(S, E, k, cf, drops):
    """Random inputs: no exact ties in the router's top-k, whose order is
    unspecified in both libraries. The router is biased toward expert 0 so
    that the dropping cases really drop."""
    rng = np.random.default_rng(S * E + k)
    D, Fd, B = 16, 24, 3
    router = normal(rng, D, E)
    router[:, 0] += 2.0
    p = {"router": router, "wg": normal(rng, E, D, Fd, scale=0.3),
         "wu": normal(rng, E, D, Fd, scale=0.3),
         "wd": normal(rng, E, Fd, D, scale=0.3)}
    x = normal(rng, B, S, D) + 1.0
    want = jax.jit(JL.moe_mlp, static_argnums=(2, 3, 4))(
        {k_: jnp.asarray(v_) for k_, v_ in p.items()}, jnp.asarray(x), E, k,
        cf)
    got = TL.moe_mlp({k_: t(v_) for k_, v_ in p.items()}, t(x), E, k, cf)
    close(got, want)
    # whether a token lost a decision shows as a row that differs from the
    # uncapped layer's
    full = TL.moe_mlp({k_: t(v_) for k_, v_ in p.items()}, t(x), E, k,
                      E / k)
    assert bool((got - full).abs().amax() > 1e-3) == drops


# -- embeddings --------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("tied,cap", [(False, 0.0), (True, 30.0)])
def test_embed_and_unembed_match_jax(scale, tied, cap):
    rng = np.random.default_rng(5)
    V, D = 23, 16
    p = {"tok": normal(rng, V, D)}
    if not tied:
        p["out"] = normal(rng, D, V)
    toks = rng.integers(0, V, (2, 7)).astype(np.int32)
    jp = {k_: jnp.asarray(v_) for k_, v_ in p.items()}
    tp = {k_: t(v_) for k_, v_ in p.items()}
    jh = JL.embed(jp, jnp.asarray(toks), D, scale)
    th = TL.embed(tp, t(toks), D, scale)
    close(th, jh)
    close(TL.unembed(tp, th, cap, tied), JL.unembed(jp, jh, cap, tied),
          atol=1e-4)


def test_bfloat16_promotion_follows_jax():
    """JAX: a bfloat16 embedding times gemma's np.float32 scale is float32,
    and bf16 @ f32 is float32; torch alone would keep bfloat16 in the first
    (tensor times Python float) and refuse the second. The port follows
    JAX."""
    rng = np.random.default_rng(6)
    tok = normal(rng, 11, 8)
    toks = np.array([[1, 2, 3]], np.int32)
    jh = JL.embed({"tok": jnp.asarray(tok, jnp.bfloat16)}, jnp.asarray(toks),
                  8, True)
    th = TL.embed({"tok": t(tok).to(torch.bfloat16)}, t(toks), 8, True)
    assert jh.dtype == jnp.float32 and th.dtype == torch.float32
    close(th, jh)
    w = t(normal(rng, 8, 5)).to(torch.bfloat16)
    jw = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    assert (jh @ jw).dtype == jnp.float32
    got = TL.mm(th, w)
    assert got.dtype == torch.float32
    close(got, jh @ jw)
    assert TL.mm(th.to(torch.bfloat16), w).dtype == torch.bfloat16


def test_whisper_cross_attention_in_query_chunks_matches_jax():
    """whisper's cross-attention takes queries in chunks of ``q_chunk``
    where S divides into them (S = 6 in chunks of 2 and 3 here; the
    served shapes never reach the 4096 default); every chunking equals
    JAX's and the unchunked call."""
    from repro.models import whisper as jwhisper
    from repro_torch.models import whisper as twhisper
    rng = np.random.default_rng(8)
    B, S, D, Fr = 2, 6, 32, 9
    p = {"wq": normal(rng, D, 32, scale=0.2), "wo": normal(rng, 32, D,
                                                          scale=0.2)}
    x = normal(rng, B, S, D)
    k, v = normal(rng, B, Fr, 4, 8), normal(rng, B, Fr, 4, 8)
    fl = dict(n_heads=4, n_kv_heads=4, head_dim=8, causal=False,
              use_rope=False)
    whole = twhisper._cross_attention(
        {k_: t(v_) for k_, v_ in p.items()}, t(x), (t(k), t(v)),
        TL.AttnFlavor(**fl), kv_chunk=4)
    for q_chunk in (2, 3):
        want = jwhisper._cross_attention(
            {k_: jnp.asarray(v_) for k_, v_ in p.items()}, jnp.asarray(x),
            (jnp.asarray(k), jnp.asarray(v)), JL.AttnFlavor(**fl),
            kv_chunk=4, q_chunk=q_chunk)
        got = twhisper._cross_attention(
            {k_: t(v_) for k_, v_ in p.items()}, t(x), (t(k), t(v)),
            TL.AttnFlavor(**fl), kv_chunk=4, q_chunk=q_chunk)
        close(got, want)
        close(whole, want)

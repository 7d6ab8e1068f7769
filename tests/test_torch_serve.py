"""PyTorch port, serving: ``serve.serve_step`` and ``launch.serve`` against
the JAX package's ``greedy_generate`` and ``launch.serve``, the cache path
against one full forward, and the param tree (init, specs, the converter).

Greedy tokens are compared exactly: the logits agree to about 1e-7 (see
``tests/test_torch_model_decode.py``), far inside the gap between the two
largest logits on these seeds. Teacher-forced decode is held to one full
forward within atol 1e-4 in float32 (the sums' order differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCHS
from repro.configs.base import get_config as jget_config
from repro.launch.train import tiny_config as jtiny_config
from repro.serve.serve_step import greedy_generate as jgreedy
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import (forward_reference, get_model,
                                params_from_numpy)
from repro_torch.models.base import zeros_from_specs
from repro_torch.serve.serve_step import (greedy_generate, make_serve_step,
                                          teacher_forced_logits)
from test_torch_model_decode import pair

ATOL = 1e-4
GREEDY = ["qwen2-1.5b", "gemma2-9b", "mixtral-8x7b", "rwkv6-3b",
          "zamba2-1.2b", "whisper-medium"]


@pytest.mark.parametrize("name", GREEDY)
def test_greedy_generate_matches_jax(name):
    jc, tc, jm, tm, jp, tp = pair(name)
    prompt = np.random.default_rng(21).integers(
        0, jc.vocab, (2, 5)).astype(np.int32)
    want = jgreedy(jm, jp, jnp.asarray(prompt), max_new=6, cache_len=11)
    got = greedy_generate(tm, tp, torch.from_numpy(prompt), max_new=6,
                          cache_len=11)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ARCHS)
def test_teacher_forced_decode_equals_one_forward(name):
    """Prefix logits from decode steps through the cache equal one forward
    over the same tokens (moe: at a capacity that drops nothing, as no
    decode step drops; whisper: at the all-zero encoder state that its
    served decode reads; llava: text only, as decode reads it)."""
    _, tc, _, tm, _, tp = pair(name)
    tokens = torch.from_numpy(np.random.default_rng(22).integers(
        0, tc.vocab, (2, 10)).astype(np.int32))
    got, _ = teacher_forced_logits(tm, tp, tokens, cache_len=12)
    want = forward_reference(tc).logits_fn(tp, {"tokens": tokens})
    assert got.shape == want.shape == (2, 10, tc.vocab)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_moe_forward_drops_where_decode_does_not():
    """Why the moe reference raises its capacity: at the config's 1.25 the
    forward over 10 tokens drops decisions and its logits leave the decode
    steps'."""
    _, tc, _, tm, _, tp = pair("mixtral-8x7b")
    tokens = torch.from_numpy(np.random.default_rng(22).integers(
        0, tc.vocab, (2, 10)).astype(np.int32))
    got, _ = teacher_forced_logits(tm, tp, tokens, cache_len=12)
    capped = tm.logits_fn(tp, {"tokens": tokens})
    assert (got - capped).abs().max() > 1e-3


def test_decode_writes_the_cache_in_place():
    _, tc, _, tm, _, tp = pair("qwen2-1.5b")
    cache = zeros_from_specs(tm.cache_specs(2, 8), "cpu")
    ptrs = [c.data_ptr() for c in cache]
    step = make_serve_step(tm)
    tok, out = step(tp, cache, {"tokens": torch.tensor([[3], [4]])}, 2)
    assert out is cache and [c.data_ptr() for c in out] == ptrs
    assert tok.dtype == torch.int32 and tok.shape == (2,)
    written = (cache[0] != 0).any(dim=(0, 1, 3, 4))      # by slot
    assert written.tolist() == [False, False, True] + [False] * 5


@pytest.mark.parametrize("name", ARCHS)
def test_serve_main_runs_on_cpu(name, capsys):
    res = tserve.main(["--device", "cpu", "--arch", name, "--batch", "2",
                       "--prompt-len", "4", "--max-new", "3"])
    cfg = tserve.tiny_config(tget_config(name))
    assert res.tokens.shape == (2, 3) and res.tokens.dtype == torch.int32
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab
    assert res.decode_steps == 2 and res.tokens_per_s > 0
    assert f"[serve] {cfg.name} on cpu" in capsys.readouterr().out
    again = tserve.main(["--device", "cpu", "--arch", name, "--batch", "2",
                         "--prompt-len", "4", "--max-new", "3"])
    assert torch.equal(again.tokens, res.tokens)        # fixed seed


def test_serve_main_matches_the_jax_entry_point():
    """The same prompt (numpy seed 0) and greedy tokens as ``repro.launch.
    serve`` at its defaults, from the JAX entry point's params carried across."""
    cfg = tserve.tiny_config(tget_config("qwen2-1.5b"))
    jcfg = jtiny_config(jget_config("qwen2-1.5b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    from repro.models import get_model as jget_model
    jm = jget_model(jcfg)
    jp = jm.init(0)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    want = jgreedy(jm, jp, jnp.asarray(prompt, jnp.int32), 16, cache_len=32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    got = greedy_generate(get_model(cfg), tp,
                          torch.as_tensor(prompt, dtype=torch.int32), 16,
                          cache_len=32)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_serve_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tserve.main(["--arch", "qwen2-1.5b"])
    with pytest.raises(RuntimeError, match="is_available"):
        get_model(tserve.tiny_config(tget_config("qwen2-1.5b"))).init(0)


@pytest.mark.parametrize("name", ARCHS)
def test_tiny_config_matches_jax(name):
    """Equal to the JAX entry point's reduction, except zamba2, where the JAX
    version passes n_layers twice and raises (a known difference)."""
    got = dataclasses.asdict(tserve.tiny_config(tget_config(name)))
    if name == "zamba2-1.2b":
        with pytest.raises(TypeError, match="n_layers"):
            jtiny_config(jget_config(name))
        assert (got["n_layers"], got["shared_attn_every"]) == (4, 2)
        return
    assert got == dataclasses.asdict(jtiny_config(jget_config(name)))


def test_init_is_seeded_and_follows_the_jax_rule():
    tm = get_model(tserve.tiny_config(tget_config("zamba2-1.2b")))
    a, b, c = tm.init(0, "cpu"), tm.init(0, "cpu"), tm.init(1, "cpu")
    pa, pb, pc = (dict(x.named_parameters()) for x in (a, b, c))
    assert pa.keys() == pb.keys() and len(pa) > 20
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert any(not torch.equal(pa[k], pc[k]) for k in pa if pa[k].ndim > 1)
    for k, v in pa.items():
        assert not v.requires_grad
        # the JAX rule reads the stacked rank: a per-layer vector is (L, D)
        # there and drawn, only an unstacked one (ln_f) is zero
        stacked = any(part.isdigit() for part in k.split("."))
        assert bool(v.any()) == (v.ndim + stacked > 1), k
    big = torch.cat([v.flatten() for v in pa.values() if v.ndim > 1])
    assert abs(float(big.std()) - 0.02) < 1e-3
    assert a["segments"][1][0]["in_proj"].shape == (64, 2 * 128 + 2 * 8 + 4)


def test_full_config_specs_need_no_memory():
    """qwen2-1.5b at its published widths: the spec tree is shapes only."""
    cfg = tget_config("qwen2-1.5b")
    specs = get_model(cfg).param_specs()
    assert len(specs["layers"]) == 28
    assert specs["embed"]["tok"].shape == (151936, 1536)
    attn = specs["layers"][0]["attn"]
    assert (attn["wq"].shape, attn["wk"].shape, attn["bk"].shape) == (
        (1536, 1536), (1536, 256), (256,))
    assert specs["layers"][0]["mlp"]["wg"].shape == (1536, 8960)
    assert all(s.dtype == torch.bfloat16 for s in specs["layers"][5]["mlp"].values())


def test_params_from_numpy_checks_the_tree():
    jc, tc, jm, _, jp, _ = pair("whisper-medium")
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tc, tree, "cpu")
    assert len(tp["enc_layers"]) == jc.encoder_layers
    assert np.array_equal(tp["dec_layers"][1]["cross_attn"]["wq"].numpy(),
                          tree["dec_layers"]["cross_attn"]["wq"][1])
    bad = jax.tree.map(lambda a: a, tree)
    bad["front_proj"] = bad["front_proj"][:, :-1]
    with pytest.raises(ValueError, match="front_proj"):
        params_from_numpy(tc, bad, "cpu")
    del bad["front_proj"]
    with pytest.raises(ValueError, match="leaves"):
        params_from_numpy(tc, bad, "cpu")

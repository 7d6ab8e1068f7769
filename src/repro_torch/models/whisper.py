"""Whisper-medium backbone: transformer encoder-decoder with cross-attention.
Port of ``repro.models.whisper``.

The conv/audio frontend is a STUB, as in the JAX package: the batch holds
precomputed frame embeddings (B, n_frames, d_frontend); a linear adapter
maps them to d_model. Positional encoding is on-the-fly sinusoidal for
both stacks.

Served decode never runs the encoder, as in the JAX package: the decode
cache's ``cross_k`` / ``cross_v`` are what ``greedy_generate`` allocates
(zeros), and ``prefill_fn`` returns no cache. ``logits_fn`` is the decoder
stack's full forward at that same state (an all-zero encoder output gives
zero cross keys and values). Training (``loss_fn``) runs the encoder on the
batch's ``frames``; each encoder and decoder layer is rematerialised in
backward under ``cfg.remat`` when grad is on.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distr.shardctx import shard
from repro_torch.models import layers as L
from repro_torch.models.base import (ModelBundle, cross_entropy, dtype_of,
                                     remat, spec, token_input_specs,
                                     token_specs)


def _fl(cfg, causal):
    return L.AttnFlavor(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        causal=causal, use_rope=False)


def _sinusoid(positions, d: int):
    """Sinusoidal position table, float32: (S, d)."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def param_specs(cfg: ModelConfig):
    dt = dtype_of(cfg)
    D = cfg.d_model

    def enc_block():
        return {
            "ln1": spec((D,), dt),
            "attn": L.attn_specs(D, _fl(cfg, False), dt),
            "ln2": spec((D,), dt),
            "mlp": L.mlp_specs(D, cfg.d_ff, "gelu", dt),
        }

    def dec_block():
        return {
            "ln1": spec((D,), dt),
            "self_attn": L.attn_specs(D, _fl(cfg, True), dt),
            "lnx": spec((D,), dt),
            "cross_attn": L.attn_specs(D, _fl(cfg, False), dt),
            "ln2": spec((D,), dt),
            "mlp": L.mlp_specs(D, cfg.d_ff, "gelu", dt),
        }

    return {
        "front_proj": spec((cfg.d_frontend, D), dt),
        "enc_layers": [enc_block() for _ in range(cfg.encoder_layers)],
        "enc_ln_f": spec((D,), dt),
        "embed": L.embed_specs(cfg.vocab, D, dt, tied=True),
        "dec_layers": [dec_block() for _ in range(cfg.n_layers)],
        "ln_f": spec((D,), dt),
    }


def encode(cfg: ModelConfig, params, frames):
    """frames: (B, F, d_frontend) stub frontend output -> (B, F, D)."""
    h = L.mm(frames.to(dtype_of(cfg)), params["front_proj"])
    positions = torch.arange(h.shape[1], device=h.device)
    h = h + _sinusoid(positions, cfg.d_model).to(h.dtype)
    h = shard(h, "batch", None, "embed")
    fl = _fl(cfg, False)

    def layer(lp, h):
        att, _ = L.attention(lp["attn"], L.rmsnorm(h, lp["ln1"]), fl,
                             positions=positions, kv_chunk=cfg.kv_chunk)
        h = h + att
        h = h + L.mlp(lp["mlp"], L.rmsnorm(h, lp["ln2"]), "gelu")
        return shard(h, "batch", None, "embed")

    for lp in params["enc_layers"]:
        h = remat(cfg, layer, lp, h)
    return L.rmsnorm(h, params["enc_ln_f"])


def _cross_attention(p, x, kv, fl, kv_chunk=1024, q_chunk=4096):
    """q from decoder x; k,v precomputed (B, F, K, h) from encoder output.
    Queries go in chunks of ``q_chunk`` where S divides into them, which
    bounds the (S, F) logits; each query's row is the same either way."""
    B, S, _ = x.shape
    K, h = fl.n_kv_heads, fl.head_dim
    q = L.mm(x, p["wq"]).reshape(B, S, K, fl.n_heads // K, h)
    k, v = kv
    Fr = k.shape[1]
    kv_positions = torch.arange(Fr, device=x.device)

    def attend(qc):
        return L.chunked_attention(
            qc, k, v, q_positions=torch.zeros(qc.shape[1], dtype=torch.int64,
                                              device=x.device),
            kv_positions=kv_positions, fl=fl, kv_chunk=kv_chunk)

    if S > q_chunk and S % q_chunk == 0:
        out = torch.cat([attend(q[:, s:s + q_chunk])
                         for s in range(0, S, q_chunk)], dim=1)
    else:
        out = attend(q)
    return L.mm(out.reshape(B, S, fl.n_heads * h), p["wo"])


def _enc_kv(p, enc_h, fl):
    B, Fr, _ = enc_h.shape
    k = L.mm(enc_h, p["wk"]).reshape(B, Fr, fl.n_kv_heads, fl.head_dim)
    v = L.mm(enc_h, p["wv"]).reshape(B, Fr, fl.n_kv_heads, fl.head_dim)
    return k, v


def decode_stack(cfg, params, tokens, positions, enc_h=None, caches=None,
                 cache_slot=None, kv_positions=None, last_only=False):
    """enc_h given (prefill) XOR caches given (decode: holds the cross k/v;
    the self k/v written in place)."""
    fl_self, fl_cross = _fl(cfg, True), _fl(cfg, False)
    h = L.embed(params["embed"], tokens, cfg.d_model, False)
    h = h + _sinusoid(positions, cfg.d_model).to(h.dtype)[None, :, :]
    h = shard(h, "batch", None, "embed")
    decode = caches is not None

    def layer(i, lp, h):
        cache = ((caches["self_k"][i], caches["self_v"][i]) if decode
                 else None)
        att, _ = L.attention(
            lp["self_attn"], L.rmsnorm(h, lp["ln1"]), fl_self,
            positions=positions, cache=cache, cache_slot=cache_slot,
            kv_positions=kv_positions, kv_chunk=cfg.kv_chunk)
        h = h + att
        if decode:
            kv = (caches["cross_k"][i], caches["cross_v"][i])
        else:
            kv = _enc_kv(lp["cross_attn"], enc_h, fl_cross)
        h = h + _cross_attention(lp["cross_attn"], L.rmsnorm(h, lp["lnx"]),
                                 kv, fl_cross, kv_chunk=cfg.kv_chunk)
        h = h + L.mlp(lp["mlp"], L.rmsnorm(h, lp["ln2"]), "gelu")
        return shard(h, "batch", None, "embed")

    for i, lp in enumerate(params["dec_layers"]):
        h = layer(i, lp, h) if decode else remat(cfg, layer, i, lp, h)
    h = L.rmsnorm(h, params["ln_f"])
    if last_only:
        h = h[:, -1:]
    logits = h @ params["embed"]["tok"].T.to(h.dtype)
    return shard(logits.float(), "batch", None, "vocab"), caches


def loss_fn(cfg, params, batch):
    enc_h = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    logits, _ = decode_stack(
        cfg, params, tokens, torch.arange(tokens.shape[1], device=tokens.device),
        enc_h=enc_h)
    return cross_entropy(logits, batch["labels"])


def train_input_specs(cfg, shape: ShapeConfig):
    specs = token_specs(shape.global_batch, shape.seq_len)
    specs["frames"] = spec(
        (shape.global_batch, cfg.n_audio_frames, cfg.d_frontend),
        torch.bfloat16)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    dt = dtype_of(cfg)
    L_, K, h = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {
        "self_k": spec((L_, batch, seq, K, h), dt),
        "self_v": spec((L_, batch, seq, K, h), dt),
        "cross_k": spec((L_, batch, cfg.n_audio_frames, K, h), dt),
        "cross_v": spec((L_, batch, cfg.n_audio_frames, K, h), dt),
    }


@torch.no_grad()
def decode_fn(cfg, params, caches, batch, pos):
    tokens = batch["tokens"]
    T = caches["self_k"].shape[2]
    kv_positions = L.cache_kv_positions(pos, T, ring=False,
                                        device=tokens.device)
    return decode_stack(cfg, params, tokens,
                        torch.tensor([pos], device=tokens.device),
                        caches=caches, cache_slot=pos,
                        kv_positions=kv_positions)


@torch.no_grad()
def prefill_fn(cfg, params, batch):
    enc_h = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    logits, _ = decode_stack(
        cfg, params, tokens, torch.arange(tokens.shape[1], device=tokens.device),
        enc_h=enc_h, last_only=True)
    return logits, None


@torch.no_grad()
def logits_fn(cfg, params, batch):
    tokens = batch["tokens"]
    enc_h = torch.zeros((tokens.shape[0], cfg.n_audio_frames, cfg.d_model),
                        dtype=dtype_of(cfg), device=tokens.device)
    return decode_stack(
        cfg, params, tokens, torch.arange(tokens.shape[1], device=tokens.device),
        enc_h=enc_h)[0]


def build(cfg: ModelConfig) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        param_specs=functools.partial(param_specs, cfg),
        loss_fn=functools.partial(loss_fn, cfg),
        train_input_specs=functools.partial(train_input_specs, cfg),
        prefill_fn=functools.partial(prefill_fn, cfg),
        decode_fn=functools.partial(decode_fn, cfg),
        cache_specs=functools.partial(cache_specs, cfg),
        decode_input_specs=token_input_specs,
        logits_fn=functools.partial(logits_fn, cfg),
    )

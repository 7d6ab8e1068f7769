"""Decoder-only transformer: qwen2*, gemma*, mixtral/llama4 (MoE) and the
llava backbone; gemma2's local/global alternation and softcaps. Port of
``repro.models.transformer``: a Python loop over the layers (one
``ParamTree`` per layer), each layer rematerialised in backward under
``cfg.remat`` when grad is on (training), as the JAX scan's body is.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distr.shardctx import shard
from repro_torch.models import layers as L
from repro_torch.models.base import (ModelBundle, cross_entropy, dtype_of,
                                     remat, spec, token_input_specs,
                                     token_specs)


def _flavor(cfg: ModelConfig, layer_local: bool) -> L.AttnFlavor:
    window = cfg.sliding_window if (cfg.sliding_window and
                                    (not cfg.local_global_alternating or
                                     layer_local)) else 0
    return L.AttnFlavor(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias,
        attn_softcap=cfg.attn_softcap, sliding_window=window)


def param_specs(cfg: ModelConfig):
    dt = dtype_of(cfg)

    def block():
        b = {
            "ln1": spec((cfg.d_model,), dt),
            "ln2": spec((cfg.d_model,), dt),
            "attn": L.attn_specs(cfg.d_model, _flavor(cfg, True), dt),
        }
        if cfg.family == "moe":
            b["moe"] = L.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts, dt)
        else:
            b["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, dt)
        return b

    p = {
        "embed": L.embed_specs(cfg.vocab, cfg.d_model, dt, cfg.tie_embeddings),
        "layers": [block() for _ in range(cfg.n_layers)],
        "ln_f": spec((cfg.d_model,), dt),
    }
    if cfg.family == "llava":
        p["vision_proj"] = spec((cfg.d_frontend, cfg.d_model), dt)
    return p


def _layer(cfg: ModelConfig, p, h, layer_idx, positions, cache, cache_slot,
           kv_positions, kv_chunk):
    # gemma2: even layers sliding-window ("local"), odd layers global, as a
    # per-layer window (0 = global) applied by the attention's mask
    if cfg.local_global_alternating:
        fl = _flavor(cfg, False)
        window_rt = cfg.sliding_window if layer_idx % 2 == 0 else 0
    else:
        fl = _flavor(cfg, True)
        window_rt = None
    attn_out, _ = L.attention(
        p["attn"], L.rmsnorm(h, p["ln1"]), fl,
        positions=positions, cache=cache, cache_slot=cache_slot,
        kv_positions=kv_positions, kv_chunk=kv_chunk,
        window_runtime=window_rt)
    h = h + attn_out
    hn = L.rmsnorm(h, p["ln2"])
    if cfg.family == "moe":
        ff = L.moe_mlp(p["moe"], hn, cfg.n_experts, cfg.experts_per_token,
                       cfg.moe_capacity_factor)
    else:
        ff = L.mlp(p["mlp"], hn, cfg.mlp)
    return shard(h + ff, "batch", None, "embed")


def forward(cfg: ModelConfig, params, h, positions, caches=None,
            cache_slot=None, kv_positions=None, kv_chunk: int = 0):
    """h: (B, S, D) embedded input. caches: None or (k, v), each
    (L, B, T, K, h), written in place."""
    kv_chunk = kv_chunk or cfg.kv_chunk
    for i, lp in enumerate(params["layers"]):
        if caches is None:
            h = remat(cfg, functools.partial(_layer, cfg, lp), h, i,
                      positions, None, None, None, kv_chunk)
        else:
            h = _layer(cfg, lp, h, i, positions, (caches[0][i], caches[1][i]),
                       cache_slot, kv_positions, kv_chunk)
    return L.rmsnorm(h, params["ln_f"]), caches


def _embed_batch(cfg, params, batch):
    """Token embeddings, after llava's projected patches where the batch
    has them (a batch without is the text a served decode reads)."""
    h = L.embed(params["embed"], batch["tokens"], cfg.d_model, cfg.embed_scale)
    if cfg.family == "llava" and "patches" in batch:
        patches = L.mm(batch["patches"].to(h.dtype), params["vision_proj"])
        h = torch.cat([patches, h], dim=1)      # cat promotes, as jnp does
    return h


def loss_fn(cfg: ModelConfig, params, batch):
    h = _embed_batch(cfg, params, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _ = forward(cfg, params, h, positions)
    logits = L.unembed(params["embed"], h, cfg.logit_softcap,
                       cfg.tie_embeddings)
    labels = batch["labels"]
    if cfg.family == "llava":   # image positions carry no next-token loss
        pad = torch.full((labels.shape[0], cfg.n_image_tokens), -100,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return cross_entropy(logits, labels)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    specs = token_specs(shape.global_batch, shape.seq_len)
    if cfg.family == "llava":
        specs["patches"] = spec(
            (shape.global_batch, cfg.n_image_tokens, cfg.d_frontend),
            torch.bfloat16)
        # text tokens fill the remaining sequence budget
        specs["tokens"] = spec(
            (shape.global_batch, shape.seq_len - cfg.n_image_tokens),
            torch.int32)
        specs["labels"] = specs["tokens"]
    return specs


def _hidden(cfg: ModelConfig, params, batch, kv_chunk=0):
    h = _embed_batch(cfg, params, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    return forward(cfg, params, h, positions, kv_chunk=kv_chunk)[0]


@torch.no_grad()
def logits_fn(cfg: ModelConfig, params, batch):
    """Every position's logits of one full forward (no cache): (B, S, V)."""
    return L.unembed(params["embed"], _hidden(cfg, params, batch),
                     cfg.logit_softcap, cfg.tie_embeddings)


# -- serving ----------------------------------------------------------------------
def _ring(cfg: ModelConfig) -> bool:
    """Ring-buffer (window-capped) cache only for pure-SWA archs: gemma2's
    alternating global layers need the full-length cache."""
    return bool(cfg.sliding_window) and not cfg.local_global_alternating


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    dt = dtype_of(cfg)
    eff = min(seq, cfg.sliding_window) if _ring(cfg) else seq
    shape = (cfg.n_layers, batch, eff, cfg.n_kv_heads, cfg.head_dim)
    return (spec(shape, dt), spec(shape, dt))


@torch.no_grad()
def decode_fn(cfg: ModelConfig, params, caches, batch, pos: int, kv_chunk=0):
    """One decode step. batch = {"tokens": (B, 1)}; pos: the global
    position. SWA archs address the cache ring-buffer style (pos % window).
    The caches are written in place and returned."""
    h = L.embed(params["embed"], batch["tokens"], cfg.d_model, cfg.embed_scale)
    T = caches[0].shape[2]
    ring = _ring(cfg)
    slot = pos % T if ring else pos
    kv_positions = L.cache_kv_positions(pos, T, ring, device=h.device)
    positions = torch.tensor([pos], device=h.device)
    h, caches = forward(cfg, params, h, positions, caches=caches,
                        cache_slot=slot, kv_positions=kv_positions,
                        kv_chunk=kv_chunk)
    logits = L.unembed(params["embed"], h, cfg.logit_softcap,
                       cfg.tie_embeddings)
    return logits, caches


@torch.no_grad()
def prefill_fn(cfg: ModelConfig, params, batch, kv_chunk=0):
    """The forward over the whole prompt; returns the last position's
    logits and no cache (serving fills the cache by decode steps)."""
    h = _hidden(cfg, params, batch, kv_chunk)
    logits = L.unembed(params["embed"], h[:, -1:], cfg.logit_softcap,
                       cfg.tie_embeddings)
    return logits, None


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

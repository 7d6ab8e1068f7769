"""Zamba2: Mamba2 (SSD) backbone + a *shared* attention block applied before
each segment of ``shared_attn_every`` mamba layers (one parameter set,
per-segment KV caches). Port of ``repro.models.zamba2``.

Mamba2 block: in_proj -> (z, x, B, C, dt); causal depthwise conv over
(x,B,C) keeping K - 1 steps of state; per-head scalar decay exp(A*dt) with
A = -exp(a_log) and dt = softplus(dt + dt_bias); state h (B, H, P, N)
carried over time; y = C.h + D*x, gated by silu(z). Each mamba block is
rematerialised in backward under ``cfg.remat`` when grad is on (the JAX
segment scan's body; the shared block is not).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distr.shardctx import shard
from repro_torch.models import layers as L
from repro_torch.models.base import (ModelBundle, cross_entropy, dtype_of,
                                     remat, scan_shapes_only, spec,
                                     token_input_specs, token_specs)


def _dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    H = cfg.ssm_heads
    P = d_inner // H
    N = cfg.ssm_state
    conv_ch = d_inner + 2 * N
    return d_inner, H, P, N, conv_ch


def _sites(cfg: ModelConfig):
    """Segments of mamba layers, each preceded by the shared attn block."""
    every = cfg.shared_attn_every
    n_full, rem = divmod(cfg.n_layers, every)
    return [every] * n_full + ([rem] if rem else [])


def mamba_block_specs(cfg: ModelConfig, dt):
    D = cfg.d_model
    d_inner, H, P, N, conv_ch = _dims(cfg)
    return {
        "ln": spec((D,), dt),
        "in_proj": spec((D, 2 * d_inner + 2 * N + H), dt),
        "conv_w": spec((conv_ch, cfg.ssm_conv), dt),
        "conv_b": spec((conv_ch,), dt),
        "a_log": spec((H,), torch.float32),
        "d_skip": spec((H,), torch.float32),
        "dt_bias": spec((H,), torch.float32),
        "ln_y": spec((d_inner,), dt),
        "out_proj": spec((d_inner, D), dt),
    }


def shared_attn_specs(cfg: ModelConfig, dt):
    fl = L.AttnFlavor(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    return {
        "ln1": spec((cfg.d_model,), dt),
        "attn": L.attn_specs(cfg.d_model, fl, dt),
        "ln2": spec((cfg.d_model,), dt),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, "gelu", dt),
    }


def param_specs(cfg: ModelConfig):
    dt = dtype_of(cfg)
    return {
        "embed": L.embed_specs(cfg.vocab, cfg.d_model, dt, tied=False),
        "shared": shared_attn_specs(cfg, dt),
        "segments": [[mamba_block_specs(cfg, dt) for _ in range(seg)]
                     for seg in _sites(cfg)],
        "ln_f": spec((cfg.d_model,), dt),
    }


def _causal_conv(x, w, b, state=None):
    """x: (B, T, C); depthwise causal conv, kernel K. state: (B, K-1, C)."""
    K = w.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[:, i] for i in range(K))
    new_state = xp[:, -(K - 1):, :]
    return F.silu(out + b), new_state


def _ssd_scan(xh, Bm, Cm, dtv, a, state):
    """xh: (B,T,H,P); Bm,Cm: (B,T,N); dtv: (B,T,H); a: (H,) < 0.
    h_t = exp(a dt) h_{t-1} + dt * x_t (x) B_t ;  y_t = h_t . C_t.
    state: (B,H,P,N)."""
    if scan_shapes_only():
        return xh.new_empty(xh.shape), state.new_empty(state.shape)
    h = state
    ys = []
    for t in range(xh.shape[1]):
        xt, bt, ct, dt_t = xh[:, t], Bm[:, t], Cm[:, t], dtv[:, t]
        decay = torch.exp(a[None, :] * dt_t)                   # (B,H)
        upd = (dt_t[..., None, None] * xt[..., :, None]
               * bt[:, None, None, :])                         # (B,H,P,N)
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, ct))
    return torch.stack(ys, dim=1), h                           # (B,T,H,P)


def mamba_block(cfg, p, h, conv_state=None, ssd_state=None):
    B, T, D = h.shape
    d_inner, H, P, N, conv_ch = _dims(cfg)
    hin = L.rmsnorm(h, p["ln"])
    proj = L.mm(hin, p["in_proj"])                             # (B,T,2di+2N+H)
    z, xbc, dtv = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    xh = x.reshape(B, T, H, P).float()
    dtv = F.softplus(dtv.float() + p["dt_bias"][None, None, :])  # (B,T,H)
    a = -torch.exp(p["a_log"])
    if ssd_state is None:
        ssd_state = torch.zeros((B, H, P, N), dtype=torch.float32,
                                device=h.device)
    y, new_ssd = _ssd_scan(xh, Bm.float(), Cm.float(), dtv, a, ssd_state)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(B, T, d_inner).to(h.dtype)
    y = L.rmsnorm(y, p["ln_y"]) * F.silu(z)
    return h + L.mm(y, p["out_proj"]), new_conv, new_ssd


def shared_block(cfg, p, h, positions, cache=None, cache_slot=None,
                 kv_positions=None):
    fl = L.AttnFlavor(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    att, _ = L.attention(p["attn"], L.rmsnorm(h, p["ln1"]), fl,
                         positions=positions, cache=cache,
                         cache_slot=cache_slot, kv_positions=kv_positions,
                         kv_chunk=cfg.kv_chunk)
    h = h + att
    h = h + L.mlp(p["mlp"], L.rmsnorm(h, p["ln2"]), "gelu")
    return shard(h, "batch", None, "embed")


def forward(cfg: ModelConfig, params, tokens, positions, states=None,
            cache_slot=None, kv_positions=None):
    """states: None (no cache) or the decode cache, written in place."""
    h = L.embed(params["embed"], tokens, cfg.d_model, False)
    decode = states is not None
    for i, seg in enumerate(params["segments"]):
        h = shared_block(cfg, params["shared"], h, positions,
                         cache=states["kv"][i] if decode else None,
                         cache_slot=cache_slot, kv_positions=kv_positions)
        for j, lp in enumerate(seg):
            if decode:
                h, nc, ns = mamba_block(cfg, lp, h, states["conv"][i][j],
                                        states["ssd"][i][j])
                states["conv"][i][j] = nc
                states["ssd"][i][j] = ns
            else:
                h = remat(cfg, lambda lp_, h_: mamba_block(cfg, lp_, h_)[0],
                          lp, h)
    h = L.rmsnorm(h, params["ln_f"])
    logits = h @ params["embed"]["out"].to(h.dtype)
    return shard(logits.float(), "batch", None, "vocab"), states


def loss_fn(cfg, params, batch):
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    logits, _ = forward(cfg, params, tokens, positions)
    return cross_entropy(logits, batch["labels"])


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    dt = dtype_of(cfg)
    d_inner, H, P, N, conv_ch = _dims(cfg)
    segs = _sites(cfg)
    kv = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "conv": [spec((seg, batch, cfg.ssm_conv - 1, conv_ch), dt)
                 for seg in segs],
        "ssd": [spec((seg, batch, H, P, N), torch.float32) for seg in segs],
        "kv": [(spec(kv, dt), spec(kv, dt)) for _ in segs],
    }


@torch.no_grad()
def decode_fn(cfg, params, states, batch, pos):
    tokens = batch["tokens"]
    T = states["kv"][0][0].shape[1]
    kv_positions = L.cache_kv_positions(pos, T, ring=False,
                                        device=tokens.device)
    return forward(cfg, params, tokens,
                   torch.tensor([pos], device=tokens.device), states=states,
                   cache_slot=pos, kv_positions=kv_positions)


@torch.no_grad()
def logits_fn(cfg, params, batch):
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return forward(cfg, params, tokens, positions)[0]


@torch.no_grad()
def prefill_fn(cfg, params, batch):
    return logits_fn(cfg, params, batch)[:, -1:], None


def build(cfg: ModelConfig) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        param_specs=functools.partial(param_specs, cfg),
        loss_fn=functools.partial(loss_fn, cfg),
        train_input_specs=lambda s: token_specs(s.global_batch, s.seq_len),
        prefill_fn=functools.partial(prefill_fn, cfg),
        decode_fn=functools.partial(decode_fn, cfg),
        cache_specs=functools.partial(cache_specs, cfg),
        decode_input_specs=token_input_specs,
        logits_fn=functools.partial(logits_fn, cfg),
    )

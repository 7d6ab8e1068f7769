"""RWKV6 "Finch": attention-free LM with data-dependent per-channel decay.
Port of ``repro.models.rwkv6``.

Time-mix: low-rank (LoRA) data-dependent decay w_t = exp(-exp(w0 + lora(x)));
wkv state recurrence S_t = diag(w_t) S_{t-1} + k_t^T v_t, in float32, run
as a loop over time (constant-size state: decode is O(1) memory a token).
The JAX package's simplification is kept: a plain per-channel lerp
token-shift instead of the ddlerp mixing stack. Each layer is
rematerialised in backward under ``cfg.remat`` when grad is on.
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

LORA_R = 64


def param_specs(cfg: ModelConfig):
    dt = dtype_of(cfg)
    D, F_, H, hd = cfg.d_model, cfg.d_ff, cfg.ssm_heads, cfg.head_dim

    def block():
        return {
            "ln1": spec((D,), dt), "ln2": spec((D,), dt),
            # time-mix
            "mu_r": spec((D,), dt), "mu_k": spec((D,), dt),
            "mu_v": spec((D,), dt), "mu_w": spec((D,), dt),
            "mu_g": spec((D,), dt),
            "wr": spec((D, D), dt), "wk": spec((D, D), dt),
            "wv": spec((D, D), dt), "wg": spec((D, D), dt),
            "w0": spec((D,), torch.float32),
            "w_lora_a": spec((D, LORA_R), dt), "w_lora_b": spec((LORA_R, D), dt),
            "bonus_u": spec((H, hd), torch.float32),
            "ln_x": spec((D,), dt),
            "wo": spec((D, D), dt),
            # channel-mix
            "mu_ck": spec((D,), dt), "mu_cr": spec((D,), dt),
            "wck": spec((D, F_), dt), "wcv": spec((F_, D), dt),
            "wcr": spec((D, D), dt),
        }

    return {
        "embed": L.embed_specs(cfg.vocab, cfg.d_model, dt, tied=False),
        "layers": [block() for _ in range(cfg.n_layers)],
        "ln_f": spec((D,), dt),
    }


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _wkv_scan(r, k, v, w, u, state):
    """r,k,v: (B,T,H,hd); w: (B,T,H,hd) decay in (0,1); state: (B,H,hd,hd).
    y_t = r_t . (S_{t-1} + u (x) k_t v_t);  S_t = diag(w_t) S_{t-1} + k_t (x) v_t.
    """
    if scan_shapes_only():
        return r.new_empty(r.shape), state.new_empty(state.shape)
    S = state
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]     # (B,H,hd)
        kv = kt[..., :, None] * vt[..., None, :]                # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               S + u[None, :, :, None] * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=1), S                            # (B,T,H,hd)


def _time_mix(cfg, p, x, shift_state, wkv_state):
    B, T, D = x.shape
    H, hd = cfg.ssm_heads, cfg.head_dim
    x_prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    xr = _lerp(x, x_prev, p["mu_r"])
    xk = _lerp(x, x_prev, p["mu_k"])
    xv = _lerp(x, x_prev, p["mu_v"])
    xw = _lerp(x, x_prev, p["mu_w"])
    xg = _lerp(x, x_prev, p["mu_g"])
    r = L.mm(xr, p["wr"]).reshape(B, T, H, hd).float()
    k = L.mm(xk, p["wk"]).reshape(B, T, H, hd).float()
    v = L.mm(xv, p["wv"]).reshape(B, T, H, hd).float()
    g = L.mm(xg, p["wg"])
    # data-dependent decay (the Finch contribution)
    dd = torch.tanh(xw.float() @ p["w_lora_a"].float()) @ p["w_lora_b"].float()
    w = torch.exp(-torch.exp(p["w0"].float() + dd))             # (B,T,D)
    w = w.reshape(B, T, H, hd)
    y, wkv_state = _wkv_scan(r, k, v, w, p["bonus_u"].float(), wkv_state)
    y = y.reshape(B, T, D).to(x.dtype)
    y = L.rmsnorm(y, p["ln_x"]) * F.silu(g)
    return L.mm(y, p["wo"]), x[:, -1, :], wkv_state


def _channel_mix(p, x, shift_state):
    x_prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    xk = _lerp(x, x_prev, p["mu_ck"])
    xr = _lerp(x, x_prev, p["mu_cr"])
    k = torch.square(torch.relu(L.mm(xk, p["wck"])))
    k = shard(k, "batch", None, "ff")
    return torch.sigmoid(L.mm(xr, p["wcr"])) * L.mm(k, p["wcv"]), x[:, -1, :]


def _block(cfg, lp, h, tm_s, cm_s, wkv_s):
    att, tm_new, wkv_new = _time_mix(cfg, lp, L.rmsnorm(h, lp["ln1"]), tm_s,
                                     wkv_s)
    h = h + att
    ffn, cm_new = _channel_mix(lp, L.rmsnorm(h, lp["ln2"]), cm_s)
    return shard(h + ffn, "batch", None, "embed"), tm_new, cm_new, wkv_new


def forward(cfg: ModelConfig, params, tokens, states=None, last_only=False):
    """states: None (zero states; fresh ones returned, stacked by layer) or
    the decode cache, written in place."""
    B, T = tokens.shape
    D, H, hd = cfg.d_model, cfg.ssm_heads, cfg.head_dim
    h = L.embed(params["embed"], tokens, D, False)
    fresh = states is None
    if fresh:
        zero = h.new_zeros((B, D))
        wkv0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=h.device)
        new = {"tm_shift": [], "cm_shift": [], "wkv": []}
    for i, lp in enumerate(params["layers"]):
        if fresh:
            h, tm, cm, wkv = remat(cfg, functools.partial(_block, cfg, lp),
                                   h, zero, zero, wkv0)
            new["tm_shift"].append(tm)
            new["cm_shift"].append(cm)
            new["wkv"].append(wkv)
        else:
            h, tm, cm, wkv = _block(cfg, lp, h, states["tm_shift"][i],
                                    states["cm_shift"][i], states["wkv"][i])
            states["tm_shift"][i] = tm
            states["cm_shift"][i] = cm
            states["wkv"][i] = wkv
    if fresh:
        states = {k: torch.stack(v) for k, v in new.items()}
    h = L.rmsnorm(h, params["ln_f"])
    if last_only:
        h = h[:, -1:]
    logits = h @ params["embed"]["out"].to(h.dtype)
    return shard(logits.float(), "batch", None, "vocab"), states


def loss_fn(cfg, params, batch):
    logits, _ = forward(cfg, params, batch["tokens"])
    return cross_entropy(logits, batch["labels"])


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    del seq  # constant-size state
    dt = dtype_of(cfg)
    D, H, hd = cfg.d_model, cfg.ssm_heads, cfg.head_dim
    return {
        "tm_shift": spec((cfg.n_layers, batch, D), dt),
        "cm_shift": spec((cfg.n_layers, batch, D), dt),
        "wkv": spec((cfg.n_layers, batch, H, hd, hd), torch.float32),
    }


@torch.no_grad()
def decode_fn(cfg, params, states, batch, pos):
    del pos  # recurrence is position-free
    return forward(cfg, params, batch["tokens"], states=states)


@torch.no_grad()
def prefill_fn(cfg, params, batch):
    return forward(cfg, params, batch["tokens"], last_only=True)


@torch.no_grad()
def logits_fn(cfg, params, batch):
    return forward(cfg, params, batch["tokens"])[0]


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

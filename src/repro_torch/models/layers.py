"""Shared transformer building blocks: port of ``repro.models.layers``.

Params are ``ParamTree`` nodes read like the JAX package's dicts. Dtypes
follow the JAX package's promotion, not torch's: a product of a bfloat16
and a float32 operand is float32 (``mm``), and gemma's embedding scale, a
``np.float32``, turns a bfloat16 embedding into a float32 residual stream.

Attention is the online-softmax (flash-attention pattern) loop over KV
chunks of the JAX package, with its arithmetic: masked logits are
``NEG_INF = -1e30``, not ``-inf``, so a fully masked chunk contributes
``p = 1`` per slot until a later valid chunk rescales it away through
``alpha = exp(m - m_new) = 0``, and the normaliser is clamped at 1e-30.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distr.shardctx import shard
from repro_torch.models.base import spec

NEG_INF = -1e30


# -- helpers -------------------------------------------------------------------
def promoted(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, b.dtype)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the JAX package's promotion (bf16 @ f32 is f32)."""
    dt = promoted(x, w)
    return x.to(dt) @ w.to(dt)


def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope(x, positions, theta: float):
    """x: (..., S, n, h); positions: (S,) broadcast over batch/heads."""
    h = x.shape[-1]
    half = h // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[:, None].float() * freqs                      # (S, half)
    cos = torch.cos(ang)[:, None, :]                              # (S, 1, half)
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ---------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnFlavor:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    sliding_window: int = 0      # 0 = full
    causal: bool = True
    use_rope: bool = True


def attn_specs(d_model: int, fl: AttnFlavor, dtype):
    H, K, h = fl.n_heads, fl.n_kv_heads, fl.head_dim
    p = {
        "wq": spec((d_model, H * h), dtype),
        "wk": spec((d_model, K * h), dtype),
        "wv": spec((d_model, K * h), dtype),
        "wo": spec((H * h, d_model), dtype),
    }
    if fl.qkv_bias:
        p.update({"bq": spec((H * h,), dtype), "bk": spec((K * h,), dtype),
                  "bv": spec((K * h,), dtype)})
    return p


def _proj_qkv(p, x, fl: AttnFlavor):
    """q as (B, S, K, G, h), grouped by KV head; k, v as (B, S, K, h)."""
    B, S, _ = x.shape
    H, K, h = fl.n_heads, fl.n_kv_heads, fl.head_dim
    q, k, v = mm(x, p["wq"]), mm(x, p["wk"]), mm(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, K, H // K, h), k.reshape(B, S, K, h),
            v.reshape(B, S, K, h))


def chunked_attention(q, k, v, *, q_positions, kv_positions, fl: AttnFlavor,
                      kv_chunk: int = 1024, softcap_val: float = 0.0,
                      window_runtime=None):
    """Online-softmax attention.

    q: (B, S, K, G, h);  k, v: (B, T, K, h)
    q_positions: (S,), kv_positions: (T,) — global token positions for the
    causal / sliding-window masks (valid entries >= 0; padding marked -1).
    ``window_runtime``: gemma2's per-layer window (0 = global layer).
    """
    B, S, K, G, h = q.shape
    T = k.shape[1]
    if S == 1:
        kv_chunk = 0                  # decode: one chunk, as the JAX package
    C = min(kv_chunk, T) if kv_chunk else T
    pad = (-T) % C
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    qf = q.float() * (1.0 / np.sqrt(h))
    dev = q.device
    m = torch.full((B, S, K, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, K, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, K, G, h), dtype=torch.float32, device=dev)
    for c0 in range(0, T + pad, C):
        kch = k[:, c0:c0 + C].float()
        vch = v[:, c0:c0 + C].float()
        pch = kv_positions[c0:c0 + C]
        logits = torch.einsum("bskgh,bckh->bskgc", qf, kch)
        logits = softcap(logits, softcap_val)
        valid = (pch >= 0)[None, :]                            # (1, C)
        rel = q_positions[:, None] - pch[None, :]              # (S, C)
        if fl.causal:
            valid = valid & (rel >= 0)
        if fl.sliding_window:
            valid = valid & (rel < fl.sliding_window)
        if window_runtime is not None and window_runtime > 0:
            valid = valid & (rel < window_runtime)
        logits = logits.masked_fill(~valid[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p_ = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p_.sum(dim=-1)
        pv = torch.einsum("bskgc,bckh->bskgh", p_, vch)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def attention(p, x, fl: AttnFlavor, *, positions, cache=None, cache_slot=None,
              kv_positions=None, kv_chunk: int = 1024, window_runtime=None):
    """Full attention layer.

    Prefill: cache=None, positions (S,).
    Decode: cache=(k, v) of (B, T, K, h), written IN PLACE at ``cache_slot``
    (the ring-buffer slot for SWA archs; clamped so the write fits, as
    ``dynamic_update_slice`` clamps); x is (B, 1, D); kv_positions (T,)
    gives the global token position held by each cache slot (-1 = empty).
    Returns (out, cache), the cache being the same tensors.
    """
    B, S, _ = x.shape
    q, k, v = _proj_qkv(p, x, fl)
    if fl.use_rope:
        q = rope(q.reshape(B, S, -1, fl.head_dim), positions, fl.rope_theta
                 ).reshape(q.shape)
        k = rope(k, positions, fl.rope_theta)
    if cache is None:
        q = shard(q, "batch", "seq_shard", None, None, None)
        out = chunked_attention(q, k, v, q_positions=positions,
                                kv_positions=positions, fl=fl,
                                kv_chunk=kv_chunk,
                                window_runtime=window_runtime)
    else:
        ck, cv = cache
        slot = min(max(int(cache_slot), 0), ck.shape[1] - S)
        ck[:, slot:slot + S] = k.to(ck.dtype)
        cv[:, slot:slot + S] = v.to(cv.dtype)
        out = chunked_attention(q, ck, cv, q_positions=positions,
                                kv_positions=kv_positions, fl=fl,
                                kv_chunk=kv_chunk,
                                window_runtime=window_runtime)
    out = out.reshape(B, S, fl.n_heads * fl.head_dim)
    return mm(out, p["wo"]), cache


def cache_kv_positions(pos: int, T: int, ring: bool, device=None):
    """Global position held by each cache slot after writing step `pos`.

    Linear cache: slot i holds position i (filled iff i <= pos).
    Ring cache (SWA window == T): slot i holds the newest position p <= pos
    with p % T == i.
    """
    idx = torch.arange(T, device=device)
    if not ring:
        return torch.where(idx <= pos, idx, -1)
    p = pos - torch.remainder(pos - idx, T)
    return torch.where(p >= 0, p, -1)


# -- MLPs --------------------------------------------------------------------------
def mlp_specs(d_model: int, d_ff: int, kind: str, dtype):
    if kind in ("swiglu", "geglu"):
        return {"wg": spec((d_model, d_ff), dtype),
                "wu": spec((d_model, d_ff), dtype),
                "wd": spec((d_ff, d_model), dtype)}
    return {"wu": spec((d_model, d_ff), dtype),
            "wd": spec((d_ff, d_model), dtype)}


def mlp(p, x, kind: str):
    if kind == "swiglu":
        hidden = F.silu(mm(x, p["wg"])) * mm(x, p["wu"])
    elif kind == "geglu":
        hidden = F.gelu(mm(x, p["wg"]), approximate="tanh") * mm(x, p["wu"])
    else:
        hidden = F.gelu(mm(x, p["wu"]), approximate="tanh")
    hidden = shard(hidden, "batch", None, "ff")
    return mm(hidden, p["wd"])


# -- MoE (mixtral / llama4) ----------------------------------------------------------
def moe_specs(d_model: int, d_ff: int, n_experts: int, dtype):
    return {"router": spec((d_model, n_experts), torch.float32),
            "wg": spec((n_experts, d_model, d_ff), dtype),
            "wu": spec((n_experts, d_model, d_ff), dtype),
            "wd": spec((n_experts, d_ff, d_model), dtype)}


def _experts(xe, w, eq):
    dt = promoted(xe, w)
    return torch.einsum(eq, xe.to(dt), w.to(dt))


def moe_mlp(p, x, n_experts: int, top_k: int, capacity_factor: float = 1.25):
    """Sort-based capacity dispatch, local to each batch row.

    Each row routes its own S·k decisions: top-k of the router's softmax,
    renormalised; a stable argsort on the expert ids gives each decision
    its position within its expert; positions at or past the capacity
    ``ceil(S · cf · k / E)`` drop. Expert FFNs run as one batched einsum
    over (row, expert, slot); results go back by scatter-add. (The order
    of exact ties in ``torch.topk`` is not specified; random inputs have
    none.)
    """
    B, S, D = x.shape
    E = n_experts
    cap = max(1, int(np.ceil(S * capacity_factor * top_k / E)))
    dev = x.device
    logits = x.float() @ p["router"]                              # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)               # (B, S, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(B, S * top_k)
    flat_w = top_p.reshape(B, S * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    tok_of = order // top_k
    e_sorted = torch.gather(flat_e, 1, order)
    w_sorted = torch.gather(flat_w, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, e_sorted, torch.ones_like(e_sorted))
    offsets = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(S * top_k, device=dev)[None, :]
                - torch.gather(offsets, 1, e_sorted))
    keep = pos_in_e < cap
    slot = e_sorted * cap + torch.where(keep, pos_in_e, 0)        # (B, S*k)
    row = torch.arange(B, device=dev)[:, None]
    flat_slot = (row * (E * cap) + slot).reshape(-1)
    xt = torch.gather(x, 1, tok_of[..., None].expand(B, S * top_k, D))
    xt = torch.where(keep[..., None], xt, torch.zeros((), dtype=x.dtype,
                                                      device=dev))
    xe = torch.zeros((B * E * cap, D), dtype=x.dtype, device=dev)
    xe.index_add_(0, flat_slot, xt.reshape(-1, D))
    xe = shard(xe.reshape(B, E, cap, D), "batch", "expert", None, None)
    he = F.silu(_experts(xe, p["wg"], "becd,edf->becf")) * \
        _experts(xe, p["wu"], "becd,edf->becf")
    he = shard(he, "batch", "expert", None, "ff")
    ye = _experts(he, p["wd"], "becf,efd->becd")                  # (B, E, cap, D)
    g = ye.reshape(B * E * cap, D)[flat_slot].reshape(B, S * top_k, D)
    g = torch.where(keep[..., None], g, torch.zeros((), dtype=ye.dtype,
                                                    device=dev))
    g = g * w_sorted[..., None].to(ye.dtype)
    out = torch.zeros((B * S, D), dtype=ye.dtype, device=dev)
    out.index_add_(0, (row * S + tok_of).reshape(-1), g.reshape(-1, D))
    return out.reshape(B, S, D)


# -- embeddings -----------------------------------------------------------------------
def embed_specs(vocab: int, d_model: int, dtype, tied: bool):
    p = {"tok": spec((vocab, d_model), dtype)}
    if not tied:
        p["out"] = spec((d_model, vocab), dtype)
    return p


def embed(p, tokens, d_model: int, scale: bool):
    h = p["tok"][tokens.long()]
    if scale:
        # the JAX package multiplies by a np.float32: a bfloat16 embedding
        # becomes float32 there, and so here
        s = np.float32(np.sqrt(d_model))
        h = h.to(torch.promote_types(h.dtype, torch.float32)) * float(s)
    return shard(h, "batch", None, "embed")


def unembed(p, h, cap: float, tied: bool):
    w = p["tok"].T if tied else p["out"]
    logits = h @ w.to(h.dtype)
    return shard(softcap(logits.float(), cap), "batch", None, "vocab")


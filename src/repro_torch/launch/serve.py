"""Serving entry point: batched greedy decode of one model. Port of
``repro.launch.serve``, with ``--device`` (default ``cuda``; without a card
that raises, it never falls back to the host).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tiny 1
  python -m repro_torch.launch.serve --arch qwen2-1.5b --tiny 0   # on a card
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import get_model
from repro_torch.models.base import resolve_device
from repro_torch.serve.serve_step import decode_greedy, prefill_cache


def tiny_config(cfg):
    """The JAX package's CPU-scale reduction of a config (its
    ``launch.train.tiny_config``), keeping the family's quirks. The
    family's keys override the common ones: the JAX version passes
    zamba2's ``n_layers`` twice to ``dataclasses.replace``, which raises."""
    kw = dict(n_layers=2, d_model=64, d_ff=128, vocab=251, n_heads=4,
              n_kv_heads=2, head_dim=16, dtype="float32")
    if cfg.family == "moe":
        kw.update(n_experts=4)
    if cfg.family in ("rwkv6", "zamba2"):
        kw.update(ssm_heads=4)
    if cfg.family == "whisper":
        kw.update(encoder_layers=2, n_audio_frames=8, d_frontend=16)
    if cfg.family == "llava":
        kw.update(n_image_tokens=4, d_frontend=16)
    if cfg.family == "zamba2":
        kw.update(shared_attn_every=2, ssm_state=8, n_layers=4, n_heads=4,
                  n_kv_heads=4)
    return dataclasses.replace(cfg, **kw)


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (batch, max_new) int32
    prefill_ms: float             # the prompt's teacher-forced decode steps
    decode_ms: float              # the greedy steps after it
    decode_steps: int

    @property
    def tokens_per_s(self) -> float:
        seconds = (self.prefill_ms + self.decode_ms) / 1e3
        return self.tokens.numel() / seconds


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--tiny", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = tiny_config(cfg)
    model = get_model(cfg)
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    cache_len = args.prompt_len + args.max_new
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_cache(model, params, prompt, cache_len)
    _sync(dev)
    t1 = time.perf_counter()
    out = decode_greedy(model, params, logits, cache, args.prompt_len,
                        args.max_new)
    _sync(dev)
    t2 = time.perf_counter()
    res = ServeResult(tokens=out, prefill_ms=1e3 * (t1 - t0),
                      decode_ms=1e3 * (t2 - t1),
                      decode_steps=args.max_new - 1)
    print(f"[serve] {cfg.name} on {dev}: generated {tuple(out.shape)} in "
          f"{(t2 - t0):.2f}s ({res.tokens_per_s:.1f} tok/s; prefill "
          f"{res.prefill_ms:.1f} ms, {res.decode_steps} decode steps "
          f"{res.decode_ms:.1f} ms)")
    print(f"[serve] first row: {out[0].cpu().numpy()[:12]}")
    return res


if __name__ == "__main__":
    main()

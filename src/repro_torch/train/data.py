"""Deterministic synthetic data pipeline (token streams + family extras).
Port of ``repro.train.data``: the same numpy draws, so the same
``(seed, step, host)`` gives bit-identical arrays in both packages.

Deterministic per (seed, step, host): every host computes only its shard of
the global batch; restart-safe (the stream index derives from the step, so
resuming from step N replays exactly the post-N stream) and elastic-safe
(host count can change between runs; the global batch content is invariant).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    # markov-chain-ish synthetic text: more structure than uniform noise so
    # loss curves actually descend.
    branch: int = 31


def _batch_rng(seed: int, step: int):
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                    data_cfg: DataConfig = DataConfig(),
                    host_index: int = 0, host_count: int = 1):
    """Returns this host's slice of the global batch for `step`."""
    rng = _batch_rng(data_cfg.seed, step)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "llava":
        S = S - cfg.n_image_tokens
    # low-entropy sequence: x_{t+1} = (a*x_t + noise) % vocab
    a = 31
    x0 = rng.integers(0, cfg.vocab, size=(B, 1))
    noise = rng.integers(0, data_cfg.branch, size=(B, S + 1))
    toks = np.zeros((B, S + 1), dtype=np.int64)
    toks[:, 0] = x0[:, 0]
    for t in range(S):
        toks[:, t + 1] = (a * toks[:, t] + noise[:, t]) % cfg.vocab
    lo = host_index * B // host_count
    hi = (host_index + 1) * B // host_count
    batch = {"tokens": toks[lo:hi, :-1].astype(np.int32),
             "labels": toks[lo:hi, 1:].astype(np.int32)}
    if cfg.family == "whisper":
        batch["frames"] = rng.normal(
            size=(hi - lo, cfg.n_audio_frames, cfg.d_frontend)).astype(np.float32)
    if cfg.family == "llava":
        batch["patches"] = rng.normal(
            size=(hi - lo, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    return batch


def stream(cfg: ModelConfig, shape: ShapeConfig, start_step: int = 0,
           **kw) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, shape, step, **kw)
        step += 1


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``, dtypes kept."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

"""Model registry: config -> ModelBundle (family dispatch). Port of
``repro.models.registry``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.models.base import ModelBundle

_FAMILIES = {
    "dense": transformer.build,
    "moe": transformer.build,
    "llava": transformer.build,
    "rwkv6": rwkv6.build,
    "zamba2": zamba2.build,
    "whisper": whisper.build,
}


def get_model(cfg: ModelConfig) -> ModelBundle:
    return _FAMILIES[cfg.family](cfg)


def forward_reference(cfg: ModelConfig) -> ModelBundle:
    """The bundle whose ``logits_fn`` teacher-forced decode steps equal. A
    decode step (S = 1) never drops an MoE decision (its k experts are
    distinct, and the capacity is at least 1), while a forward over S
    tokens drops those past ``ceil(S · cf · k / E)``; so for moe the
    reference runs at cf = E / k, which drops none."""
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.n_experts / cfg.experts_per_token)
    return get_model(cfg)

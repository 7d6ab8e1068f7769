"""Model configs (one file per assigned arch) and the shape grid: port of
``repro.configs.base``, with the same fields and numbers.

``get_config(name)`` resolves ``repro_torch.configs.<name_with_underscores>
.CONFIG``; CLI overrides use ``--set key=value`` (``apply_overrides``).
The training fields (``optimizer``, ``remat``, ``microbatches``,
``grad_accum_dtype``, ``hoist_weight_gather``, ``scan_unroll``) are the JAX
package's settings, carried over so that the configs stay equal; serving
reads none of them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

ARCHS = [
    "qwen2-1.5b", "qwen2-7b", "gemma-2b", "gemma2-9b", "mixtral-8x7b",
    "llama4-maverick-400b-a17b", "rwkv6-3b", "zamba2-1.2b",
    "whisper-medium", "llava-next-mistral-7b",
]


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str                   # dense | moe | rwkv6 | zamba2 | whisper | llava
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention flavor ------------------------------------------------------
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    mlp: str = "swiglu"           # swiglu | geglu
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    sliding_window: int = 0       # 0 = full attention
    local_global_alternating: bool = False   # gemma2: alternate SWA/global
    embed_scale: bool = False     # gemma: scale embeddings by sqrt(d)
    tie_embeddings: bool = False
    # moe ----------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # ssm / hybrid ---------------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_conv: int = 4
    shared_attn_every: int = 0    # zamba2: shared block period
    # enc-dec / frontends ----------------------------------------------------------
    encoder_layers: int = 0
    n_audio_frames: int = 1500
    n_image_tokens: int = 576
    d_frontend: int = 1024        # stub frontend embedding width
    # training ----------------------------------------------------------------------
    optimizer: str = "adamw"      # adamw | adafactor
    remat: bool = True
    dtype: str = "bfloat16"
    kv_chunk: int = 1024          # online-softmax KV block (0 = single chunk)
    scan_unroll: bool = False
    microbatches: int = 1         # grad-accumulation microbatches (train)
    grad_accum_dtype: str = "float32"
    hoist_weight_gather: bool = False
    # which grid shapes this arch skips, with reasons
    skip_shapes: tuple = ()

    @property
    def attn_free(self) -> bool:
        return self.family == "rwkv6"

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND: the
        JAX package's formula, term for term."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        o = self.n_heads * self.head_dim * d
        attn = qkv + o
        if self.mlp in ("swiglu", "geglu"):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            mlp *= self.n_experts
            mlp += d * self.n_experts      # router
        if self.family == "rwkv6":
            attn = 5 * d * d               # r,k,v,g,o mixes
            mlp = 2 * d * f
        if self.family == "zamba2":
            attn = 4 * d * d               # in/out proj of mamba block approx
            mlp = 2 * d * f
        per_layer = attn + mlp
        total = self.n_layers * per_layer + v * d * (1 if self.tie_embeddings else 2)
        if self.family == "whisper":
            total += self.encoder_layers * (4 * d * d + 2 * d * f)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only) for 6·N_active·D."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_mlp = 3 * d * f
        full = self.param_count()
        return int(full - self.n_layers * dense_mlp * self.n_experts
                   + self.n_layers * dense_mlp * self.experts_per_token)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def shapes_for(cfg: ModelConfig) -> List[ShapeConfig]:
    return [s for s in SHAPES.values() if s.name not in cfg.skip_shapes]


def apply_overrides(cfg, pairs: List[str]):
    """--set key=value CLI overrides, typed by the field's current value."""
    for p in pairs:
        k, v = p.split("=", 1)
        cur = getattr(cfg, k)
        typ = type(cur)
        if typ is bool:
            val = v.lower() in ("1", "true", "yes")
        elif cur is None:
            val = v
        else:
            val = typ(v)
        if dataclasses.is_dataclass(cfg) and cfg.__dataclass_params__.frozen:
            object.__setattr__(cfg, k, val)
        else:
            setattr(cfg, k, val)
    return cfg

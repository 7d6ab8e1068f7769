"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
Adafactor: the JAX package sized Adam's states out of its TPU pod."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
    mlp="swiglu", n_experts=128, experts_per_token=1,
    optimizer="adafactor",
    skip_shapes=("long_500k",),   # full attention,
    microbatches=8,   # the JAX package's TPU training setting
    grad_accum_dtype="bfloat16",   # likewise
)

"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].
SWA caps the KV cache at the window, so long_500k decode runs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
    mlp="swiglu", n_experts=8, experts_per_token=2, sliding_window=4096,
    microbatches=4,   # the JAX package's TPU training setting
)

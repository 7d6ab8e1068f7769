"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. Hybrid: long_500k runs (shared-attn KV mesh-sharded)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="zamba2", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab=32000,
    ssm_state=64, ssm_heads=32, shared_attn_every=6,
    microbatches=4,   # the JAX package's TPU training setting
)

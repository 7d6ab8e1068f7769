"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; hf]. Constant-state decode: long_500k runs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv6", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, head_dim=64, d_ff=8960, vocab=65536,
    ssm_heads=40,
    microbatches=2,   # the JAX package's TPU training setting
)

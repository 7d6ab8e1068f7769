"""gemma2-9b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336, vocab=256000,
    mlp="geglu", embed_scale=True, tie_embeddings=True,
    logit_softcap=30.0, attn_softcap=50.0,
    sliding_window=4096, local_global_alternating=True,
    skip_shapes=("long_500k",),   # global (full-attn) layers every other block,
    microbatches=2,   # the JAX package's TPU training setting
)

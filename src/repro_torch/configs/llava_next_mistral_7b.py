"""llava-next-mistral-7b [vlm] — mistral-7b backbone, anyres tiling STUB
(input_specs provides precomputed patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="llava", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
    mlp="swiglu", n_image_tokens=576, d_frontend=1024,
    skip_shapes=("long_500k",),   # backbone treated as full attention (v0.2),
    microbatches=2,   # the JAX package's TPU training setting
)

"""whisper-medium [audio] — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="whisper", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=51865,
    encoder_layers=24, n_audio_frames=1500, d_frontend=1024, mlp="gelu",
    skip_shapes=("long_500k",),   # enc-dec decoder positions capped by design,
    microbatches=4,   # the JAX package's TPU training setting
)

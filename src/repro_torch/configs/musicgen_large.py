"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

Modality frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model); the backbone transformer and
the 2048-way codebook head are implemented fully.
Copy of repro.configs.musicgen_large."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    input_mode="embeddings",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, input_mode="embeddings",
)

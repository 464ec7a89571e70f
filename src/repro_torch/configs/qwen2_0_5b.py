"""Qwen2-0.5B — dense GQA, QKV bias, tied embeddings [arXiv:2407.10671].
Copy of repro.configs.qwen2_0_5b."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
    d_ff=96, vocab_size=512, qkv_bias=True, tie_embeddings=True,
)

"""Pixtral-12B — multimodal decoder backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

Vision frontend (Pixtral-ViT) is a STUB per the assignment: input_specs()
provides precomputed patch+text embeddings (B, S, d_model); the
mistral-nemo-style decoder backbone is implemented fully.
Copy of repro.configs.pixtral_12b."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    input_mode="embeddings",
    rope_theta=1_000_000_000.0,
)

SMOKE = ModelConfig(
    name="pixtral-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, input_mode="embeddings",
)

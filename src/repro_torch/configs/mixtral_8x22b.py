"""Mixtral-8x22B — 8-expert top-2 MoE with SWA [arXiv:2401.04088; hf].
Copy of repro.configs.mixtral_8x22b."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    n_experts=8, experts_per_token=2,
    sliding_window=4096,               # bounded KV cache -> long_500k ok
    long_context_ok=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    n_experts=4, experts_per_token=2, moe_group_size=64,
    sliding_window=32, long_context_ok=True,
)

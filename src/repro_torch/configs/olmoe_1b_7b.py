"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf].
Copy of repro.configs.olmoe_1b_7b."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    n_experts=64, experts_per_token=8,
    moe_group_size=512,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab_size=512,
    n_experts=8, experts_per_token=2, moe_group_size=64,
)

"""Zamba2-7B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified]. 81 blocks total: every 6th position is an
application of the single shared attention block (13 applications, 68
Mamba2 layers). Constant SSM state + 13 bounded attn caches -> long_500k.
Copy of repro.configs.zamba2_7b."""
from repro_torch.models.config import ModelConfig

_KINDS = tuple(("attn" if i % 6 == 5 else "mamba") for i in range(81))

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    block_kinds=_KINDS, shared_attn_every=6,
    long_context_ok=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    block_kinds=tuple(("attn" if i % 6 == 5 else "mamba") for i in range(7)),
    shared_attn_every=6, long_context_ok=True,
)

"""Gemma2-9B — local/global alternating attention, logit softcaps
[arXiv:2408.00118; hf].
Copy of repro.configs.gemma2_9b."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    local_global=True, sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    tie_embeddings=True, long_context_ok=True,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="gemma2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    local_global=True, sliding_window=32,
    attn_softcap=50.0, final_softcap=30.0, tie_embeddings=True,
    long_context_ok=True,
)

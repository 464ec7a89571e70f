"""LLaMA2-7B -- the paper's primary evaluation target (Tbl. 2/3)
[arXiv:2307.09288]. Copy of repro.configs.paper_llama2_7b."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=32000,
)

SMOKE = ModelConfig(
    name="paper-llama2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=192, vocab_size=512,
)

"""xLSTM-125M — alternating mLSTM / sLSTM blocks [arXiv:2405.04517;
unverified]. d_ff=0: no separate FFN (projections live inside blocks).
Constant-size recurrent state -> long_500k capable.
Copy of repro.configs.xlstm_125m."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_kinds=tuple(("mlstm" if i % 2 == 0 else "slstm")
                      for i in range(12)),
    long_context_ok=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab_size=256,
    block_kinds=("mlstm", "slstm"), long_context_ok=True,
)

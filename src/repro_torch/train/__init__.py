"""Training of the port (port of repro.train): AdamW with the
warmup-cosine schedule and global-norm clipping, gradient compression
with error feedback (single leaf), and the plain train step with
microbatch accumulation."""
from .compression import (  # noqa: F401
    CompressionConfig, compress_decompress, init_error_feedback,
)
from .optimizer import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm,
    warmup_cosine,
)
from .trainer import (  # noqa: F401
    cast_for_compute, make_train_state, make_train_step,
)

__all__ = [
    "AdamWConfig", "CompressionConfig", "adamw_init", "adamw_update",
    "cast_for_compute", "clip_by_global_norm", "compress_decompress",
    "global_norm", "init_error_feedback", "make_train_state",
    "make_train_step", "warmup_cosine",
]

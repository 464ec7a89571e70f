"""Training of the port (port of repro.train): AdamW with the
warmup-cosine schedule and global-norm clipping, gradient compression
with error feedback (a leaf, and the cross-pod ``compressed_psum``), the
plain train step with microbatch accumulation, the compressed cross-pod
step and the sharded step on a mesh, and the metrics through the
telemetry registry."""
from .compression import (  # noqa: F401
    CompressionConfig, compress_decompress, compressed_psum,
    init_error_feedback,
)
from .optimizer import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm,
    warmup_cosine,
)
from .trainer import (  # noqa: F401
    batch_sharding, cast_for_compute, make_sharded_train_step,
    make_train_state, make_train_step, publish_train_metrics,
    tp_loss_and_grads, train_state_shardings,
)

__all__ = [
    "AdamWConfig", "CompressionConfig", "adamw_init", "adamw_update",
    "batch_sharding", "cast_for_compute", "clip_by_global_norm",
    "compress_decompress", "compressed_psum", "global_norm",
    "init_error_feedback", "make_sharded_train_step", "make_train_state",
    "make_train_step", "publish_train_metrics", "tp_loss_and_grads",
    "train_state_shardings", "warmup_cosine",
]

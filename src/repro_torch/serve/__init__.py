"""Continuous-batching serving of packed weights: offline prequantization,
packed checkpoints, the slot scheduler, the batched engine and its guard
(poison sentinels, quarantine, deadlines, backpressure, retries)."""
from .engine import ServeEngine, ServeStats, tree_nbytes  # noqa: F401
from .guard import (  # noqa: F401
    DEGRADED, FAILED, HEALTHY, EngineFailedError, EngineGuard, GuardConfig,
    StreamIntegrityError, TransientStepError, verify_packed_tree,
)
from .prequant import (  # noqa: F401
    load_packed_checkpoint, packed_template, prequantize_checkpoint,
    prequantize_params, save_packed_checkpoint,
)
from .scheduler import (  # noqa: F401
    AdmissionError, Request, SlotScheduler,
)

__all__ = [
    "AdmissionError", "DEGRADED", "EngineFailedError", "EngineGuard",
    "FAILED", "GuardConfig", "HEALTHY", "Request", "ServeEngine",
    "ServeStats", "SlotScheduler", "StreamIntegrityError",
    "TransientStepError", "load_packed_checkpoint", "packed_template",
    "prequantize_checkpoint", "prequantize_params", "save_packed_checkpoint",
    "tree_nbytes", "verify_packed_tree",
]

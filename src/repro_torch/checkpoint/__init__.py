from .checkpoint import (  # noqa: F401
    CheckpointCorruptError, all_steps, latest_step, leaf_crc32,
    read_manifest, restore_state, save_state,
)

__all__ = [
    "CheckpointCorruptError", "all_steps", "latest_step", "leaf_crc32",
    "read_manifest", "restore_state", "save_state",
]

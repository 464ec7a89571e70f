"""Deterministic fault injection for the serving stack (port of
repro.testing): the harness behind tests/test_torch_faults.py and
chip_smoke.py's ``guard`` phase; and seeded values for the attention
leaves that initialisation leaves constant (``weights.py``); and a train
step on the card held against the CPU (``train.py``), and the recurrent
blocks' checks on the card (``recurrent.py``), each imported by its
callers."""
from .faults import (  # noqa: F401
    FaultInjector, FaultPlan, chaos_plan, corrupt_checkpoint_leaf,
    poison_kv_nan, poison_kv_scale, truncate_checkpoint,
)
from .weights import attention_extras, fill_attention_extras  # noqa: F401

__all__ = [
    "FaultInjector", "FaultPlan", "chaos_plan", "corrupt_checkpoint_leaf",
    "poison_kv_nan", "poison_kv_scale", "truncate_checkpoint",
    "attention_extras", "fill_attention_extras",
]

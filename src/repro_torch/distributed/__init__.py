"""Single-host parts of repro.distributed: straggler detection and the
preemption guard. Meshes, shardings and the pipeline schedule are not
ported (ROADMAP A11)."""
from .straggler import PreemptionGuard, StragglerMonitor  # noqa: F401

__all__ = ["PreemptionGuard", "StragglerMonitor"]

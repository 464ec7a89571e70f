"""Distribution in the port (port of repro.distributed): logical-axis
sharding over a mesh (``sharding``), the GPipe pipeline (``pipeline``),
straggler detection and the preemption guard (``straggler``)."""
from .straggler import PreemptionGuard, StragglerMonitor  # noqa: F401

__all__ = ["PreemptionGuard", "StragglerMonitor"]

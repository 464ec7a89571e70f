"""Telemetry of the port (port of repro.obs): a metrics registry with
Prometheus text exposition and a JSONL sink, a Chrome-trace span tracer,
and quantization-health probes. Everything is gated by ``REPRO_OBS`` (read
through ``repro_torch.core.envflags``): with it unset, every
instrumentation site is one flag check, the serve path launches the
kernels it launches without telemetry and its tokens are bit-identical
(tests/test_torch_obs.py)."""
from .registry import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    PILLARS, counter, enabled, gauge, histogram, obs_dir, pillars, registry,
)
from .tracing import (  # noqa: F401
    SpanTracer, export_chrome_trace, instant, span, tracer,
)
from . import quant_health  # noqa: F401

__all__ = [
    "enabled", "obs_dir", "registry", "counter", "gauge", "histogram",
    "tracer", "span", "instant", "export_chrome_trace", "quant_health",
    "dump", "autodump", "reset",
]


def dump(directory: str) -> dict:
    """Write a metric snapshot (append) and the full trace buffer into
    ``directory`` as ``metrics.jsonl`` + ``trace.json``, after recording
    the probes still pending outside an engine. Returns the paths."""
    import os
    os.makedirs(directory, exist_ok=True)
    metrics = os.path.join(directory, "metrics.jsonl")
    trace = os.path.join(directory, "trace.json")
    quant_health.flush()
    registry().dump_jsonl(metrics)
    export_chrome_trace(trace)
    return {"metrics": metrics, "trace": trace}


def autodump() -> dict:
    """``dump`` into ``REPRO_OBS_DIR`` if set and any pillar is enabled;
    components call this when a unit of work drains (the engine's ``run``,
    the training example)."""
    d = obs_dir()
    if d and any(enabled(p) for p in PILLARS):
        return dump(d)
    return {}


def reset() -> None:
    """Clear registry, tracer and pending probes (test isolation)."""
    registry().reset()
    tracer().reset()
    quant_health._DEFAULT.take()

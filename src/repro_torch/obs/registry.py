"""Metrics registry: counters, gauges and fixed-bucket histograms with
labels, Prometheus-style text exposition, and a JSONL sink (port of
repro.obs.registry: the same calls give the same text and records).

Dependency-free and thread-safe. Instrumentation across the repo is gated
by the ``REPRO_OBS`` environment variable (see :func:`enabled`); the
registry itself always works when called directly — the gating lives at
the instrumentation call sites so that with ``REPRO_OBS`` unset the hot
paths execute exactly the pre-instrumentation code (the tier-1
bit-identity test pins this for the serving engine).

``REPRO_OBS`` modes:
  unset / "" / "0"          everything off (the default; near-zero overhead)
  "1"                       every pillar on: metrics + trace + health
  "metrics,trace"           comma list of pillars to enable selectively
                            (pillars: ``metrics``, ``trace``, ``health``)

``REPRO_OBS_DIR``: when set, components that finish a unit of work (the
serving engine's ``run``, the training example) drop ``metrics.jsonl`` +
``trace.json`` snapshots there (see ``repro_torch.obs.autodump``).
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.core import envflags

__all__ = [
    "PILLARS", "enabled", "pillars", "obs_dir", "Counter", "Gauge",
    "Histogram", "MetricsRegistry", "registry", "counter", "gauge", "histogram",
    "DEFAULT_LATENCY_BUCKETS",
]

PILLARS = ("metrics", "trace", "health")

# Prometheus-style latency buckets (seconds); +Inf is implicit.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_MODE_CACHE: Dict[str, frozenset] = {}


def _modes(raw: str) -> frozenset:
    got = _MODE_CACHE.get(raw)
    if got is None:
        if raw == "1":
            got = frozenset(PILLARS)
        else:
            got = frozenset(
                m.strip() for m in raw.split(",") if m.strip())
            unknown = got - frozenset(PILLARS)
            if unknown:
                raise ValueError(
                    f"REPRO_OBS={raw!r}: unknown pillar(s) "
                    f"{sorted(unknown)}; valid: {PILLARS} or '1'")
        _MODE_CACHE[raw] = got
    return got


def enabled(pillar: str = "metrics") -> bool:
    """True when observability pillar ``pillar`` is on (env-driven, cheap
    enough to call on hot paths — one dict lookup when off)."""
    raw = envflags.get_raw("REPRO_OBS") or ""
    if raw in ("", "0"):
        return False
    return pillar in _modes(raw)


def pillars() -> frozenset:
    """The enabled pillars: empty with ``REPRO_OBS`` off (one read of the
    variable, for a site that serves several pillars)."""
    raw = envflags.get_raw("REPRO_OBS") or ""
    if raw in ("", "0"):
        return frozenset()
    return _modes(raw)


def obs_dir() -> Optional[str]:
    """Directory for metric/trace snapshots (``REPRO_OBS_DIR``), or None."""
    return envflags.get_str("REPRO_OBS_DIR") or None


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """Base: one named metric holding samples keyed by label tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._samples: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def samples(self):
        with self._lock:
            return dict(self._samples)


class Counter(_Metric):
    """Monotonically increasing float, per label set."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._samples.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins float, per label set."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[_label_key(labels)] = float(value)

    def add(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        return float(self._samples.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (Prometheus semantics: each
    bucket counts observations <= its upper bound; +Inf is implicit)."""

    kind = "histogram"

    def __init__(self, name, help, lock,
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {self.name}: needs >= 1 bucket")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            s = self._samples.get(key)
            if s is None:
                s = {"counts": [0] * (len(self.buckets) + 1),
                     "sum": 0.0, "count": 0}
                self._samples[key] = s
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            s["counts"][i] += 1
            s["sum"] += v
            s["count"] += 1

    def snapshot(self, **labels) -> dict:
        """Cumulative bucket counts {le: n} plus sum/count."""
        s = self._samples.get(_label_key(labels))
        if s is None:
            return {"buckets": {}, "sum": 0.0, "count": 0}
        return _hist_cumulative(self.buckets, s)


def _hist_cumulative(buckets, s) -> dict:
    out, acc = {}, 0
    for b, c in zip(buckets, s["counts"]):
        acc += c
        out[repr(float(b))] = acc
    out["+Inf"] = acc + s["counts"][-1]
    return {"buckets": out, "sum": s["sum"], "count": s["count"]}


class MetricsRegistry:
    """Get-or-create registry of named metrics."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self):
        with self._lock:
            return dict(self._metrics)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exposition --------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines = []
        for name in sorted(self.metrics()):
            m = self._metrics[name]
            samples = m.samples()
            if not samples:
                continue
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key in sorted(samples):
                s = samples[key]
                if m.kind == "histogram":
                    cum = _hist_cumulative(m.buckets, s)
                    for le, n in cum["buckets"].items():
                        le_txt = le if le == "+Inf" else _fmt_float(le)
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(key, f'le={chr(34)}{le_txt}{chr(34)}')}"
                            f" {n}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} {cum['sum']}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {cum['count']}")
                else:
                    lines.append(f"{name}{_fmt_labels(key)} {s}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> list:
        """One JSON-able record per (metric, label set)."""
        now = time.time()
        out = []
        for name in sorted(self.metrics()):
            m = self._metrics[name]
            for key, s in sorted(m.samples().items()):
                rec = {"ts": now, "name": name, "type": m.kind,
                       "labels": dict(key)}
                if m.kind == "histogram":
                    rec.update(_hist_cumulative(m.buckets, s))
                else:
                    rec["value"] = s
                out.append(rec)
        return out

    def dump_jsonl(self, path: str, append: bool = True) -> int:
        """Append (default) one snapshot of every metric to ``path`` as
        JSON lines. Returns the number of records written."""
        recs = self.snapshot()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a" if append else "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
        return len(recs)


def _fmt_float(s: str) -> str:
    v = float(s)
    return str(int(v)) if math.isfinite(v) and v == int(v) else str(v)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every instrumentation site uses."""
    return _REGISTRY


def counter(name: str, help: str = "") -> Counter:
    return _REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, help, buckets)

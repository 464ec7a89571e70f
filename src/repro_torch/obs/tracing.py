"""Span tracer exporting Chrome-trace-format JSON (port of
repro.obs.tracing: the same event schema).

``span(...)`` is a context manager over monotonic clocks
(``time.perf_counter_ns``); completed spans become ``ph: "X"`` events that
``chrome://tracing`` and Perfetto (https://ui.perfetto.dev) render as a
nested timeline per thread -- nesting falls out of wall-clock containment
on the same tid, so ``serve.step`` > ``serve.phase.decode`` >
``serve.kernel.dispatch`` stack visually without parent bookkeeping.

Gated by the ``trace`` pillar of ``REPRO_OBS`` (registry.enabled): when
off, ``span`` returns one shared no-op context, reads no clock and records
nothing (and no span touches the device: a span over a launch times the
host, which waits for the device only where the code inside it does).
Thread-safe: events append under a lock; tids are real thread idents so
concurrent engine and trainer threads land on separate tracks.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import List

from .registry import enabled

__all__ = ["SpanTracer", "tracer", "span", "instant", "export_chrome_trace"]

_OFF = contextlib.nullcontext()         # what a span is with tracing off


class SpanTracer:
    """Accumulates Chrome trace events (X = complete span, i = instant)."""

    def __init__(self, process_name: str = "repro"):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._pid = os.getpid()
        self.process_name = process_name

    def span(self, name: str, cat: str = "repro", **args):
        """Context manager timing one span. ``args`` (str/num values) show
        in the trace viewer's argument pane. A shared no-op context when
        the ``trace`` pillar is off at the call."""
        if not enabled("trace"):
            return _OFF
        return self._span(name, cat, args)

    @contextlib.contextmanager
    def _span(self, name: str, cat: str, args: dict):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                  "pid": self._pid, "tid": threading.get_ident()}
            if args:
                ev["args"] = dict(args)
            with self._lock:
                self._events.append(ev)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """Zero-duration marker (admissions, evictions, quarantines)."""
        if not enabled("trace"):
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": time.perf_counter_ns() / 1e3,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()

    def export(self, path: str) -> int:
        """Write the full buffer as a Chrome trace JSON object. Returns the
        number of events written. The file loads directly in
        chrome://tracing or Perfetto."""
        evs = self.events()
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": self.process_name}}]
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + evs,
                       "displayTimeUnit": "ms"}, f)
        return len(evs)


_TRACER = SpanTracer()


def tracer() -> SpanTracer:
    """The process-global tracer."""
    return _TRACER


def span(name: str, cat: str = "repro", **args):
    return _TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "repro", **args) -> None:
    _TRACER.instant(name, cat, **args)


def export_chrome_trace(path: str) -> int:
    return _TRACER.export(path)

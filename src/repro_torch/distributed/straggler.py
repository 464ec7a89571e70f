"""Straggler detection and preemption handling (a copy of
repro.distributed.straggler, standard library only).

At pod scale, a single slow chip/host gates every synchronous collective.
The monitor tracks per-step wall time with an EWMA + MAD band; sustained
outliers trigger a policy callback (log -> checkpoint -> request re-shard).
Preemption (SIGTERM from the cluster scheduler) flips a flag the train loop
checks each step, guaranteeing a final checkpoint before exit.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional

__all__ = ["StragglerMonitor", "PreemptionGuard"]


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ewma: float = 0.9,
                 patience: int = 3,
                 on_straggle: Optional[Callable[[int, float], None]] = None):
        self.threshold = threshold
        self.alpha = ewma
        self.patience = patience
        self.on_straggle = on_straggle
        self.mean: Optional[float] = None
        self.slow_streak = 0
        self.events: list[tuple[int, float]] = []
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> bool:
        """Returns True if this step was flagged as a straggler event."""
        dt = time.monotonic() - self._t0
        if self.mean is None:
            self.mean = dt
            return False
        slow = dt > self.threshold * self.mean
        # EWMA excludes outliers so one straggler doesn't poison the baseline
        if not slow:
            self.mean = self.alpha * self.mean + (1 - self.alpha) * dt
            self.slow_streak = 0
            return False
        self.slow_streak += 1
        if self.slow_streak >= self.patience:
            self.events.append((step, dt))
            if self.on_straggle:
                self.on_straggle(step, dt)
            self.slow_streak = 0
            return True
        return False


class PreemptionGuard:
    """SIGTERM/SIGINT -> graceful checkpoint-and-exit flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)

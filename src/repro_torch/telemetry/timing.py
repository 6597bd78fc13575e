"""Wall-clock timing scopes (counterpart of ``repro/telemetry/timing.py``).

``Timings`` accumulates named scope durations (seconds + call counts)
with a context manager; ``summary()`` is what trackers receive via
``log_timings``. Scopes are host wall-clock around issued work: a round
block on the card is one scope ("round_block"), whose end waits for the
device only when a tracker records it; data staging is the "stage" scope.
"""
from __future__ import annotations

import time
from contextlib import contextmanager


class Timings:
    """Accumulates named wall-clock scope durations."""

    def __init__(self):
        self._seconds: dict = {}
        self._counts: dict = {}

    @contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._seconds[name] = self._seconds.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        """Record a duration measured externally."""
        self._seconds[name] = self._seconds.get(name, 0.0) + float(seconds)
        self._counts[name] = self._counts.get(name, 0) + 1

    def summary(self) -> dict:
        """{scope: {"seconds": total, "count": calls}} — the
        ``log_timings`` payload."""
        return {
            name: {"seconds": round(self._seconds[name], 6),
                   "count": self._counts[name]}
            for name in self._seconds
        }

"""Wall-clock timing scopes and the span log (counterpart of
``repro/telemetry/timing.py``, which has the scopes alone).

``Timings`` accumulates named scope durations (seconds + call counts)
with a context manager; ``summary()`` is what trackers receive via
``log_timings``. Scopes are host wall-clock around issued work: a round
block on the card is one scope ("round_block"), whose end waits for the
device only when a tracker records it; data staging is the "stage" scope.

``span(name, **attrs)`` records one host interval in the process-wide
span log: its name, start and end on ``time.perf_counter_ns()``, the
index of the span that encloses it in the same thread (its parent) and
small scalar attributes. Every ``Timings`` scope is also a span. The log
keeps the last ``SPAN_LOG_SIZE`` records; ``spans()`` reads it,
``clear_spans()`` empties it. A span never touches the device and never
synchronises. While a torch profiler records, a span's body also runs
inside ``torch.profiler.record_function(name)``, so that it sits among
the profiler's host events, on the device trace's clock.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

SPAN_LOG_SIZE = 65_536


class Span(NamedTuple):
    """One finished span: ``index`` numbers spans in the order they began,
    ``parent`` is the enclosing span's index (None at the top)."""
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    attrs: dict


_log: collections.deque = collections.deque(maxlen=SPAN_LOG_SIZE)
_indices = itertools.count()
_open = threading.local()  # each thread's stack of open span indices


class _Scope:
    __slots__ = ("name", "attrs", "index", "parent", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.index = next(_indices)
        stack.append(self.index)
        # the module flag PyTorch keeps for fast checks: on while a profiler records
        self._range = torch.profiler.record_function(self.name) \
            if _profiler._is_profiler_enabled else None
        if self._range is not None:
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _open.stack.pop()
        _log.append(Span(self.index, self.name, self.start_ns, self.end_ns, self.parent,
                         self.attrs))
        return False


def span(name: str, **attrs) -> _Scope:
    """A context manager that records the interval of its body as one
    span named ``name`` with the scalar attributes ``attrs``."""
    return _Scope(name, attrs)


def spans() -> list:
    """The log's spans (``Span``), in the order they began."""
    return sorted(_log, key=lambda s: s.index)


def clear_spans() -> None:
    _log.clear()


class Timings:
    """Accumulates named wall-clock scope durations."""

    def __init__(self):
        self._seconds: dict = {}
        self._counts: dict = {}

    @contextmanager
    def scope(self, name: str):
        """Times its body as the span ``name``, on the span's clock."""
        interval = span(name)
        try:
            with interval:
                yield
        finally:
            dt = (interval.end_ns - interval.start_ns) / 1e9
            self._seconds[name] = self._seconds.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def summary(self) -> dict:
        """{scope: {"seconds": total, "count": calls}} — the
        ``log_timings`` payload."""
        return {
            name: {"seconds": round(self._seconds[name], 6),
                   "count": self._counts[name]}
            for name in self._seconds
        }

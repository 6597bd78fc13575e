"""The program's span log (``repro_torch.telemetry.timing.spans()``), read
in the run's own process after the window, and the parts of it that the
per-layer metrics read: the window's train steps and round blocks, a
phase's durations, a span's time less its nested spans'.

The window is the unprofiled steady state after set-up's checked steps
or rounds (``SET_UP``): train steps ``SET_UP`` to ``SET_UP + window
steps - 1``; round blocks whose first round (the ``first`` attribute,
the accountant's round count at the block's start) lies in ``[SET_UP +
block, SET_UP + block + window rounds)``, after set-up's block at the
window's size. Every function returns None where there is nothing to
read: a program that keeps no span log, or no such span."""
from __future__ import annotations

import statistics

SET_UP = 3  # steps, or rounds before set-up's block, that set-up checks


def records(log=None):
    """``log`` where given (a test's), else the program's span log; None
    for a program without one."""
    if log is not None:
        return list(log)
    try:
        from repro_torch.telemetry import timing
    except ImportError:
        return None
    spans = getattr(timing, "spans", None)
    return None if spans is None else spans()


def seconds(span) -> float:
    return (span.end_ns - span.start_ns) / 1e9


def window_steps(run: dict, log) -> list:
    """The window's ``train_step`` spans."""
    steps = run.get("window", {}).get("steps")
    if log is None or not steps:
        return []
    return [s for s in log if s.name == "train_step"
            and SET_UP <= s.attrs.get("step", -1) < SET_UP + steps]


def step_phase_ms(run: dict, name: str, log=None):
    """The median host milliseconds of the phase ``name`` (a child of
    ``train_step``) over the window's steps."""
    log = records(log)
    steps = {s.index for s in window_steps(run, log)}
    took = [seconds(s) for s in log or () if s.name == name and s.parent in steps]
    return 1e3 * statistics.median(took) if took else None


def window_blocks(run: dict, name: str, log) -> list:
    """The window's round-block spans named ``name`` (one a block)."""
    rounds, block = run.get("window", {}).get("rounds"), run.get("traffic", {}).get("block")
    if log is None or not rounds or not block:
        return []
    lo = SET_UP + block
    return [s for s in log if s.name == name and lo <= s.attrs.get("first", -1) < lo + rounds]


def last(name: str, log=None):
    """The latest span named ``name`` (a run builds one trainer)."""
    found = [s for s in records(log) or () if s.name == name]
    return found[-1] if found else None


def self_seconds(span, log, nested: str) -> float:
    """``span``'s seconds less those of the spans named ``nested`` directly
    under it."""
    return seconds(span) - sum(seconds(s) for s in log
                               if s.name == nested and s.parent == span.index)

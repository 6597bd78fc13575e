"""Seeded client-arrival processes and the async dispatch model
(counterpart of ``repro/fed/arrivals.py``; pure numpy, the port's own
copy, so a ``(spec, seed)`` pair gives the reference's trace exactly).

The traffic shape of the async engine: clients *arrive* under a seeded
point process, compute for a latency, and their updates land in a buffer
that the server drains on a cadence. Two registered processes:

- ``poisson``: homogeneous Poisson arrivals at ``rate`` clients per unit
  time (exponential inter-arrival gaps);
- ``diurnal``: an inhomogeneous Poisson process of intensity
  ``rate * (1 + amplitude * sin(2*pi*t/period))``, sampled by
  Lewis-Shedler thinning against the homogeneous envelope.

Everything draws from one numpy ``Generator``, apart from the round
stream (the trainer's ``torch.Generator``) that draws cohorts and seeds.

``ArrivalSimulator`` turns a trace into per-aggregation
``BufferSchedule``s under the dispatch model the engine executes:

- buffer ``b`` collects arrivals ``[b*cadence, (b+1)*cadence)`` in
  arrival order;
- aggregation ``b`` happens at ``T_b = max(T_{b-1}, max delivery time
  in the buffer)``: aggregation times are monotone;
- a member who arrived at ``a_i`` computed against the newest version
  published before ``a_i``: raw staleness
  ``b - searchsorted(T[:b], a_i, side="right")``;
- the bounded-staleness fetch protocol clamps realized staleness to
  ``min(raw, max_staleness, b)`` (a client that would be staler refetches);
- a member whose compute latency exceeds ``timeout`` is a straggler: it
  keeps its buffer slot with weight 0, and the aggregation is accounted
  at the realized surviving count.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import ClassVar, Optional

import numpy as np

_ARRIVALS: dict = {}

# arrivals are sampled in bounded chunks so memory stays O(chunk), not
# O(total arrivals) — the engine consumes them buffer by buffer anyway.
_CHUNK = 16384


def register_arrivals(cls):
    name = cls.name
    if name in _ARRIVALS:
        raise ValueError(f"arrival process {name!r} already registered")
    _ARRIVALS[name] = cls
    return cls


def arrival_names() -> tuple:
    return tuple(_ARRIVALS)


def get_arrivals(name: str):
    try:
        return _ARRIVALS[name]
    except KeyError:
        raise ValueError(
            f"unknown arrival process {name!r}; registered: "
            f"{', '.join(_ARRIVALS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base: a seeded stream of client arrival times (unit-time axis)."""

    name: ClassVar[str] = "base"
    rate: float = 1.0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {self.rate}")

    def intensity(self, t):
        """Instantaneous arrival intensity lambda(t) (vectorized)."""
        raise NotImplementedError

    def envelope(self) -> float:
        """An upper bound on ``intensity`` (thinning envelope)."""
        return self.rate

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """The first ``n`` arrival times of the trace ``rng`` encodes,
        by Lewis-Shedler thinning against the homogeneous envelope.
        Deterministic in (self, rng state); memory is O(chunk)."""
        lam = float(self.envelope())
        out = np.empty(n, dtype=np.float64)
        filled = 0
        t = 0.0
        while filled < n:
            gaps = rng.exponential(1.0 / lam, size=_CHUNK)
            times = t + np.cumsum(gaps)
            keep = rng.random(_CHUNK) * lam < self.intensity(times)
            kept = times[keep]
            take = min(n - filled, kept.shape[0])
            out[filled:filled + take] = kept[:take]
            filled += take
            t = float(times[-1])
        return out


@register_arrivals
@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate`` clients / unit time."""

    name: ClassVar[str] = "poisson"

    def intensity(self, t):
        return np.full_like(np.asarray(t, dtype=np.float64), self.rate)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        # the thinning loop degenerates to pure exponential gaps here;
        # sample them directly (identical distribution, fewer draws).
        gaps = rng.exponential(1.0 / self.rate, size=n)
        return np.cumsum(gaps)


@register_arrivals
@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Inhomogeneous Poisson with a day/night sinusoidal intensity."""

    name: ClassVar[str] = "diurnal"
    period: float = 24.0
    amplitude: float = 0.8

    def __post_init__(self):
        super().__post_init__()
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(
                f"diurnal amplitude must be in [0, 1), got {self.amplitude}"
            )
        if self.period <= 0:
            raise ValueError(
                f"diurnal period must be > 0, got {self.period}"
            )

    def intensity(self, t):
        t = np.asarray(t, dtype=np.float64)
        return self.rate * (
            1.0 + self.amplitude * np.sin(2.0 * np.pi * t / self.period)
        )

    def envelope(self) -> float:
        return self.rate * (1.0 + self.amplitude)


def parse_arrivals_spec(spec: str) -> tuple:
    """Split ``"name:k=v,k=v"`` into ``(name, options)`` — the same spec
    grammar as ``core.mechanisms.parse_mechanism_spec``."""
    name, _, rest = str(spec).partition(":")
    name = name.strip()
    if not name:
        raise ValueError(f"empty arrival process name in spec {spec!r}")
    opts = {}
    if rest.strip():
        for item in rest.split(","):
            k, sep, v = item.partition("=")
            k = k.strip()
            if not sep or not k:
                raise ValueError(
                    f"malformed arrival option {item!r} in spec {spec!r} "
                    f"(expected key=value)"
                )
            opts[k] = _coerce(v.strip())
    return name, opts


def _coerce(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def make_arrivals(spec: str, **defaults) -> ArrivalProcess:
    """Build a registered arrival process from a spec string. Explicit
    spec options are validated against the process's constructor
    signature and override ``defaults``."""
    name, opts = parse_arrivals_spec(spec)
    cls = get_arrivals(name)
    fields = {f.name for f in dataclasses.fields(cls)}
    params = set(inspect.signature(cls.__init__).parameters) | fields
    unknown = set(opts) - params
    if unknown:
        raise ValueError(
            f"unknown option(s) {sorted(unknown)} for arrival process "
            f"{name!r}; accepted: {sorted(fields)}"
        )
    merged = {k: v for k, v in defaults.items() if k in fields}
    merged.update(opts)
    return cls(**merged)


@dataclasses.dataclass(frozen=True)
class BufferSchedule:
    """One aggregation's realized traffic, under the dispatch model."""

    index: int                 # aggregation number b
    time: float                # T_b (monotone)
    arrivals: np.ndarray       # (cadence,) arrival times, sorted
    staleness: np.ndarray      # (cadence,) realized int32 staleness
    delivered: np.ndarray      # (cadence,) bool: beat the timeout
    raw_staleness: np.ndarray  # (cadence,) pre-clamp staleness

    @property
    def realized(self) -> int:
        return int(self.delivered.sum())


class ArrivalSimulator:
    """Replays an arrival trace into per-aggregation buffer schedules.

    Traffic (arrival trace, latencies, delivery order) is generated
    host-side from one numpy stream seeded by ``(seed, 0xA5C)``, apart
    from the round stream that draws cohorts and kernel seeds. Buffers are produced
    lazily chunk by chunk: memory is O(cadence + chunk), independent of
    how many aggregations the run executes or the population size.
    """

    def __init__(self, process: ArrivalProcess, cadence: int, *,
                 seed: int, max_staleness: int = 0,
                 mean_latency: float = 1.0,
                 timeout: Optional[float] = None):
        if cadence <= 0:
            raise ValueError(f"cadence must be > 0, got {cadence}")
        if max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {max_staleness}"
            )
        if mean_latency < 0:
            raise ValueError(
                f"mean_latency must be >= 0, got {mean_latency}"
            )
        if timeout is not None and timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.process = process
        self.cadence = int(cadence)
        self.max_staleness = int(max_staleness)
        self.mean_latency = float(mean_latency)
        self.timeout = timeout
        self._rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & 0xFFFFFFFF, 0xA5C])
        )
        self._agg_times: list = []     # T_0..T_{b-1}, monotone
        self._next_index = 0

    def next_buffer(self) -> BufferSchedule:
        """The next aggregation's schedule (advances the trace)."""
        b = self._next_index
        arrivals = np.sort(self.process.sample(self._rng, self.cadence))
        latency = (np.zeros(self.cadence)
                   if self.mean_latency == 0.0
                   else self._rng.exponential(self.mean_latency,
                                              size=self.cadence))
        delivery = arrivals + latency

        # Raw staleness: versions published since each member fetched.
        past = np.asarray(self._agg_times, dtype=np.float64)
        fetched_version = np.searchsorted(past, arrivals, side="right")
        raw = (b - fetched_version).astype(np.int32)

        # Bounded-staleness fetch protocol: a client never computes
        # against parameters older than max_staleness versions.
        stale = np.minimum(raw, min(self.max_staleness, b)).astype(np.int32)

        delivered = (np.ones(self.cadence, dtype=bool)
                     if self.timeout is None
                     else latency <= self.timeout)

        t_b = float(delivery.max())
        if self._agg_times:
            t_b = max(t_b, self._agg_times[-1])
        self._agg_times.append(t_b)
        self._next_index += 1
        return BufferSchedule(
            index=b, time=t_b, arrivals=arrivals, staleness=stale,
            delivered=delivered, raw_staleness=raw,
        )

    def stats(self) -> dict:
        """Summary of the trace so far (for telemetry extras)."""
        return {
            "aggregations": self._next_index,
            "sim_time": self._agg_times[-1] if self._agg_times else 0.0,
        }

"""The tracker registry (counterpart of ``repro/telemetry/tracker.py``,
its own copy: the port imports nothing of ``repro``): ``@register_tracker``
and the ``Tracker`` base.

A tracker is a registered sink for the metrics every federated run
emits: run metadata, one schema-stable record per round (emitted at the
decode-apply boundary by ``FedTrainer``), eval points and wall-clock
timing scopes. The schema (``ROUND_FIELDS``, ``CSV_COLUMNS``,
``SCHEMA_VERSION``) and the documents are the reference's byte for byte,
so runs of either package can be diffed.

Backends:

  * ``noop``      — the default; swallows everything.
  * ``json``      — one JSON document per run (the ``BENCH_*.json``
    format; atomic tmp + rename writes).
  * ``csv``       — one streamed CSV row per event.
  * ``composite`` — fans every event out to child trackers.

Construction: a registered name, a ``"name:k=v,..."`` spec string
(``"json:runs/a.json"`` is sugar for ``"json:path=runs/a.json"``), a
``+``-joined composite spec (``"json:a.json+csv:a.csv"``), a list of
specs, a Tracker instance (passthrough), or ``None`` (noop).
"""
from __future__ import annotations

import csv as csv_lib
import inspect
import json
import os
import tempfile
from typing import Callable, ClassVar, Dict, Optional, Type, Union

# One record per round, emitted by the single decode-apply-boundary hook
# (telemetry/emit.py). The field ORDER is the CSV column order and the
# JSON key order — schema-stable, the reference's.
ROUND_FIELDS = (
    "round", "engine", "mechanism", "realized_n", "eps_spent",
    "eps_remaining", "rounds_per_sec", "secagg_sum_bits", "wire_bits",
    "pack_width", "loss", "accuracy",
)
# CSV rows are typed by a leading ``kind`` column (meta | round | eval |
# timings | snapshot); fields inapplicable to a kind stay blank and
# anything outside the canonical schema rides the trailing ``extra``
# column as compact JSON. One header serves every event type.
CSV_COLUMNS = ("kind",) + ROUND_FIELDS + ("extra",)
SCHEMA_VERSION = 1

_REGISTRY: Dict[str, Type["Tracker"]] = {}


def register_tracker(name: str) -> Callable[[type], type]:
    """Class decorator: register a Tracker subclass under ``name``."""

    def deco(cls: type) -> type:
        if not (isinstance(cls, type) and issubclass(cls, Tracker)):
            raise TypeError(f"{cls!r} must subclass Tracker")
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(
                f"tracker {name!r} already registered to {existing}"
            )
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def tracker_names() -> tuple:
    """Registered tracker names (stable registration order)."""
    return tuple(_REGISTRY)


def get_tracker(name: str) -> Type["Tracker"]:
    """Look up a registered tracker class by name."""
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown tracker {name!r}; registered: {', '.join(_REGISTRY)}"
        )
    return cls


class Tracker:
    """One sink for a run's metrics stream.

    Every method is optional to override; the base implementation drops
    the event. Event order within a run: ``run_started`` once, then any
    interleaving of ``log_round`` / ``log_eval`` / ``log_timings`` /
    ``log_snapshot`` / ``log_payload``, then ``close``. ``on_resume(r)``
    may arrive right after construction when a checkpointed run restarts:
    the backend must drop any state it holds for rounds > r so the
    continued series has no duplicate or missing round indices.
    """

    name: ClassVar[str] = "?"

    def run_started(self, meta: dict) -> None:
        """Run-level metadata: config fingerprint, engine, mechanism
        spec, mesh geometry, backend."""

    def log_round(self, rec: dict) -> None:
        """One per-round record (ROUND_FIELDS keys + free extras)."""

    def log_eval(self, rec: dict) -> None:
        """One evaluation point ({round, loss, accuracy, ...})."""

    def log_timings(self, scopes: dict) -> None:
        """Wall-clock timing scope totals (telemetry/timing.py summary)."""

    def log_snapshot(self, snap: dict) -> None:
        """A service health/status snapshot (the reference's aggregator;
        not ported yet)."""

    def log_payload(self, key: str, obj) -> None:
        """A free-form named payload (benchmark result tables)."""

    def on_resume(self, round_: int) -> None:
        """A checkpoint restore landed at ``round_``: forget rounds > r."""

    def flush(self) -> None:
        """Make everything emitted so far durable."""

    def close(self) -> None:
        """Final flush; the tracker will not be used again."""

    @classmethod
    def from_options(cls, **options) -> "Tracker":
        return cls(**options)


@register_tracker("noop")
class NoopTracker(Tracker):
    """Swallows every event — the default when no ``--track`` is given."""


def _empty_doc() -> dict:
    return {"schema": SCHEMA_VERSION, "meta": {}, "rounds": [], "evals": [],
            "timings": {}, "snapshots": [], "payloads": {}}


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _round_row(rec: dict) -> dict:
    """Normalize a record to the canonical schema: ROUND_FIELDS in order,
    missing ones None, everything else folded into ``extra``."""
    rec = dict(rec)
    row = {k: rec.pop(k, None) for k in ROUND_FIELDS}
    extra = {**(rec.pop("extra", None) or {}), **rec}
    if extra:
        row["extra"] = extra
    return row


@register_tracker("json")
class JsonTracker(Tracker):
    """One JSON document per run — the ``BENCH_*.json`` artifact format.

    The document is held in memory and written atomically on every
    ``flush``/``close`` (tmp + rename, like checkpoint/store.py). With
    ``append=True`` an existing document at ``path`` is loaded first, so
    a resumed run continues the same round series; ``on_resume(r)`` then
    drops any rounds/evals past the restored round (a crash can land
    after an emit but before its checkpoint).
    """

    def __init__(self, path: str, append: bool = False, indent: int = 2):
        if not path:
            raise ValueError("json tracker needs a path")
        self.path = str(path)
        self.indent = int(indent)
        self.doc = _empty_doc()
        if append and os.path.exists(self.path):
            with open(self.path) as f:
                prev = json.load(f)
            for k, v in self.doc.items():
                self.doc[k] = prev.get(k, v)

    def run_started(self, meta: dict) -> None:
        self.doc["meta"].update(meta)

    def log_round(self, rec: dict) -> None:
        self.doc["rounds"].append(_round_row(rec))

    def log_eval(self, rec: dict) -> None:
        self.doc["evals"].append(dict(rec))

    def log_timings(self, scopes: dict) -> None:
        self.doc["timings"] = dict(scopes)

    def log_snapshot(self, snap: dict) -> None:
        self.doc["snapshots"].append(dict(snap))

    def log_payload(self, key: str, obj) -> None:
        self.doc["payloads"][key] = obj

    def on_resume(self, round_: int) -> None:
        self.doc["rounds"] = [
            r for r in self.doc["rounds"] if r.get("round", 0) <= round_
        ]
        self.doc["evals"] = [
            e for e in self.doc["evals"] if e.get("round", 0) <= round_
        ]

    def flush(self) -> None:
        _atomic_write(self.path, json.dumps(self.doc, indent=self.indent))

    def close(self) -> None:
        self.flush()


@register_tracker("csv")
class CsvTracker(Tracker):
    """One streamed CSV row per event, flushed as it happens.

    Header is ``CSV_COLUMNS`` (pinned by the golden-schema test); the
    ``kind`` column types each row and non-tabular payloads (meta,
    timings, snapshots) ride the ``extra`` column as compact JSON.
    ``on_resume(r)`` rewrites the file keeping only rounds <= r, so a
    resumed series never duplicates a round index.
    """

    def __init__(self, path: str, append: bool = False):
        if not path:
            raise ValueError("csv tracker needs a path")
        self.path = str(path)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fresh = not (append and os.path.exists(self.path))
        self._f = open(self.path, "w" if fresh else "a", newline="")
        self._w = csv_lib.writer(self._f)
        if fresh:
            self._w.writerow(CSV_COLUMNS)
            self._f.flush()

    def _row(self, kind: str, rec: dict, extra=None) -> None:
        row = _round_row(rec)
        merged = row.pop("extra", None)
        if extra is None:
            extra = merged
        cells = [kind] + [row[k] for k in ROUND_FIELDS]
        cells.append(json.dumps(extra, sort_keys=True) if extra else "")
        self._w.writerow(cells)
        self._f.flush()

    def run_started(self, meta: dict) -> None:
        self._row("meta", {}, extra=dict(meta))

    def log_round(self, rec: dict) -> None:
        self._row("round", rec)

    def log_eval(self, rec: dict) -> None:
        self._row("eval", rec)

    def log_timings(self, scopes: dict) -> None:
        self._row("timings", {}, extra=dict(scopes))

    def log_snapshot(self, snap: dict) -> None:
        self._row("snapshot", {}, extra=dict(snap))

    def log_payload(self, key: str, obj) -> None:
        self._row("payload", {}, extra={key: obj})

    def on_resume(self, round_: int) -> None:
        self._f.close()
        with open(self.path, newline="") as f:
            rows = list(csv_lib.reader(f))
        kind_i, round_i = 0, 1 + ROUND_FIELDS.index("round")

        def keep(row):
            if row[kind_i] not in ("round", "eval"):
                return True
            return row[round_i] and float(row[round_i]) <= round_

        kept = [rows[0]] + [r for r in rows[1:] if keep(r)]
        with open(self.path, "w", newline="") as f:
            csv_lib.writer(f).writerows(kept)
        self._f = open(self.path, "a", newline="")
        self._w = csv_lib.writer(self._f)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


@register_tracker("composite")
class CompositeTracker(Tracker):
    """Fans every event out to child trackers, in order."""

    def __init__(self, trackers):
        self.trackers = list(trackers)

    def _fan(self, method: str, *args) -> None:
        for t in self.trackers:
            getattr(t, method)(*args)

    def run_started(self, meta):
        self._fan("run_started", meta)

    def log_round(self, rec):
        self._fan("log_round", rec)

    def log_eval(self, rec):
        self._fan("log_eval", rec)

    def log_timings(self, scopes):
        self._fan("log_timings", scopes)

    def log_snapshot(self, snap):
        self._fan("log_snapshot", snap)

    def log_payload(self, key, obj):
        self._fan("log_payload", key, obj)

    def on_resume(self, round_):
        self._fan("on_resume", round_)

    def flush(self):
        self._fan("flush")

    def close(self):
        self._fan("close")


def _coerce(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


TrackerSpec = Union[None, str, list, tuple, Tracker]


def parse_tracker_spec(spec: str) -> tuple:
    """``"json:runs/a.json,append=1"`` -> ("json", {"path": ..., "append": 1}).

    A body segment without ``=`` is sugar for the ``path`` option (the
    common CLI shape ``--track json:<path>``).
    """
    name, _, body = spec.partition(":")
    name = name.strip()
    opts: dict = {}
    if body.strip():
        for item in body.split(","):
            k, sep, v = item.partition("=")
            if not sep:
                if "path" in opts:
                    raise ValueError(
                        f"malformed option {item!r} in tracker spec {spec!r}"
                    )
                opts["path"] = k.strip()
            else:
                if not k.strip():
                    raise ValueError(
                        f"malformed option {item!r} in tracker spec {spec!r}"
                    )
                opts[k.strip()] = _coerce(v.strip())
    return name, opts


def make_tracker(spec: TrackerSpec = None, **defaults) -> Tracker:
    """Build a registered tracker from a spec (``make_mechanism``-style).

    ``None`` -> noop; Tracker instances pass through; a list/tuple of
    specs (or a ``+``-joined spec string) builds a composite; ``defaults``
    are fallback options filtered per backend, spec options override.
    """
    if spec is None:
        return NoopTracker()
    if isinstance(spec, Tracker):
        return spec
    if isinstance(spec, (list, tuple)):
        return CompositeTracker([make_tracker(s, **defaults) for s in spec])
    if not isinstance(spec, str):
        raise TypeError(
            f"tracker spec must be None | str | list | Tracker, "
            f"got {type(spec)}"
        )
    if "+" in spec:
        return make_tracker([s for s in spec.split("+") if s.strip()],
                            **defaults)
    name, explicit = parse_tracker_spec(spec)
    cls = get_tracker(name)
    params = inspect.signature(cls.from_options).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        # the default from_options forwards **options to the constructor:
        # validate against the constructor's real signature instead
        params = {k: p for k, p in
                  inspect.signature(cls.__init__).parameters.items()
                  if k != "self"}
    accepted = set(params)
    unknown = set(explicit) - accepted
    if unknown:
        raise ValueError(
            f"tracker {name!r} does not accept option(s) {sorted(unknown)}; "
            f"accepted: {sorted(accepted)}"
        )
    options = {k: v for k, v in defaults.items() if k in accepted}
    options.update(explicit)
    return cls.from_options(**options)


def write_bench_json(path: Optional[str], meta: dict, payloads: dict):
    """The one BENCH_*.json writer every benchmark's ``bench_json`` routes
    through: meta + named result payloads in the tracker document format
    (benchmarks that also train can pass the same JsonTracker into
    FedTrainer to capture the per-round series alongside)."""
    tracker = JsonTracker(path)
    tracker.run_started(meta)
    for key, obj in payloads.items():
        tracker.log_payload(key, obj)
    tracker.close()
    print("wrote", path)
    return tracker.doc

"""Telemetry (counterpart of ``repro/telemetry``): the metrics plane of
the port's federated runs, with the reference's exports and schema.

  * ``tracker`` — the ``@register_tracker`` registry and the four
    backends (``noop``/``json``/``csv``/``composite``), built from spec
    strings (``"json:runs/a.json"``); ``write_bench_json`` writes a
    BENCH_*.json document.
  * ``emit``    — ``RoundEmitter``, the decode-apply-boundary hook:
    accounted rounds -> records whose eps_spent / realized_n series equal
    the accountant's, bit for bit.
  * ``timing``  — wall-clock ``Timings`` scopes (stage / round_block).

Every ``FedTrainer`` emits through it (``FedConfig.track`` or the
``tracker=`` argument).
"""
from repro_torch.telemetry.emit import RoundEmitter
from repro_torch.telemetry.timing import Timings
from repro_torch.telemetry.tracker import (
    CSV_COLUMNS,
    ROUND_FIELDS,
    SCHEMA_VERSION,
    CompositeTracker,
    CsvTracker,
    JsonTracker,
    NoopTracker,
    Tracker,
    get_tracker,
    make_tracker,
    parse_tracker_spec,
    register_tracker,
    tracker_names,
    write_bench_json,
)

__all__ = [
    "CSV_COLUMNS",
    "ROUND_FIELDS",
    "SCHEMA_VERSION",
    "CompositeTracker",
    "CsvTracker",
    "JsonTracker",
    "NoopTracker",
    "RoundEmitter",
    "Timings",
    "Tracker",
    "get_tracker",
    "make_tracker",
    "parse_tracker_spec",
    "register_tracker",
    "tracker_names",
    "write_bench_json",
]

"""The port's telemetry (src/repro_torch/telemetry) against the reference's
on the CPU, at the suite's small problem (24 clients, cohorts of 6).

Contracts:
  * ``ROUND_FIELDS``, ``CSV_COLUMNS`` and ``SCHEMA_VERSION`` are the
    reference's; the registry and spec parsing behave as
    ``tests/test_telemetry.py`` has the reference's behave;
  * the port's JSON and CSV trackers write the same documents as the
    reference's for the same events (``write_bench_json`` byte for byte);
  * on scan, perround and one-rank gloo shard the emitted eps_spent and
    realized_n equal the port's accountant after each round, bit for bit;
  * a port trainer and a reference trainer of the same mechanism and
    config emit round records equal in every field but rounds_per_sec
    (eps_spent and eps_remaining to 1e-12 relative; the bit counts and
    pack width exactly), packed and dense, and run metadata with the same
    keys;
  * a resumed run continues its tracked series with no duplicate or
    missing round.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import csv
import json
import math

import pytest

from repro.core.mechanisms import make_mechanism as jax_make_mechanism
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro import telemetry as jtelemetry
from repro_torch.core import wire
from repro_torch.core.renyi import RenyiAccountant
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.telemetry import (
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

SMALL = dict(num_clients=24, clients_per_round=6, lr=1.0, eval_size=64,
             samples_per_client=8)
SPEC = "rqm:c=0.05,m=16,q=0.42"
QUIET = dict(eval_every=2, log=lambda *_: None)
EPS_RTOL = 1e-12


def _trainer(engine="scan", tracker=None, spec=SPEC, **overrides):
    kw = {"shards": 1} if engine == "shard" else {}
    return FedTrainer(spec, FedConfig(engine=engine, **kw, **{**SMALL, **overrides}),
                      device="cpu", tracker=tracker)


def replay_eps_series(trainer):
    """eps_spent after each round, from a replayed accountant: what the
    tracked series must equal bit for bit."""
    acc = RenyiAccountant(alphas=trainer.cfg.accountant_alphas)
    out = []
    for vec in trainer.accountant.history:
        acc.step(vec)
        out.append(acc.dp_epsilon(trainer.cfg.budget_delta)[0])
    return out


# ---------------------------------------------------------------------------
# schema, registry, specs
# ---------------------------------------------------------------------------


def test_schema_equals_reference():
    assert ROUND_FIELDS == jtelemetry.ROUND_FIELDS
    assert CSV_COLUMNS == jtelemetry.CSV_COLUMNS
    assert SCHEMA_VERSION == jtelemetry.SCHEMA_VERSION
    import repro_torch.telemetry as port

    assert port.__all__ == jtelemetry.__all__


def test_registry_round_trip():
    names = tracker_names()
    for name in ("noop", "json", "csv", "composite"):
        assert name in names
        assert get_tracker(name).name == name
    assert get_tracker("noop") is NoopTracker
    assert get_tracker("json") is JsonTracker
    assert get_tracker("json") is not jtelemetry.JsonTracker  # the port's own copy


def test_registry_unknown_and_collision():
    with pytest.raises(ValueError, match="unknown tracker"):
        get_tracker("carrier-pigeon")
    with pytest.raises(ValueError, match="already registered"):
        @register_tracker("json")
        class Impostor(Tracker):
            pass
    with pytest.raises(TypeError, match="must subclass Tracker"):
        @register_tracker("rogue")
        class NotATracker:
            pass
    assert register_tracker("json")(JsonTracker) is JsonTracker  # idempotent


def test_parse_spec_path_sugar_and_options():
    for parse in (parse_tracker_spec, jtelemetry.parse_tracker_spec):
        assert parse("json:runs/a.json") == ("json", {"path": "runs/a.json"})
        assert parse("json:runs/a.json,append=true,indent=0") == (
            "json", {"path": "runs/a.json", "append": True, "indent": 0})
        with pytest.raises(ValueError, match="malformed"):
            parse("json:a.json,b.json")


def test_make_tracker_shapes_and_errors(tmp_path):
    assert isinstance(make_tracker(None), NoopTracker)
    assert isinstance(make_tracker("noop"), NoopTracker)
    t = JsonTracker(str(tmp_path / "x.json"))
    assert make_tracker(t) is t
    comp = make_tracker(f"json:{tmp_path}/a.json+csv:{tmp_path}/a.csv")
    assert isinstance(comp, CompositeTracker)
    assert [type(c) for c in comp.trackers] == [JsonTracker, CsvTracker]
    comp2 = make_tracker([f"json:{tmp_path}/b.json", "noop"])
    assert [type(c) for c in comp2.trackers] == [JsonTracker, NoopTracker]
    with pytest.raises(ValueError, match="does not accept option"):
        make_tracker(f"json:{tmp_path}/a.json,compression=9")
    with pytest.raises(TypeError, match="tracker spec"):
        make_tracker(42)
    for cls in (JsonTracker, CsvTracker):
        with pytest.raises(ValueError, match="needs a path"):
            cls("")


# ---------------------------------------------------------------------------
# the documents
# ---------------------------------------------------------------------------


def _events(tracker):
    tracker.run_started({"engine": "scan", "dim": 222_030, "mesh": None})
    for i in range(1, 6):
        tracker.log_round({"round": i, "engine": "scan", "eps_spent": 0.1 * i,
                           "rounds_per_sec": 3.5, "wire_bits": 2_368_320, "pack_width": 10,
                           "staleness": i % 2})
    tracker.log_eval({"round": 4, "loss": 0.5, "accuracy": 0.75})
    tracker.log_timings({"round_block": {"seconds": 1.25, "count": 2}})
    tracker.log_snapshot({"rounds_served": 5})
    tracker.log_payload("table", {"a": [1, 2]})
    tracker.on_resume(3)
    tracker.log_round({"round": 4, "eps_spent": 0.45})
    tracker.close()


def test_documents_equal_reference_trackers(tmp_path):
    for name in ("json", "csv"):
        port_path, ref_path = tmp_path / f"port.{name}", tmp_path / f"ref.{name}"
        _events(make_tracker(f"{name}:{port_path}"))
        _events(jtelemetry.make_tracker(f"{name}:{ref_path}"))
        assert port_path.read_bytes() == ref_path.read_bytes(), name
    rows = list(csv.reader((tmp_path / "port.csv").open()))
    assert tuple(rows[0]) == CSV_COLUMNS
    round_col = 1 + ROUND_FIELDS.index("round")
    assert [r[round_col] for r in rows[1:] if r[0] == "round"] == ["1", "2", "3", "4"]
    assert not any(r[0] == "eval" for r in rows[1:])  # dropped past round 3
    doc = json.loads((tmp_path / "port.json").read_text())
    assert [r["round"] for r in doc["rounds"]] == [1, 2, 3, 4]
    assert doc["rounds"][0]["extra"] == {"staleness": 1}
    meta, payloads = {"benchmark": "x"}, {"engines": {"scan": {"rounds_per_s": 9.0}}}
    doc = write_bench_json(str(tmp_path / "BENCH_port.json"), meta, payloads)
    jtelemetry.write_bench_json(str(tmp_path / "BENCH_ref.json"), meta, payloads)
    assert ((tmp_path / "BENCH_port.json").read_bytes()
            == (tmp_path / "BENCH_ref.json").read_bytes())
    assert json.loads((tmp_path / "BENCH_port.json").read_text()) == doc


def test_append_continues_a_document(tmp_path):
    path = tmp_path / "a.json"
    first = JsonTracker(str(path))
    first.log_round({"round": 1})
    first.close()
    again = make_tracker(f"json:{path},append=true")
    again.log_round({"round": 2})
    again.flush()
    assert [r["round"] for r in json.loads(path.read_text())["rounds"]] == [1, 2]


# ---------------------------------------------------------------------------
# the trainer's series
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["scan", "perround", "shard"])
def test_eps_series_bit_identical_per_engine(engine, tmp_path):
    path = tmp_path / f"{engine}.json"
    tr = _trainer(engine, f"json:{path}")
    tr.train(rounds=2, **QUIET)
    doc = json.loads(path.read_text())
    assert [r["round"] for r in doc["rounds"]] == [1, 2]
    assert [r["realized_n"] for r in doc["rounds"]] == tr.realized_n == [6, 6]
    assert [r["eps_spent"] for r in doc["rounds"]] == replay_eps_series(tr)  # ==: bit for bit
    assert doc["rounds"][-1]["eps_spent"] == tr.accountant.dp_epsilon(1e-5)[0]
    assert all(r["engine"] == engine and r["rounds_per_sec"] > 0 for r in doc["rounds"])
    assert [e["round"] for e in doc["evals"]] == [2]
    assert {"stage", "round_block"} <= set(doc["timings"])
    assert doc["meta"]["backend"] == "cpu" and doc["meta"]["engine"] == engine
    assert doc["meta"]["mesh"] == ({"axes": {"shard": 1}, "devices": 1}
                                   if engine == "shard" else None)


def _records(doc):
    return [{k: v for k, v in r.items() if k != "rounds_per_sec"} for r in doc["rounds"]]


@pytest.mark.parametrize("packed", [None, False], ids=["packed", "dense"])
def test_round_records_match_reference(packed, tmp_path):
    """The same mechanism and config in both packages: the same records
    but for rounds_per_sec, and run metadata with the same keys."""
    cfg = dict(engine="perround", fused_rounds=True, wire_packed=packed, budget_eps=500.0,
               **SMALL)
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    jtr = JaxFedTrainer(jax_make_mechanism(SPEC), JaxFedConfig(**cfg),
                        tracker=f"json:{ref_path}")
    jtr.train(rounds=2, **QUIET)
    tr = FedTrainer(SPEC, FedConfig(**cfg), device="cpu", tracker=f"json:{port_path}")
    tr.train(rounds=2, **QUIET)
    ref, port = json.loads(ref_path.read_text()), json.loads(port_path.read_text())
    assert sorted(port["meta"]) == sorted(ref["meta"])
    for k in ("kind", "engine", "task", "mechanism", "mechanism_spec", "num_clients",
              "clients_per_round", "server_opt", "budget_eps", "accountant_alphas", "dim",
              "shards", "mesh"):
        assert port["meta"][k] == ref["meta"][k], k
    assert port["meta"]["fingerprint"] != ref["meta"]["fingerprint"]  # torch vs jax.random
    got, want = _records(port), _records(ref)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("eps_spent", "eps_remaining"):
            assert math.isclose(g[k], w[k], rel_tol=EPS_RTOL), k
        assert {k: v for k, v in g.items() if k not in ("eps_spent", "eps_remaining")} == \
            {k: v for k, v in w.items() if k not in ("eps_spent", "eps_remaining")}
    bits = wire.sum_bits(tr.mech.sum_bound(6))
    assert got[0]["secagg_sum_bits"] == tr.flat.numel() * bits
    if packed is None:
        assert got[0]["pack_width"] == bits == 7
        assert got[0]["wire_bits"] == 32 * wire.packed_words(tr.flat.numel(), bits)
    else:
        assert got[0]["pack_width"] is None and got[0]["wire_bits"] == 32 * tr.flat.numel()
    for row in port["rounds"]:
        assert row["eps_remaining"] == max(0.0, 500.0 - row["eps_spent"])


def test_resume_continues_series(tmp_path):
    """Round indices 1..4 with no duplicate or gap across a checkpoint
    restore, in the JSON and the CSV document, and the continued eps series
    equals the accountant's bit for bit."""
    cfg = dict(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2)
    jpath, cpath = tmp_path / "run.json", tmp_path / "run.csv"
    killed = _trainer(tracker=f"json:{jpath}+csv:{cpath}", **cfg)
    killed.train(rounds=2, **QUIET)  # dies here; the checkpoint and documents survive
    killed.round()  # a round past the checkpoint, emitted and then lost
    killed.tracker.flush()
    del killed
    resumed = _trainer(tracker=f"json:{jpath},append=true+csv:{cpath},append=true", **cfg)
    assert resumed.restore_checkpoint() == 2
    resumed.train(rounds=2, **QUIET)
    doc = json.loads(jpath.read_text())
    assert [r["round"] for r in doc["rounds"]] == [1, 2, 3, 4]
    assert [r["eps_spent"] for r in doc["rounds"]] == replay_eps_series(resumed)
    assert [e["round"] for e in doc["evals"]] == [2, 4]
    rows = list(csv.reader(cpath.open()))
    round_col = 1 + ROUND_FIELDS.index("round")
    assert [r[round_col] for r in rows[1:] if r[0] == "round"] == ["1", "2", "3", "4"]


def test_noop_is_the_default_and_emits_nothing():
    tr = _trainer("perround", spec="none:c=0.05")
    assert isinstance(tr.tracker, NoopTracker) and not tr._emitter.enabled
    tr.round()
    assert tr._emitter.emitted == tr.accountant.rounds == 1
    assert tr.timings.summary()["round_block"]["count"] == 1
    cfg_tracked = _trainer("perround", spec="none:c=0.05", track="noop")
    assert isinstance(cfg_tracked.tracker, NoopTracker)

"""The port's round-engine registry (``repro_torch/fed/engine.py``)
against the reference's (``repro/fed/engine.py``) on the CPU.

Contracts:
  * ``scan``, ``perround``, ``host``, ``shard`` and ``async`` register in
    the reference's order;
  * each engine's spec options are the reference's (but scan's
    ``unroll``, which sets the XLA-only ``scan_unroll``), and a spec
    string parses to the reference's options and FedConfig overrides and
    round-trips through its canonical string;
  * unknown engines and options raise with the registered and accepted
    sets; a registered subclass trains through the stock trainer; the
    trainer takes a spec string and applies it to its own copy of the
    config; streamed staging is refused by the engines that cannot
    stream, and fused rounds by the host engine;
  * ``examples/fl_emnist_torch.py`` trains with an engine spec and a
    heterogeneous cohort, and with ``--target-eps`` calibrates the
    family to the budget, as ``privacy.calibrate`` does.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses
import json
import os
import runpy
import sys

import pytest
import torch

from repro.fed import engine as jengine
from repro.fed import engines as _jengines  # noqa: F401  (registers the reference's)
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.fed import engines
from repro_torch.fed.config import FedConfig, validate_config
from repro_torch.fed.engine import (
    _REGISTRY,
    EngineSpec,
    engine_names,
    get_engine,
    make_engine,
    parse_engine_spec,
    register_engine,
)
from repro_torch.fed.trainer import FedTrainer

EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples",
                       "fl_emnist_torch.py")
SMALL = dict(num_clients=24, clients_per_round=4, lr=1.0, eval_size=64,
             samples_per_client=8)
SPEC = "none:c=0.05"
PORTED = ("scan", "perround", "host", "shard", "async")


def _trainer(engine="scan", **overrides):
    return FedTrainer(SPEC, FedConfig(engine=engine, **{**SMALL, **overrides}), device="cpu")


def test_builtin_engines_register_in_the_reference_order():
    assert engine_names() == PORTED
    assert jengine.engine_names() == PORTED
    for name in PORTED:
        assert get_engine(name).name == name
    assert get_engine("scan") is engines.ScanEngine
    assert get_engine("host").stages_population is False
    assert get_engine("shard").supports_streaming and get_engine("shard").blocked


@pytest.mark.parametrize("name", PORTED)
def test_spec_options_are_the_reference(name):
    want = dict(jengine.get_engine(name).spec_options)
    if name == "scan":
        assert want.pop("unroll") == "scan_unroll"  # XLA-only
    assert get_engine(name).spec_options == want
    for field in want.values():
        assert field in {f.name for f in dataclasses.fields(FedConfig)}


@pytest.mark.parametrize("spec", [
    "scan", "perround", "host", "shard", "scan:block=2", "shard:shards=2,staging=stream",
    "shard:packed=true,shards=1", "shard:model=1", "async",
    "async:cadence=6,max_staleness=2,staleness_weight=poly:0.5",
    "async:arrivals=diurnal,rate=2.5,latency=0.5,timeout=1.5",
])
def test_spec_parses_as_the_reference(spec):
    got, want = make_engine(spec), jengine.make_engine(spec)
    assert got.name == want.name
    assert got.options == want.options and got.overrides == want.overrides
    assert got.spec() == want.spec()
    assert make_engine(got.spec()) == got
    assert make_engine(got) is got
    if ":" not in spec:
        assert got == EngineSpec(name=spec) and got.spec() == spec


def test_unknown_engine_and_option_are_rejected():
    with pytest.raises(ValueError, match="unknown engine.*scan, perround, host, shard"):
        get_engine("warp")
    with pytest.raises(ValueError, match="unknown engine"):
        _trainer("warp")
    with pytest.raises(ValueError, match="does not accept option.*cadence"):
        make_engine("scan:cadence=4")
    with pytest.raises(ValueError, match="does not accept option.*unroll"):
        make_engine("scan:unroll=true")
    with pytest.raises(ValueError, match=r"accepted: \(none\)"):
        make_engine("perround:block=2")
    with pytest.raises(ValueError, match="empty engine name"):
        parse_engine_spec(":block=4")
    with pytest.raises(TypeError, match="engine spec must be a str"):
        make_engine(42)


def test_register_rejects_non_engines_and_collisions():
    with pytest.raises(TypeError, match="must subclass Engine"):
        register_engine("bogus")(object)
    with pytest.raises(ValueError, match="already registered"):
        register_engine("scan")(engines.PerRoundEngine)
    assert register_engine("scan")(engines.ScanEngine) is engines.ScanEngine
    assert engine_names() == PORTED


def test_a_registered_engine_trains_through_the_stock_trainer():
    @register_engine("perround2")
    class PerRound2(engines.PerRoundEngine):
        pass

    try:
        a, b = _trainer("perround2"), _trainer("perround")
        assert isinstance(a.engine, PerRound2) and a.cfg.engine == "perround2"
        for tr in (a, b):
            tr.train(3, eval_every=3, log=lambda msg: None)
        assert torch.equal(a.flat, b.flat)
    finally:
        _REGISTRY.pop("perround2", None)
    assert engine_names() == PORTED


def test_trainer_applies_a_spec_string_to_its_own_copy():
    cfg = FedConfig(engine="shard:shards=1,packed=false,staging=stream", **SMALL)
    tr = FedTrainer(SPEC, cfg, device="cpu")
    assert isinstance(tr.engine, engines.ShardEngine)
    assert (tr.cfg.engine, tr.cfg.shards, tr.cfg.shard_packed, tr.cfg.staging) == \
        ("shard", 1, False, "stream")
    assert cfg.engine == "shard:shards=1,packed=false,staging=stream" and cfg.shards is None
    scan = FedTrainer(SPEC, FedConfig(engine="scan:block=2", **SMALL), device="cpu")
    assert scan.cfg.scan_block == 2 and scan.cfg.engine == "scan"
    scan.run_block(3)
    plain = _trainer("scan")
    plain.run_block(3)
    assert torch.equal(scan.flat, plain.flat)


@pytest.mark.parametrize("engine", ["scan", "perround", "host"])
def test_streamed_staging_needs_a_streaming_engine(engine):
    cfg = FedConfig(staging="stream", **SMALL)
    validate_config(cfg)  # the engine-independent checks pass
    with pytest.raises(ValueError, match="stream.*requires"):
        get_engine(engine).validate(cfg, make_mechanism(SPEC))
    with pytest.raises(ValueError, match="stream.*requires"):
        _trainer(engine, staging="stream")
    get_engine("shard").validate(cfg, make_mechanism(SPEC))


def test_generic_checks_precede_engine_checks():
    with pytest.raises(ValueError, match="unknown staging"):
        _trainer("scan", staging="lazy")
    with pytest.raises(ValueError, match="ckpt_every requires"):
        _trainer("scan", ckpt_every=5)
    with pytest.raises(ValueError, match="fused_rounds=True"):
        _trainer("host", fused_rounds=True)


def test_blocked_and_per_round_engines():
    for name in PORTED:
        tr = _trainer(name)
        if tr.engine.blocked:
            tr.run_block(2)
        else:
            with pytest.raises(ValueError, match="run_block requires a blocked engine"):
                tr.run_block(2)
            tr.round()
            tr.round()
        assert tr.accountant.rounds == 2 and tr.realized_n == [4, 4]


def test_example_script(monkeypatch, tmp_path):
    out = tmp_path / "out.json"
    argv = [EXAMPLE, "--device", "cpu", "--rounds", "2", "--clients", "24", "--per-round", "4",
            "--mechanism", "none", "--engine", "shard:shards=1", "--dropout", "0.3",
            "--out", str(out)]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_path(EXAMPLE, run_name="__main__")
    (result,) = json.loads(out.read_text())
    assert result["mechanism"] == "none" and result["history"][-1]["round"] == 2
    # --target-eps: rqm's q calibrated to the budget of the run's rounds
    from repro_torch.privacy.calibrate import calibrate

    cal_out = tmp_path / "calibrated.json"
    monkeypatch.setattr(sys, "argv", [EXAMPLE, "--device", "cpu", "--rounds", "2", "--clients",
                                      "24", "--per-round", "4", "--mechanism", "rqm",
                                      "--target-eps", "30", "--out", str(cal_out)])
    runpy.run_path(EXAMPLE, run_name="__main__")
    (result,) = json.loads(cal_out.read_text())
    want = calibrate("rqm", target_eps=30.0, target_delta=1e-5, rounds=2, cohort=4, c=0.02,
                     m=16, delta_ratio=1.0)
    assert result["spec"] == want.mechanism.describe()
    assert result["history"][-1]["round"] == 2
    assert 0.99 * 30 <= result["dp_eps_at_1e-5"] <= 30

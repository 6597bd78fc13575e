"""The harness: the manifest against the benchmark's contract, cells and
metrics found by name, the modules a run loads, runs of every cell at a
small size on the CPU, and faults planted under the timed path coming
out as not correct. Tests marked ``cuda`` run the control and whole runs
on the card; they skip without one."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from small_cells import BENCH, ROOT, bench, small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def manifest() -> dict:
    return bench.load_json(ROOT / "BENCHMARK.json")


def test_manifest_keeps_to_the_contract():
    m = manifest()
    assert set(m) == KEYS
    assert 1 <= m["run_seconds"] <= 51
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert m["paths"] == ["port_bench"] and m["command"][1].startswith("port_bench/")
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        assert (ROOT / c["file"]).is_file() and len(c["why"]) <= 200 and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank")) for k in c["reduced"])
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and w["config"] in {c["name"] for c in m["configs"]}
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()
        c = bench.cell(w["name"], m)
        reported = {e["name"] for e in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert p["moves"] in e2e and bench.reader_path(p["name"]).is_file()
        for w in p.get("workloads", []):
            assert w in e2e[p["moves"]].get("workloads", [w])
    for item in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]:
        assert NAME.match(item["name"]) and item["name"] not in names
        names.add(item["name"])
        if "unit" in item:
            assert UNIT.match(item["unit"]) and item["better"] in ("lower", "higher")
    assert len(json.dumps(m)) < 64 * 1024


def digest(folder) -> dict:
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_added_as_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(copy / "port_bench")
    m = manifest()
    m["workloads"].append({"name": "cnn-fixed8", "config": "emnist-cnn-rqm",
                           "traffic": "fixed8", "chips": 1, "why": "a test's cell"})
    m["end_to_end"][0]["workloads"].append("cnn-fixed8")
    m["per_layer"].append({"name": "rounds_seen.round", "unit": "rounds", "better": "higher",
                           "source": "host_clock", "layer": "trainer and engine",
                           "moves": "rounds_per_s", "workloads": ["cnn-fixed8"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    traffic = dict(bench.load_json(BENCH / "traffic" / "fixed40.json"), cohort=8)
    (copy / "port_bench" / "traffic" / "fixed8.json").write_text(json.dumps(traffic))
    (copy / "port_bench" / "cells" / "cnn-fixed8.json").write_text(
        (BENCH / "cells" / "cnn-fixed40.json").read_text())
    (copy / "port_bench" / "metrics" / "rounds_seen.round.py").write_text(
        "def read(run):\n    return run['window']['rounds']\n")
    other = bench.load_module(copy / "port_bench" / "bench.py", "port_bench_copy")
    c = other.cell("cnn-fixed8")
    assert c.traffic["cohort"] == 8 and [p["name"] for p in c.per_layer] == ["rounds_seen.round"]
    assert other.read_metrics(c, {"window": {"rounds": 64}}) == {
        "rounds_seen.round": {"value": 64.0, "unit": "rounds"}}
    after = digest(copy / "port_bench")
    assert all(after[k] == v for k, v in before.items())


RUN_ONE = """
import sys
sys.path[:0] = [{bench!r}, {tests!r}]
import small_cells
c = small_cells.small("cnn-fixed40")
small_cells.bench.driver("fl_rounds").sound(c, 5, "cpu")
c = small_cells.small("mamba2-train-8x1024")
small_cells.bench.driver("lm_train").sound(c, 5, "cpu")
for name in ("mfu.round", "encode_roofline.train", "client_grad_ms.round"):
    small_cells.bench.load_module(small_cells.BENCH / "metrics" / (name + ".py"), name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE_ONLY = """
import sys
sys.path[:0] = [{bench!r}]
from reference import cohort, emnist, fl_round, mamba2, rqm
import yardstick
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(bench=str(BENCH),
                                                            tests=str(BENCH / "tests"))],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tops = loaded(RUN_ONE)
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded(REFERENCE_ONLY)
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.mark.parametrize("name", ["cnn-fixed40", "cnn-poisson40-packed", "mamba2-train-8x1024"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_on_the_cpu_is_correct(name, trace):
    c = small(name)
    out = bench.driver(c.traffic["kind"]).run(c, 2**31 + 11, 0.3, trace, time.perf_counter(),
                                              device="cpu")
    correct, rows = bench.verdict(out["readings"], c.limits)
    assert correct, rows
    assert set(out["metrics"]) == {e["name"] for e in c.end_to_end}
    if trace:
        got = bench.read_metrics(c, out["run"])
        assert "mfu.round" in got or "mfu.train" in got


@pytest.mark.parametrize("name", ["cnn-fixed40", "mamba2-train-8x1024"])
def test_the_program_runs_with_tf32_off(monkeypatch, name):
    """cuDNN's own default is TF32 on; the readings' path turns it off
    before it builds the program, as a run does."""
    c = small(name)
    drv = bench.driver(c.traffic["kind"])
    real, seen = drv.build, []

    def build(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args, **kw)

    monkeypatch.setattr(drv, "build", build)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    drv.sound(c, 3, "cpu")
    assert seen == [(False, False)]


def unchanged_round(monkeypatch):
    from repro_torch.fed import engines

    monkeypatch.setattr(engines.ScanEngine, "step", lambda self, flat, opt, t: t.add_(1))


def half_cohort(monkeypatch):
    """Half of the taking clients left out, the mean taken over the rest:
    a fixed cohort's second half replaced by its first; a masked slate's
    first half of takers weighted twice and the others not at all."""
    from repro_torch.core.mechanisms import RQMMechanism
    from repro_torch.fed import rounds

    real_index = rounds.index_batch
    real_sum = RQMMechanism.quantize_sum_batch

    def index_batch(data, ids):
        keep = ids[: max(1, ids.shape[0] // 2)]
        return real_index(data, torch.cat([keep, keep])[: ids.shape[0]])

    def quantize_sum_batch(self, g, seed, *, weights=None, **kw):
        if weights is not None:
            taking = torch.cumsum(weights, 0)
            half = (weights.sum() + 1) // 2
            weights = torch.where(taking <= half, 2 * weights, 0 * weights)
        return real_sum(self, g, seed, weights=weights, **kw)

    monkeypatch.setattr(rounds, "index_batch", index_batch)
    monkeypatch.setattr(RQMMechanism, "quantize_sum_batch", quantize_sum_batch)


def stale_row(monkeypatch):
    """A wrong row index: rounds past a block's second read its draws
    (cohort, seed, mask), which only a block of more than two rounds
    shows."""
    from repro_torch.fed import engines

    real = engines.ScanEngine.round_at
    monkeypatch.setattr(engines.ScanEngine, "round_at",
                        lambda self, flat, opt, t: real(self, flat, opt, t.clamp(max=1)))


def unchanged_step(monkeypatch):
    from repro_torch.distributed import step

    real = step.build_train_step_fn

    def build(*args, **kw):
        body = real(*args, **kw)

        def train_step(params, opt_state, k, batch, seeds):
            _, _, metrics = body(params, opt_state, k, batch, seeds)
            return params, opt_state, metrics

        return train_step

    monkeypatch.setattr(step, "build_train_step_fn", build)


def half_rows(monkeypatch):
    from repro_torch.models import model

    real = model.loss_fn

    def loss_fn(params, cfg, ctx, batch, **kw):
        rows = next(iter(batch.values())).shape[0] // 2
        batch = {k: torch.cat([v[:rows], v[:rows]]) for k, v in batch.items()}
        return real(params, cfg, ctx, batch, **kw)

    monkeypatch.setattr(model, "loss_fn", loss_fn)


@pytest.mark.parametrize("name,fault", [
    ("cnn-fixed40", unchanged_round), ("cnn-fixed40", half_cohort), ("cnn-fixed40", stale_row),
    ("cnn-poisson40-packed", unchanged_round), ("cnn-poisson40-packed", half_cohort),
    ("cnn-poisson40-packed", stale_row),
    ("mamba2-train-8x1024", unchanged_step), ("mamba2-train-8x1024", half_rows)])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    c = small(name)
    out = bench.driver(c.traffic["kind"]).run(c, 2**31 + 12, 0.3, False, time.perf_counter(),
                                              device="cpu")
    correct, rows = bench.verdict(out["readings"], c.limits)
    assert not correct, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn-fixed40", "cnn-poisson40-packed", "mamba2-train-8x1024"])
def test_the_control_is_not_correct_on_the_card(card, name):
    c = bench.cell(name)
    got = bench.driver(c.traffic["kind"]).planted(c, 2**31 + 13, str(card), tf32=True)
    torch.cuda.empty_cache()  # the card is the next test's run's alone
    assert not bench.verdict(got, c.limits)[0], got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn-fixed40", "cnn-poisson40-packed", "mamba2-train-8x1024"])
def test_a_short_run_on_the_card(card, name):
    torch.cuda.empty_cache()  # the run is a process of its own on the same card
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", name, "--seed",
                          str(2**31 + 14), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"

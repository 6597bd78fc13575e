"""The per-layer metrics that read the program's span log
(``program_spans.py`` and its readers under ``metrics/``): fed a
synthetic log and run, each returns its documented value from the
window's steps or blocks alone, and None where its spans are missing;
a small run on the CPU reports them from the program's own log."""
from __future__ import annotations

import statistics
import time

import pytest

from small_cells import BENCH, bench, small
from repro_torch.telemetry import timing

STEP_READERS = {"forward_host_ms.train": "train_step.forward",
                "backward_host_ms.train": "train_step.backward",
                "encode_host_ms.train": "train_step.encode",
                "update_host_ms.train": "train_step.update"}
MS = 1_000_000  # ns


def reader(name: str):
    return bench.load_module(bench.reader_path(name), "port_bench_metric_" + name.replace(".", "_"))


class Log:
    """A synthetic span log, spans laid end to end on a clock in ns."""

    def __init__(self):
        self.spans, self.now = [], 0

    def add(self, name: str, ns: int, parent=None, **attrs) -> timing.Span:
        span = timing.Span(len(self.spans), name, self.now, self.now + ns,
                           None if parent is None else parent.index, attrs)
        self.spans.append(span)
        self.now += ns
        return span


def step_log() -> tuple:
    """Steps 0-9 (set-up 0-2, the window 3-6, the traced 7-9), phase k of
    step t taking (t + 1) * (k + 1) ms; set-up's and the traced steps'
    phases take far longer, so that reading them would show."""
    log, want = Log(), {}
    for t in range(10):
        top = log.add("train_step", 0, step=t)
        for k, phase in enumerate(STEP_READERS.values()):
            ms = (t + 1) * (k + 1) * (1 if 3 <= t <= 6 else 1000)
            log.add(phase, ms * MS, parent=top)
            if 3 <= t <= 6:
                want.setdefault(phase, []).append(float(ms))
    return log.spans, {"window": {"steps": 4, "seconds": 1.0}}, want


@pytest.mark.parametrize("name", list(STEP_READERS))
def test_a_step_phase_reads_the_median_over_the_window_steps(name):
    log, run, want = step_log()
    assert reader(name).read(run, log) == pytest.approx(statistics.median(want[STEP_READERS[name]]))


@pytest.mark.parametrize("name", list(STEP_READERS))
def test_a_step_phase_is_none_without_its_spans(name):
    log, run, _ = step_log()
    read = reader(name).read
    assert read(run, []) is None
    assert read(run, [s for s in log if s.name != STEP_READERS[name]]) is None
    assert read({"window": {"steps": 4}}, [s for s in log if s.name != "train_step"]) is None
    assert read({}, log) is None
    assert read({"window": {"steps": 2}}, [s for s in log if s.attrs.get("step", 0) >= 5]) is None


def block_log(block: int = 4, window_rounds: int = 12) -> tuple:
    """Set-up's blocks (rounds 1, 2-3, a block at the window's size), the
    window's, then three traced blocks; each block's four phases, draw
    taking 1 + first ms in the window and far longer elsewhere."""
    log, draws = Log(), []
    sizes = [1, 2, block] + [block] * (window_rounds // block) + [block] * 3
    first = 0
    for size in sizes:
        top = log.add("round_block", 0)
        in_window = 3 + block <= first < 3 + block + window_rounds
        ms = (1 + first) * (1 if in_window else 1000)
        for phase in ("draw", "copy_in", "replay", "finish"):
            extra = {"realized": size} if phase == "finish" else {}
            log.add(f"round_block.{phase}", (ms if phase == "draw" else 5) * MS, parent=top,
                    first=first, rounds=size, **extra)
        if in_window:
            draws.append(ms)
        first += size
    run = {"window": {"rounds": window_rounds, "seconds": 1.0}, "traffic": {"block": block}}
    return log.spans, run, draws


def test_draw_reads_the_window_blocks_draws_a_round():
    log, run, draws = block_log()
    assert len(draws) == 3
    assert reader("draw_host_ms.round").read(run, log) == pytest.approx(sum(draws) / 12)


def test_draw_is_none_without_its_spans():
    log, run, _ = block_log()
    read = reader("draw_host_ms.round").read
    assert read(run, []) is None
    assert read(run, [s for s in log if s.name != "round_block.draw"]) is None
    assert read(dict(run, traffic={}), log) is None
    assert read({"traffic": {"block": 4}}, log) is None


def test_stage_reads_the_latest_stage_span():
    log = Log()
    log.add("stage", 7 * MS)
    log.add("round_block", 3 * MS)
    log.add("stage", 2500 * MS)
    read = reader("stage_s.round").read
    assert read({}, log.spans) == pytest.approx(2.5)
    assert read({}, [s for s in log.spans if s.name != "stage"]) is None


def test_capture_reads_its_time_less_the_builds_inside_it():
    log = Log()
    log.add("kernels.build", 900 * MS, libs=4)  # before the capture: not its own
    cap = log.add("graph_capture", 0)
    log.add("kernels.build", 4000 * MS, parent=cap, libs=2)
    log.add("kernels.build", 1000 * MS, parent=cap, libs=1)
    log.add("round_block.draw", 300 * MS, parent=cap)
    # the capture's end: its whole interval, builds included
    cap = cap._replace(end_ns=log.now + 200 * MS)
    log.spans[cap.index] = cap
    log.add("kernels.build", 50 * MS, libs=1)  # after the capture
    read = reader("capture_s.round").read
    assert read({}, log.spans) == pytest.approx(0.5)
    assert read({}, [s for s in log.spans if s.name == "kernels.build"]) is None


def test_the_readers_read_the_program_log_by_default():
    """Without a log handed in, each reader reads the program's span log:
    nothing there, nothing read."""
    timing.clear_spans()
    log, run, _ = step_log()
    blocks, brun, _ = block_log()
    for name in list(STEP_READERS) + ["draw_host_ms.round", "stage_s.round", "capture_s.round"]:
        assert reader(name).read(dict(run, **brun)) is None, name
    with timing.span("stage"):
        pass
    assert reader("stage_s.round").read({}) >= 0


@pytest.mark.parametrize("name,metrics", [
    ("mamba2-train-8x1024", set(STEP_READERS)),
    ("cnn-fixed40", {"draw_host_ms.round", "stage_s.round"})])
def test_a_small_traced_run_on_the_cpu_reports_the_span_metrics(name, metrics):
    """The program's spans from a traced CPU run (no graph to capture on
    the CPU: ``capture_s.round`` is read on the card alone)."""
    timing.clear_spans()
    c = small(name)
    out = bench.driver(c.traffic["kind"]).run(c, 2**31 + 21, 0.3, True, time.perf_counter(),
                                              device="cpu")
    got = bench.read_metrics(c, out["run"])
    assert metrics <= set(got) and "capture_s.round" not in got
    assert all(got[m]["value"] > 0 for m in metrics)
    if name.startswith("mamba2"):
        steps = out["run"]["window"]["steps"]
        tops = [s for s in timing.spans() if s.name == "train_step"]
        window = [s for s in tops if 3 <= s.attrs["step"] < 3 + steps]
        assert len(window) == steps

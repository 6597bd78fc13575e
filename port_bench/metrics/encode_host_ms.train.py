"""Host milliseconds of a train step's ``train_step.encode`` span: the per-
leaf clip, encode, SecAgg sum and decode (``encode_aggregate_decode``),
the median over the window's steps. From the program's span log: the
host's time from the phase's entry to its return, which the device's
work may outlast, with any wait for the device inside it."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import program_spans  # noqa: E402


def read(run, log=None):
    return program_spans.step_phase_ms(run, "train_step.encode", log)

"""Seconds of staging the population on the device: the ``stage`` span
(``staging.stage_full`` in the trainer's set-up). From the program's
span log."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import program_spans  # noqa: E402


def read(run, log=None):
    span = program_spans.last("stage", log)
    return None if span is None else program_spans.seconds(span)

"""Seconds of the round's capture: the ``graph_capture`` span (the warm-up
rounds on a side stream, which set cuBLAS and cuDNN up, and the CUDA
graph's capture) less the ``kernels.build`` spans inside it (nvcc, which
runs only where the checkout holds no built library). From the program's
span log."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import program_spans  # noqa: E402


def read(run, log=None):
    log = program_spans.records(log)
    span = program_spans.last("graph_capture", log)
    return None if span is None else program_spans.self_seconds(span, log, "kernels.build")

"""Device milliseconds a round in kernels outside the program's four CUDA
libraries (``port_kernels.json``): the client gradients' convolutions,
products and elementwise work, with the cohort's gather, the clip and,
on the materialized path, the SecAgg sum's reduction and the decode's
elementwise ops. From the profiled stretch."""
import json
from pathlib import Path

NAMES = json.loads((Path(__file__).parent / "port_kernels.json").read_text())


def read(run):
    trace, rounds = run.get("trace"), run.get("profiled_rounds")
    if not trace or not rounds:
        return None
    ours = [n for k in ("encode", "round_sum", "decode_apply", "pack") for n in NAMES[k]]
    rest = [(n, s, e) for n, s, e in trace["kernels"]
            if not any(x in n for x in ours + NAMES["not_kernels"])]
    if not rest:
        return None
    return sum(e - s for _, s, e in rest) / 1e3 / rounds

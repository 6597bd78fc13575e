"""The materialized encode's share of its roofline: the least time of
encoding each round's slate (``yardstick.encode_bound_s``: 4 bytes in and
4 out an element, or its needed draws' integer operations) over the
device time of the encode kernels in the profiled stretch."""
import json
import sys
from pathlib import Path

HERE = Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
import yardstick  # noqa: E402

NAMES = json.loads((HERE / "port_kernels.json").read_text())


def read(run):
    trace, rounds = run.get("trace"), run.get("profiled_rounds")
    if not trace or not rounds:
        return None
    took = sum(e - s for n, s, e in trace["kernels"]
               if any(x in n for x in NAMES["encode"])) / 1e6
    if took <= 0:
        return None
    return yardstick.share(rounds * yardstick.encode_bound_s(run["slate"] * run["dim"]), took)

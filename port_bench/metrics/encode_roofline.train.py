"""The per-leaf encode's share of its roofline in a train step: the least
time of encoding every leaf (``yardstick.encode_bound_s``) over the device
time of the encode kernels, both over the profiled steps."""
import json
import sys
from pathlib import Path

HERE = Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
import yardstick  # noqa: E402

NAMES = json.loads((HERE / "port_kernels.json").read_text())


def read(run):
    trace, steps = run.get("trace"), run.get("profiled_steps")
    if not trace or not steps:
        return None
    took = sum(e - s for n, s, e in trace["kernels"]
               if any(x in n for x in NAMES["encode"])) / 1e6
    if took <= 0:
        return None
    least = steps * sum(yardstick.encode_bound_s(n) for n in run["leaf_sizes"])
    return yardstick.share(least, took)

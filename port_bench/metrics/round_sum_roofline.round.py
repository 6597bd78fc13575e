"""The fused encode-and-sum's share of its roofline: the least time of
summing each round's taking clients (``yardstick.round_sum_bound_s`` at
the realized count, dense or packed at the run's wire width) over the
device time of the fused round-sum kernels in the profiled stretch. Slots
that take no part are work the layer does not need."""
import json
import sys
from pathlib import Path

HERE = Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
import yardstick  # noqa: E402

NAMES = json.loads((HERE / "port_kernels.json").read_text())


def read(run):
    trace, realized = run.get("trace"), run.get("profiled_realized")
    if not trace or not realized:
        return None
    took = sum(e - s for n, s, e in trace["kernels"]
               if any(x in n for x in NAMES["round_sum"])) / 1e6
    if took <= 0:
        return None
    least = sum(yardstick.round_sum_bound_s(n, run["dim"], run["pack_bits"]) for n in realized)
    return yardstick.share(least, took)

"""The whole round's share of the H100's dense bfloat16 peak: the CNN's
model FLOPs (3 x the forward's, from the layer shapes) of every sample of
the clients the window's rounds realized, over the window's time. Slots
of a slate that take no part are work the round does not need, and are
not counted."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
import yardstick  # noqa: E402


def read(run):
    w = run.get("window", {})
    if not w.get("realized") or w["seconds"] <= 0:
        return None
    c = run["config"]
    per_client = 3 * yardstick.cnn_flops_per_sample(
        tuple(c["conv_channels"]), c["hidden_size"], c["num_classes"]) * c["samples_per_client"]
    return 100.0 * per_client * w["realized"] / w["seconds"] / yardstick.PEAK_BF16_FLOPS

"""The whole train step's share of the H100's dense bfloat16 peak: 6 N
FLOPs a token, N from the configuration's widths
(``yardstick.mamba2_params``), at the window's rate of tokens."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
import yardstick  # noqa: E402


def read(run):
    w = run.get("window", {})
    if not w.get("steps") or w["seconds"] <= 0:
        return None
    flops = yardstick.train_flops(yardstick.mamba2_params(run["config"]),
                                  run["tokens_per_step"]) * w["steps"]
    return 100.0 * flops / w["seconds"] / yardstick.PEAK_BF16_FLOPS

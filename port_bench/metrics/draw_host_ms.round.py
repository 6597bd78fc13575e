"""Host milliseconds a round of drawing the cohorts: the window's
``round_block.draw`` spans (``cohort.draw_block`` and
``realized_counts``, once a block) summed, over the window's rounds.
From the program's span log."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import program_spans  # noqa: E402


def read(run, log=None):
    draws = program_spans.window_blocks(run, "round_block.draw",
                                        program_spans.records(log))
    if not draws:
        return None
    return 1e3 * sum(program_spans.seconds(s) for s in draws) / run["window"]["rounds"]

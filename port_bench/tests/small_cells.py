"""Cells of the benchmark cut to a size a CPU test holds: the same files
and code paths, fewer clients, rounds, layers and tokens."""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import bench  # noqa: E402

SMALL_MAMBA2 = dict(reduced=True, d_model=256, n_layer=2, vocab_size=512, d_state=32,
                    headdim=32, chunk_size=32, published={"chunk_size": 16})


def small(name: str) -> "bench.Cell":
    c = bench.cell(name)
    if c.traffic["kind"] == "fl_rounds":
        c.config = dict(c.config, num_clients=60, eval_size=10)
        c.traffic = dict(c.traffic, cohort=4, block=16, profiled_blocks=1)
    else:
        c.config = dict(c.config, **SMALL_MAMBA2)
        c.traffic = dict(c.traffic, batch=2, seq_len=64, batches=4, profiled_steps=1)
    return c

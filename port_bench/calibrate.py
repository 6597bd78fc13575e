"""The readings a cell's limits are set from: the program's sound first
steps, the control (the reference put in the program's place at the
precision below the configuration's: TF32 for float32 with TF32 off)
and the planted faults (``half_batch``: half of the batch left out, the
mean taken over the rest, in the reference put in the program's place;
``stale_row``, FL rounds only: the program's rounds past a block's second
reading that round's draws, a wrong row index), at the cell's own size,
one JSON line a seed and kind. A step that returns its state unchanged
needs no run: its change reads 1 against the reference's by
``bench.leaf_gaps``.

    python port_bench/calibrate.py --workload cnn-fixed40 --seeds 11 12 13 \\
        --kinds sound control half_batch
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

PLANTS = {"control": {"tf32": True}, "half_batch": {"half_batch": True}}


@contextlib.contextmanager
def stale_row():
    """The scan engine's rounds past a block's second read its row."""
    from repro_torch.fed import engines

    real = engines.ScanEngine.round_at
    engines.ScanEngine.round_at = lambda self, flat, opt, t: real(self, flat, opt, t.clamp(max=1))
    try:
        yield
    finally:
        engines.ScanEngine.round_at = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=["sound", "control", "half_batch"],
                    choices=["sound", "stale_row", *PLANTS])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import bench

    cell = bench.cell(args.workload)
    drv = bench.driver(cell.traffic["kind"])
    for seed in args.seeds:
        for kind in args.kinds:
            t = time.perf_counter()
            if kind == "sound":
                got = drv.sound(cell, seed, args.device)
            elif kind == "stale_row":
                with stale_row():
                    got = drv.sound(cell, seed, args.device)
            else:
                got = drv.planted(cell, seed, args.device, **PLANTS[kind])
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "readings": got, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

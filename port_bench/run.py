"""Run one cell of the port's benchmark once.

    python port_bench/run.py --workload cnn-fixed40 --seed 7 --seconds 10 --trace 0

From the root of a checkout that holds the program (``src/repro_torch``)
on a machine with the cards the cell asks for. Set-up builds the cell's
system from ``--seed``, drives it through its first steps (which the
reference follows afterwards) and warms every shape up; then the window
runs at least ``--seconds`` seconds and ends when its last work is done.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch after the window. Then the
program's state is freed and the plain reference recomputes the first
steps: the compared numbers go to standard error beside their limits,
and the result is standard output's last line.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def environment() -> None:
    """Caches inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["REPRO_PRIVACY_CACHE"] = str(ROOT / "build" / "privacy" / "epsilons.json")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    sys.path.insert(0, str(HERE))
    import bench

    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("no program here: src/repro_torch is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    drv = bench.driver(cell.traffic["kind"])
    out = drv.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  started=STARTED)
    found = bench.forbidden_modules()
    if found:
        print(f"modules of {found} were loaded in the run", file=sys.stderr)
        return 3
    correct, rows = bench.verdict(out["readings"], cell.limits)
    print(f"run {args.workload} seed {args.seed}: setup {out['metrics']['setup_s']:.3f} s, "
          f"reference {out['reference_s']:.3f} s, process {time.perf_counter() - STARTED:.3f} s; "
          f"set-up phases (s from start): {out['phases']}", file=sys.stderr)
    if args.trace:
        metrics = bench.read_metrics(cell, out["run"])
        device = dict(out["device"], busy_s=out["run"]["trace"]["busy_s"],
                      window_s=out["run"]["trace"]["window_s"])
        breakdown = out["run"]["trace"]["breakdown"]
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        device, breakdown = out["device"], None
    return bench.finish(correct, rows, out["attempted"], out["failed"], metrics, device,
                        breakdown)


if __name__ == "__main__":
    sys.exit(main())

"""Graphed rounds/s and device time per round of the port's CNN round and
lm round, for one source tree, on one CUDA card.

    git archive <rev> | tar -x -C build/parent
    python scripts/torch_round_rate.py --src build/parent/src --tag parent
    python scripts/torch_round_rate.py --tag tree

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this tree's). Two rounds, as ``chip_smoke.py`` runs them: the CNN's
default rqm round (phase 5c: ``FedConfig()``, cohort 40 at 222,030
coordinates) and the lm task's mamba2-370m round (phase 5h: reduced
config, seq_len 64, batch 2, a cohort of 40 from 200 clients, fused
packed, 1,096,032 coordinates), both on the graphed ``scan`` engine
without kept sums. Each is timed over 5 blocks of 20 rounds under
``torch.cuda.set_sync_debug_mode("error")`` (median, min, max), then
profiled with torch.profiler over 3 rounds: device busy ms per round, its
share of the wall time, and the six kernels that take most of it. The
parameters' float32 bits are hashed after the same rounds, so two trees'
runs can be held equal. Then the full-width mamba2-370m's flat gradient
(419,763,712 parameters, ``torch.func.grad_and_value`` of the loss of one
client at seq_len 64, batch 2, as ``chip_smoke.py`` phase 5h (b) takes
it) over two token batches, the first with its warm-up: ms (CUDA events)
and the peak bytes above what was allocated before. One JSON line per
measurement goes to standard output.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RQM = "rqm:c=0.02,m=16,q=0.42"
BLOCK, REPS, PROFILE_ROUNDS = 20, 5, 3


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def clock(torch, tr) -> dict:
    tr.run_block(1)  # capture
    each = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tr.run_block(BLOCK)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        each.append(BLOCK / (time.perf_counter() - t0))
    return {"median": statistics.median(each), "min": min(each), "max": max(each),
            "each": each}


def profile(torch, tr) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_ROUNDS):
            tr.round()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # not the record_function ranges (the port's spans): each range around
    # kernels is also a device-side event that holds all of their time
    avgs = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
    return {"device_busy_ms_per_round": busy_ms / PROFILE_ROUNDS,
            "device_busy_share": busy_ms / wall_ms,
            "top_kernels_ms_per_round": {e.key[:90]: e.self_device_time_total / 1e3
                                         / PROFILE_ROUNDS for e in avgs[:6]}}


def full_width(torch) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import ravel
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.eval.lm_eval import batch_to
    from repro_torch.models import model
    from repro_torch.models.common import ParallelCtx

    cfg = get_config("mamba2-370m")
    flat, unravel = ravel(model.init_params(torch.Generator().manual_seed(0), cfg,
                                            device="cuda"))
    pipe = TokenPipeline(cfg, 64, 2, seed=0, branch=4)
    # trees before the float32-only loss_fn took its compute dtype and remat
    kw = ({"compute_dtype": torch.float32, "remat": False}
          if "compute_dtype" in inspect.signature(model.loss_fn).parameters else {})
    grad_and_loss = torch.func.grad_and_value(
        lambda f, b: model.loss_fn(unravel(f), cfg, ParallelCtx(), b, **kw)[0])
    ms, peak_above, losses = [], [], []
    for i in range(2):
        batch = batch_to(pipe.batch(i), "cuda")
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g, value = grad_and_loss(flat, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        peak_above.append(torch.cuda.max_memory_allocated() - before)
        losses.append(float(value))
        digest = hashlib.sha256(g.cpu().numpy().tobytes()).hexdigest()[:16]
        del g
    return {"dim": flat.numel(), "grad_ms": ms, "peak_above_bytes": peak_above,
            "loss": losses, "last_grad_sha256_16": digest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("torch_round_rate: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.fed.config import FedConfig
    from repro_torch.fed.trainer import FedTrainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    name = card()
    rounds = {
        "cnn": FedConfig(collect_sums=False, scan_block=BLOCK),
        "lm mamba2-370m": FedConfig(task="lm:model=mamba2-370m", num_clients=200,
                                    fused_rounds=True, collect_sums=False, scan_block=BLOCK),
    }
    for what, cfg in rounds.items():
        tr = FedTrainer(RQM, cfg, device="cuda")
        rate = clock(torch, tr)
        prof = profile(torch, tr)
        digest = hashlib.sha256(tr.flat.cpu().numpy().tobytes()).hexdigest()[:16]
        print(json.dumps({"tag": args.tag, "round": what, "src": args.src,
                          "dim": tr.flat.numel(), "rounds_per_s": rate, **prof,
                          "rounds_run": 1 + REPS * BLOCK + PROFILE_ROUNDS,
                          "flat_sha256_16": digest, "nvidia_smi": name}), flush=True)
        del tr
    print(json.dumps({"tag": args.tag, "round": "full-width gradient", "src": args.src,
                      **full_width(torch), "nvidia_smi": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

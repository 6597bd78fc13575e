#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one GPU, end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card
(the kernels are built for sm_90a) and nvcc. Phases, any failure of
which raises and exits non-zero:

  1. environment: torch, CUDA, the card's name and power limit;
  2. build: nvcc compiles src/repro_torch/kernels/csrc into build/cuda;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the main path's shapes (a cohort of 40 rows, the CNN's
     222,030 coordinates, 10-bit fields, 74,010 packed words): results
     bit-exact; device times from torch.profiler, whole-call times by
     CUDA events, and the least time the card could take (its bound),
     each printed as one JSON line after phase 4 with its launches;
  4. main path: 5 rounds of the paper's EMNIST configuration through
     FedTrainer on the card, checked by the kernels' launch counters, the
     accountant and finite parameters; then the same 5 rounds with the
     dense (unpacked) wire, which must give identical parameters;
  5. profile: device time by kernel over 3 more packed rounds (table in
     build/round_profile.txt).

The second-last lines are one JSON object of per-kernel measurements and
the card's name and power limit; the last line is the run's result.
Exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# deterministic cuBLAS, so the packed and dense runs compute identical
# gradients; must be set before CUDA is initialised
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROWS, DIM, BITS = 40, 222_030, 10  # cohort, flat CNN dimension, sum field width
MECH_SPEC = "rqm:c=0.02,m=16,q=0.42"
ROUNDS = 5
KERNEL_REPS = 30
PLAIN_REPS = 5

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM3; 67 TFLOP/s of
# float32 outside the tensor cores = 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz.
# Integer work is bounded by instruction issue: each of an SM's 4
# schedulers issues one 32-lane instruction per clock, and the shifts,
# xors and compares (ALU pipe) and the multiplies and adds (IMAD, which
# can also do the right shifts) run on separate pipes, so no single
# 64-lane pipe binds tighter than issue.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 4 * 32 * 1.98e9
# integer operations counted per needed splitmix32 draw: the add of the
# stream salt and mix32's first two rounds (a shift, a xor and a multiply
# each). Not counted, so the bound stays below the least time: mix32's
# last shift-xor (it leaves the top 16 bits as they are, and they decide
# u < q but for 1 draw in 65,536), the compare, and every per-element
# step (clip, the two IEEE divisions, the level arithmetic, the sum).
INT_OPS_PER_DRAW = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int, kernel: str):
    """Mean device time per call of the kernel whose name contains
    ``kernel``, from torch.profiler's CUDA trace over ``reps`` calls; None
    when the trace holds no device time for it. Unlike CUDA events around
    each call, this leaves out the wrapper's host time, which is longer
    than the short elementwise kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages() if kernel in e.key)
    return total_us / reps / 1e3 if total_us else None


def bound(nbytes: int, int_ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def needed_draws(torch, x, seed: int, params) -> int:
    """splitmix32 draws that the RQM encode of this (rows, dim) x, at row
    offset 0, needs: from each element's bin j, the interior levels down
    (j, j-1, .., 1) and up (j+1, .., m-2) only as far as the nearest kept
    level on each side, and the rounding draw unless p_up is 0 or 1. The
    kernels draw all m-2 keep streams: that is their algorithm, not work
    the function needs."""
    from repro_torch.kernels.rqm_kernel import rqm_bracket

    m = params.m
    rows, dim = x.shape
    cols = torch.arange(dim, dtype=torch.int64, device=x.device)
    total = 0
    for r in range(rows):
        j, i_lo, i_hi, p_up = rqm_bracket(x[r], seed, r * dim + cols, params)
        down = torch.where(i_lo > 0, j - i_lo + 1, j)
        up = torch.where(i_hi < m - 1, i_hi - j, m - 2 - j)
        total += int((down + up).sum()) + int(((p_up > 0) & (p_up < 1)).sum())
    return total


def check_kernels(torch, np):
    """Phase 3: every kernel against its plain version at the main path's
    shapes. Returns one record per kernel, without its launches."""
    from repro_torch.core import wire
    from repro_torch.core.mechanisms import make_mechanism
    from repro_torch.kernels import decode_apply_kernel, fused_round_kernel, pack_kernel

    params = make_mechanism(MECH_SPEC).params
    rng = np.random.default_rng(2024)
    c = params.c
    x = torch.from_numpy(
        rng.uniform(-1.2 * c, 1.2 * c, size=(ROWS, DIM)).astype(np.float32)).cuda()
    w = torch.ones(ROWS, dtype=torch.int32, device="cuda")
    seed = int(rng.integers(0, 1 << 32))
    words = wire.packed_words(DIM, BITS)
    params_w = torch.from_numpy(rng.normal(0, 0.05, DIM).astype(np.float32)).cuda()
    n, lr = ROWS, 0.5
    draws = needed_draws(torch, x, seed, params)
    log(f"[kernels] needed draws {draws}: {draws / x.numel()} per element "
        f"(the kernels make {params.m - 1})")

    dense = fused_round_kernel.round_sum(x, w, seed, 0, params)
    packed = fused_round_kernel.round_sum_packed(x, w, seed, 0, params, BITS)
    cases = [
        dict(name="round_sum_dense", entry="rqm_round_sum_dense",
             symbol="round_sum_dense_kernel",
             source="src/repro_torch/kernels/csrc/round_sum.cu",
             replaces="src/repro/kernels/fused_round_kernel.py:101",
             kernel=lambda: fused_round_kernel.round_sum(x, w, seed, 0, params),
             plain=lambda: fused_round_kernel.round_sum_plain(x, w, seed, 0, params),
             nbytes=x.numel() * 4 + ROWS * 4 + DIM * 4, int_ops=draws * INT_OPS_PER_DRAW),
        dict(name="round_sum_packed", entry="rqm_round_sum_packed",
             symbol="round_sum_packed_kernel",
             source="src/repro_torch/kernels/csrc/round_sum.cu",
             replaces="src/repro/kernels/fused_round_kernel.py:227",
             kernel=lambda: fused_round_kernel.round_sum_packed(x, w, seed, 0, params, BITS),
             plain=lambda: fused_round_kernel.round_sum_packed_plain(
                 x, w, seed, 0, params, BITS),
             nbytes=x.numel() * 4 + ROWS * 4 + words * 4, int_ops=draws * INT_OPS_PER_DRAW),
        dict(name="decode_apply_sum", entry="decode_apply_sum",
             symbol="decode_apply_sum_kernel",
             source="src/repro_torch/kernels/csrc/decode_apply.cu",
             replaces="src/repro/kernels/decode_apply_kernel.py:103",
             kernel=lambda: decode_apply_kernel.decode_apply_sum(params_w, dense, params, n, lr),
             plain=lambda: decode_apply_kernel.decode_apply_plain(
                 params_w, dense, params, n, lr),
             nbytes=DIM * 12, int_ops=0),
        dict(name="unpack_decode_apply", entry="unpack_decode_apply",
             symbol="unpack_decode_apply_kernel",
             source="src/repro_torch/kernels/csrc/decode_apply.cu",
             replaces="src/repro/kernels/pack_kernel.py:138",
             kernel=lambda: pack_kernel.unpack_decode_apply(
                 params_w, packed, params, n, lr, pack_bits=BITS),
             plain=lambda: pack_kernel.unpack_decode_apply_plain(
                 params_w, packed, params, n, lr, pack_bits=BITS),
             nbytes=DIM * 8 + words * 4, int_ops=0),
    ]
    records = []
    for case in cases:
        got, want = case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{case['name']}: kernel differs from its plain version")
        if case["name"] == "round_sum_packed" and not torch.equal(got, wire.pack_bits(dense, BITS)):
            raise AssertionError("round_sum_packed differs from pack_bits(round_sum_dense)")
        err = float((got.double() - want.double()).abs().max())
        bound_ms, bound_by = bound(case["nbytes"], case["int_ops"])
        dev_ms = device_ms(torch, case["kernel"], KERNEL_REPS, case["symbol"])
        if dev_ms is None:
            raise AssertionError(
                f"{case['name']}: the profiler trace holds no device time "
                f"for {case['symbol']}")
        records.append({
            "name": case["name"], "route": "cuda", "source": case["source"],
            "replaces": case["replaces"], "entry": case["entry"],
            "max_abs_err": err,
            "ms": dev_ms,
            # the whole wrapper call, host side included, by CUDA events
            "call_ms": time_ms(torch, case["kernel"], KERNEL_REPS),
            "plain_ms": time_ms(torch, case["plain"], PLAIN_REPS),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the RQM encode + sum or the
            # decode-then-SGD association
            "library_ms": None,
        })
    return records


def profile_rounds(torch, tr, rounds: int) -> dict:
    """Device time by kernel over ``rounds`` more rounds of a warm
    trainer, from torch.profiler; the full table goes to
    build/round_profile.txt (git-ignored). The busy share is summed kernel time
    over the wall time, which the profiler itself inflates."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            tr.round()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    avgs.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "round_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {
        "rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
        "device_busy_ms_per_round": busy_ms / rounds,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "top_kernels_ms_per_round": {
            e.key[:90]: e.self_device_time_total / 1e3 / rounds for e in avgs[:8]},
    }


def run_main_path(torch, cfg, expect: dict) -> dict:
    """Phase 4: ROUNDS rounds through FedTrainer on the card, with the
    launch counters set to 0 just before and read just after."""
    from repro_torch.fed.trainer import FedTrainer
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    tr = FedTrainer(MECH_SPEC, cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    ops.reset_launches()
    t0 = time.perf_counter()
    tr.round()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for _ in range(ROUNDS - 1):
        tr.round()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t1
    counts = dict(ops.launches)

    if counts != expect:
        raise AssertionError(f"launch counts {counts}, expected {expect}")
    alpha = 8.0
    want = ROUNDS * tr.mech.per_round_epsilon(cfg.clients_per_round, alpha)
    got = tr.accountant.rdp_epsilon(alpha)
    if not math.isclose(got, want, rel_tol=1e-12):
        raise AssertionError(f"RDP at alpha=8 is {got}, expected {want}")
    if not bool(torch.isfinite(tr.flat).all()):
        raise AssertionError("parameters are not finite")
    metrics = tr.evaluate()
    rec = {
        "wire": "packed" if tr.pack_bits else "dense", "pack_bits": tr.pack_bits,
        "rounds": ROUNDS, "setup_s": setup_s, "first_round_s": first_s,
        "steady_rounds_per_s": (ROUNDS - 1) / steady_s, "launches": counts,
        "rdp_alpha8": got, "eval_accuracy": metrics["accuracy"],
        "eval_loss": metrics["loss"],
    }
    log(json.dumps(rec))
    return {"trainer": tr, "counts": counts}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.fed.config import FedConfig
    from repro_torch.kernels import _build

    # full float32 everywhere, and reproducible gradients
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    card = nvidia_smi()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {card}")
    log(f"[env] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.3f} s "
        f"({len(logs)} compiled) into {_build.BUILD_DIR}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    records = check_kernels(torch, np)

    cfg = FedConfig(num_clients=3400, clients_per_round=ROWS, samples_per_client=20,
                    lr=0.5, engine="perround", fused_rounds=True, wire_packed=None)
    packed = run_main_path(
        torch, cfg, {"rqm_round_sum_packed": ROUNDS, "unpack_decode_apply": ROUNDS})
    dense = run_main_path(
        torch, dataclasses.replace(cfg, wire_packed=False),
        {"rqm_round_sum_dense": ROUNDS, "decode_apply_sum": ROUNDS})
    if not torch.equal(packed["trainer"].flat, dense["trainer"].flat):
        raise AssertionError("packed and dense wire gave different parameters")
    log("[main] packed and dense runs: bit-identical parameters")
    # after the counted runs: where a warm packed round spends device time
    log(json.dumps({"round_profile": profile_rounds(torch, packed["trainer"], 3)}))

    counts = {**packed["counts"], **dense["counts"]}
    kernels = []
    for rec in records:
        # the dense kernels run in the wire_packed=False rerun
        launches = counts[rec.pop("entry")]
        log(json.dumps({**rec, "launches": launches,
                        "launches_per_round": launches / ROUNDS}))
        kernels.append({k: rec[k] for k in ("name", "route", "source", "replaces")}
                       | {"launches": launches}
                       | {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Parallel dry-run sweep of the port (counterpart of
scripts/run_dryrun_sweep.py): every (arch x shape x mesh), N worker
processes, on the meta device (no card needed).

Each combination runs in its own process (``python -m
repro_torch.launch.dryrun``: a fake default group of the mesh's world
size a process, and one failure sinks no other). Results land in
results/dryrun_torch/*.json; a summary is printed at the end. Usage:

    python scripts/run_dryrun_sweep_torch.py [--workers 5] [--single-pod-only]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = (
    "nemotron-4-15b", "gemma3-4b", "zamba2-1.2b", "mamba2-370m",
    "phi3.5-moe-42b-a6.6b", "musicgen-medium", "h2o-danube-3-4b",
    "qwen3-moe-30b-a3b", "pixtral-12b", "chatglm3-6b",
)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def artifact(arch, shape, mesh, out_dir):
    return os.path.join(ROOT, out_dir, f"{arch}_{shape}_{mesh}.json")


def run(job):
    arch, shape, multi_pod, out_dir = job
    mesh = "2x16x16" if multi_pod else "16x16"
    path = artifact(arch, shape, mesh, out_dir)
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skipped"):
            return (arch, shape, mesh, rec.get("status"), "cached")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out-dir", out_dir]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.time()
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=3600)
    dur = time.time() - t0
    status = "?"
    if os.path.exists(path):
        with open(path) as f:
            status = json.load(f).get("status", "?")
    elif "skipped" in p.stdout:
        status = "skipped"
    elif p.returncode != 0:
        status = f"CRASH rc={p.returncode}: {p.stderr[-300:]}"
    else:
        status = f"no-artifact: {p.stdout[-200:]}"
    print(f"[{dur:6.0f}s] {arch} x {shape} x {mesh}: {status}", flush=True)
    return (arch, shape, mesh, status, f"{dur:.0f}s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=5)
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    args = ap.parse_args()

    jobs = []
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)
    for mp in meshes:
        for arch in ARCHS:
            for shape in SHAPES:
                jobs.append((arch, shape, mp, args.out_dir))

    print(f"{len(jobs)} jobs, {args.workers} workers", flush=True)
    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        results = list(ex.map(run, jobs))
    ok = sum(1 for r in results if r[3] == "ok")
    sk = sum(1 for r in results if r[3] == "skipped")
    print(f"\nSUMMARY: {ok} ok, {sk} skipped, {len(results)-ok-sk} failed "
          f"of {len(results)}")
    for r in results:
        if r[3] not in ("ok", "skipped"):
            print("FAILED:", r)


if __name__ == "__main__":
    main()

"""What every cell's run shares: the manifest and the files a cell is
made of, the profiler's reading, the comparison's numbers, the module
check and the result line.

A cell ``W`` of ``BENCHMARK.json`` names a configuration (its ``file``)
and a traffic mix, ``traffic/<traffic>.json``, whose ``kind`` names the
driver, ``drivers/<kind>.py``. The cell's limits are in
``cells/<W>.json``. A per-layer metric ``M`` is read by
``metrics/<M>.py``'s ``read(run)``, which returns a number or None; a
quantity split by the cells' end-to-end metrics (``M`` = ``Q.round``,
``Q.train``) whose reading is the same may share ``metrics/<Q>.py``. Each
is found by its name, so a cell, a configuration, a traffic mix or a
metric is added by adding files.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the manifest's entries this cell reports
    per_layer: list


def reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """Whether a per-layer metric is read in this cell: one of its
    ``workloads``, or, without that key, a cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_names


def cell(name: str, manifest: dict | None = None) -> Cell:
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]), config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(HERE / "cells" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer)


def driver(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py", f"port_bench_driver_{kind}")


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or the shared ``metrics/<Q>.py`` of a name
    ``Q.<part>`` that has no file of its own."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def read_metrics(c: Cell, run: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in c.per_layer:
        reader = load_module(reader_path(m["name"]),
                             "port_bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's, JAX's or
    Flax's, compared whole."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


# -- the device ---------------------------------------------------------------

def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def tf32(torch, on: bool) -> None:
    """TF32 in cuBLAS's and cuDNN's float32 products on or off. The
    configurations state it off; cuDNN's own default is on, so every path
    that runs the program sets it first."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def peak_bytes(torch, device) -> int:
    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0


def free(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def device_info(torch, device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


# -- the profiler ------------------------------------------------------------

def summarize(prof, t0_us: float, t1_us: float) -> dict:
    """Device intervals and host spans of a profiled stretch [t0, t1]
    (microseconds on the profiler's clock): ``kernels`` as (name, start,
    end), the device's busy seconds (their union), the window's seconds,
    the operations that took most device time and the longest idle gaps
    by the host operation under them."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name != "bench.stretch":
                kernels.append((e.name, start, end))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, start, end))
    kernels.sort(key=lambda k: k[1])
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for _, s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if kernels and t0_us is not None:
        gaps = [(t0_us, kernels[0][1])] + gaps + [(cur_e, t1_us)]
    by_op: dict = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        mid = (g0 + g1) / 2
        under = [h for h in host if h[1] <= mid <= h[2]]
        label = max(under, key=lambda h: h[1])[0] if under else "no host operation"
        if label == "bench.stretch":
            label = "python between operations"
        by_op[label] = by_op.get(label, 0.0) + max(0.0, g1 - g0) / 1e6
    ops: dict = {}
    for name, s, e in kernels:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    window = (t1_us - t0_us) / 1e6 if t0_us is not None else None
    return {"kernels": kernels, "busy_s": busy / 1e6, "window_s": window,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in
                                        sorted(by_op.items(), key=lambda kv: -kv[1])[:10]]}}


def profiled(torch, fn, labels_fn, device="cuda") -> dict:
    """Two profiled stretches after the window. ``fn`` under the device's
    activity alone (so that the profiler adds no host work between its
    launches): its kernels, the device's busy seconds and the stretch's
    seconds on the host clock, from an idle device to the end of its
    work. ``labels_fn`` under host and device activity: which host
    operation was running in each of the device's idle gaps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync(torch, device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, device)
        wall = time.perf_counter() - t0
    out = summarize(prof, None, None)
    out["window_s"] = wall
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function("bench.stretch"):
            labels_fn()
            sync(torch, device)
    from torch.autograd import DeviceType

    stretch = [e for e in prof.events()
               if e.name == "bench.stretch" and e.device_type == DeviceType.CPU]
    t0, t1 = stretch[0].time_range.start, stretch[0].time_range.end
    out["breakdown"]["idle_gaps"] = summarize(prof, t0, t1)["breakdown"]["idle_gaps"]
    return out


def host_seconds(torch, device, call, times: int) -> float:
    """Host seconds of ``times`` calls of ``call``, each from an idle
    device (synchronised before it) to the call's return: the host's own
    work, with no wait behind earlier work queued on the device."""
    total = 0.0
    for _ in range(times):
        sync(torch, device)
        t = time.perf_counter()
        call()
        total += time.perf_counter() - t
    sync(torch, device)
    return total


# -- the comparison -----------------------------------------------------------

def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap between the norms of two trees of tensors (the
    program's and the reference's), over the larger of the reference
    leaf's norm and the median leaf's."""
    norms = {k: (float(prog[k].double().norm()), float(ref[k].double().norm())) for k in ref}
    median = statistics.median(r for _, r in norms.values())
    return {k: abs(a - b) / max(b, median, 1e-30) for k, (a, b) in norms.items()}


def worst_leaf_gap(prog: dict, ref: dict) -> tuple:
    """(the largest of ``leaf_gaps``, its leaf)."""
    gaps = leaf_gaps(prog, ref)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median_leaf_gap(prog: dict, ref: dict) -> float:
    """The median of ``leaf_gaps``."""
    return statistics.median(leaf_gaps(prog, ref).values())


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number that has a limit at
    or under it. A reading without a limit is shown, not compared."""
    missing = sorted(set(limits) - set(readings))
    if missing:
        raise SystemExit(f"no reading for the limits {missing}")
    rows = [(k, float(readings[k]), float(limits[k])) for k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows


def finish(correct: bool, rows, attempted: int, failed: int, metrics: dict, device: dict,
           breakdown: dict | None = None) -> int:
    """Print the compared numbers beside their limits (standard error's
    last lines) and the result line (standard output's last line); exit
    code 0."""
    for name, value, limit in rows:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

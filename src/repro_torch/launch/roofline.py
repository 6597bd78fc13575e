"""Roofline report (counterpart of ``benchmarks/roofline.py``, outside any
benchmark folder): aggregates the dry run's ``results/dryrun_torch/*.json``
into tables (per arch x shape x mesh: the three terms on the H100,
the dominant one, MODEL_FLOPS over counted FLOPs, the analytical memory
and its fit), plus the analytic fused-round traffic model showing why
the fused round sum is the memory-side win the dry run's tables cannot
see. Run from the repository root:

    PYTHONPATH=src python -m repro_torch.launch.roofline
"""
from __future__ import annotations

import glob
import json
import os
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ROUND_SUM_CU = Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "round_sum.cu"

# representative (cohort rows, model dim) round shapes: the paper's
# Fig-2 cohort on the small CNN, a stream-staged shard slice, and the
# async-engine target scale the fused path exists to unlock
FUSED_ROUND_SHAPES = ((40, 222_030), (256, 222_030), (4096, 1_000_000))


def block_partial_bytes() -> int:
    """The fused sum's transient on the card: one block's partial sums in
    shared memory at most, ``kTile`` words x ``kMaxBlock / kTile`` slots
    of uint32 (the constants of ``csrc/round_sum.cu``)."""
    text = ROUND_SUM_CU.read_text()
    tile = int(re.search(r"constexpr int kTile = (\d+);", text).group(1))
    max_block = int(re.search(r"constexpr int kMaxBlock = (\d+);", text).group(1))
    return 4 * tile * (max_block // tile)


def fused_round_traffic(cohort: int, dim: int, bytes_in: int = 4) -> dict:
    """Analytic device-memory traffic + peak transient bytes for one
    round's encode-and-sum, materialized vs fused
    (kernels/fused_round_kernel.py).

    Materialized: read x, write the (cohort, dim) int32 encoded batch,
    read it back for the reduce, write the (dim,) sum: the batch crosses
    device memory twice and IS the peak transient. Fused: read x, write
    the sum; the only transient is one block's partial sums plus the
    int32 sum, independent of the cohort.
    """
    batch = cohort * dim * 4
    x_bytes = cohort * dim * bytes_in
    sum_bytes = dim * 4
    return {
        "materialized": {"hbm_bytes": x_bytes + 2 * batch + sum_bytes,
                         "peak_transient_bytes": batch},
        "fused": {"hbm_bytes": x_bytes + sum_bytes,
                  "peak_transient_bytes": block_partial_bytes() + sum_bytes},
    }


def fused_round_table(csv=print):
    csv("fused_round,cohort,dim,hbm_ratio,materialized_peak_mib,fused_peak_mib")
    rows = []
    for cohort, dim in FUSED_ROUND_SHAPES:
        t = fused_round_traffic(cohort, dim)
        ratio = t["materialized"]["hbm_bytes"] / t["fused"]["hbm_bytes"]
        csv(f"fused_round,{cohort},{dim},{ratio:.2f}x,"
            f"{t['materialized']['peak_transient_bytes']/2**20:.1f},"
            f"{t['fused']['peak_transient_bytes']/2**20:.3f}")
        rows.append({"cohort": cohort, "dim": dim, **t})
    return rows


def load(out_dir="results/dryrun_torch", tag=None):
    recs = []
    for path in sorted(glob.glob(os.path.join(ROOT, out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if tag is None and r.get("tag"):
            continue
        if tag is not None and r.get("tag") != tag:
            continue
        recs.append(r)
    return recs


def fmt_ms(s):
    return f"{s*1e3:.2f}"


def table(recs, csv=print):
    hdr = ("arch,shape,mesh,status,compute_ms,memory_ms,collective_ms,"
           "dominant,useful_flops_ratio,hbm_gib,fits")
    csv(hdr)
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] != "ok":
            csv(f"{r['arch']},{r['shape']},{r['mesh']},{r['status']},,,,,,,")
            continue
        t = r["roofline"]
        mem = r["memory"]["analytical"]["total"] / 2**30
        ufr = r.get("useful_flops_ratio")
        csv(f"{r['arch']},{r['shape']},{r['mesh']},ok,"
            f"{fmt_ms(t['compute_s'])},{fmt_ms(t['memory_s'])},"
            f"{fmt_ms(t['collective_s'])},{t['dominant']},"
            f"{ufr:.3f},{mem:.2f},{r['memory']['fits']}")


def markdown(recs):
    lines = [
        "| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) "
        "| dominant | useful FLOPs | HBM (GiB) | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"N/A (skip) | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | | | | | | |")
            continue
        t = r["roofline"]
        mem = r["memory"]["analytical"]["total"] / 2**30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt_ms(t['compute_s'])} | {fmt_ms(t['memory_s'])} | "
            f"{fmt_ms(t['collective_s'])} | **{t['dominant']}** | "
            f"{r.get('useful_flops_ratio') or 0:.2f} | {mem:.2f} | "
            f"{'yes' if r['memory']['fits'] else 'NO'} |")
    return "\n".join(lines)


def run(csv=print):
    fused_round_table(csv=csv)
    recs = load()
    if not recs:
        csv("roofline,0,no dryrun artifacts yet (run scripts/run_dryrun_sweep_torch.py)")
        return []
    ok = [r for r in recs if r["status"] == "ok"]
    csv(f"roofline_artifacts,{len(recs)},ok={len(ok)};"
        f"skipped={sum(1 for r in recs if r['status']=='skipped')};"
        f"errors={sum(1 for r in recs if r['status']=='error')}")
    table(recs, csv=csv)
    return recs


if __name__ == "__main__":
    run()

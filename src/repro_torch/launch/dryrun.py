"""Multi-pod dry run on the meta device (counterpart of
``repro/launch/dryrun.py``): show that every (architecture x input shape
x mesh) step builds and runs to its end, count its work, and derive the
roofline terms on the H100. No card is needed:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k [--multi-pod] [--packed] ...

Per combination one process plays rank 0 of the mesh:
  1. a default group of the mesh's world size (256 for 16x16, 512 for
     2x16x16) on PyTorch's fake backend (``launch/mesh.py:fake_world``),
     and the plan over it (``distributed/step.py:make_plan``);
  2. the train, prefill or decode step on that plan
     (``distributed/step.py``), at the reference's ``build_step``
     defaults: rqm at c=0.01, sgd at a constant rate of 0.5, remat on,
     bfloat16 compute;
  3. one call of the step on meta tensors of the rank's shapes (nothing
     allocated) under ``launch/hlo_analysis.py``'s counters: FLOPs,
     bytes (the hand-written kernels' traffic included), the peak of the
     live storages, and every collective;
  4. the three roofline terms against ``launch/mesh.py:H100``, the
     analytical memory model (``launch/memory_model.py``; ``fits`` against
     the card's memory, or the H100's without a card), written as JSON
     under results/dryrun_torch/.

Where the reference reports XLA's ``memory_analysis`` (``xla_cpu_*``),
the record holds the meta run's ``meta_argument_bytes``,
``meta_output_bytes`` and ``meta_peak_bytes``; ``build_s``/``run_s``
replace ``lower_s``/``compile_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.distributed.step import (
    batch_structs,
    make_decode_step,
    make_plan,
    make_prefill_step,
    make_train_step,
    train_seeds,
)
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import H100, fake_world
from repro_torch.models import meta as meta_lib
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import constant

SKIP_LONG_CONTEXT_REASON = (
    "full-attention architecture: long_500k requires sub-quadratic attention "
    "(DESIGN.md §Arch-applicability)"
)
# the reference's production meshes (repro/launch/mesh.py:41-45)
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}


def supports(arch_cfg, shape) -> tuple[bool, str]:
    if shape.name == "long_500k" and not arch_cfg.subquadratic:
        return False, SKIP_LONG_CONTEXT_REASON
    return True, ""


def cut_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` blocks, its widths kept: the first block
    of each kind it has (a hybrid's shared attention among them), then
    its first blocks, in their order."""
    first = {}
    for i, block in enumerate(cfg.layers):
        first.setdefault(block.kind, i)
    keep = set(first.values())
    rest = [i for i in range(len(cfg.layers)) if i not in keep]
    keep |= set(rest[:max(0, layers - len(keep))])
    blocks = tuple(cfg.layers[i] for i in sorted(keep))
    return dataclasses.replace(cfg, num_layers=len(blocks), layers=blocks)


def _local(meta_tree, plan):
    """The rank's leaves of ``meta_tree`` as meta tensors."""
    return meta_lib.shape_dtype_structs(meta_tree, plan.tp, plan.n_clients)


def build_step(cfg, plan, shape, *, mechanism="rqm", packed=False,
               q_chunk=None, remat=True, seq_parallel=None,
               sp_compress=False, agg_dtype="int32", zero1=False,
               kv_quant=False, ssm_chunk=None, compute_dtype=torch.bfloat16,
               device="meta"):
    """Returns ``(fn, example_args)``: the step of this rank of ``plan``
    and its arguments as meta tensors of the rank's shapes (parameters,
    optimizer state and caches at ``meta.local_shape``; the global batch,
    whose rows the step takes; the step's per-leaf int seeds).
    ``compute_dtype`` and ``device`` (where the step's constants, the
    rate, live) let the same step run on a card's tensors."""
    if q_chunk is not None:
        cfg = dataclasses.replace(cfg, q_chunk=q_chunk)
    if ssm_chunk is not None and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    if shape.kind == "train":
        mech = make_mechanism(mechanism, c=0.01)
        opt = make_optimizer("sgd")
        # the rate made here, once, as the reference's constant is a
        # literal of its compiled step: the step copies nothing to the device
        rate = constant(0.5, device=device)(0)
        fn, specs = make_train_step(
            cfg, plan, mech, opt, lambda step: rate, shape, packed=packed,
            remat=remat, seq_parallel=seq_parallel, sp_compress=sp_compress,
            agg_dtype=agg_dtype, zero1=zero1, compute_dtype=compute_dtype,
        )
        params = _local(specs["param_meta"], plan)
        opt_state = _local(specs["opt_meta"], plan) if specs["opt_meta"] else ()
        seeds = train_seeds(0, 0, specs["ctx"].client_index, len(specs["shard_seeds"]),
                            specs["shard_seeds"])
        return fn, (params, opt_state, 0, batch_structs(cfg, shape), seeds)
    if shape.kind == "prefill":
        fn, specs = make_prefill_step(
            cfg, plan, shape, compute_dtype=compute_dtype,
            seq_parallel=bool(seq_parallel), sp_compress=sp_compress,
        )
        params = _local(specs["param_meta"], plan)
        rows = specs["token_rows"]
        b = rows.stop - rows.start
        pfx = cfg.frontend.prefix_len if cfg.frontend else 0
        toks = torch.empty((b, shape.seq_len - pfx), dtype=torch.int32, device="meta")
        if cfg.frontend is not None:
            pe = torch.empty((b, pfx, cfg.d_model), dtype=torch.bfloat16, device="meta")
            return fn, (params, toks, pe)
        return fn, (params, toks)
    # decode, at the cache's last position
    fn, specs = make_decode_step(cfg, plan, shape, kv_quant=kv_quant,
                                 compute_dtype=compute_dtype)
    params = _local(specs["param_meta"], plan)
    caches = _local(specs["cache_meta"], plan)
    rows = specs["token_rows"]
    toks = torch.empty((rows.stop - rows.start, 1), dtype=torch.int32, device="meta")
    return fn, (params, caches, toks, shape.seq_len - 1)


def hbm_limit() -> int:
    """The card's memory, or the H100's without a card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100["hbm_bytes"]


def run_one(arch: str, shape_name: str, *, multi_pod: bool, mechanism="rqm",
            packed=False, q_chunk=None, remat=True, seq_parallel=None,
            sp_compress=False, agg_dtype="int32", zero1=False,
            kv_quant=False, ssm_chunk=None,
            out_dir="results/dryrun_torch", tag="", layers=None) -> dict:
    """One combination's record, also written to ``out_dir``. ``layers``
    cuts the architecture's depth (its widths kept)."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    shape = INPUT_SHAPES[shape_name]
    ok, reason = supports(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mechanism": mechanism if shape.kind == "train" else None,
        "packed": packed,
        "sp_compress": sp_compress,
        "agg_dtype": agg_dtype,
        "zero1": zero1,
        "kv_quant": kv_quant,
        "seq_parallel": seq_parallel,
        "tag": tag,
    }
    if layers is not None:
        rec["layers"] = layers

    def _write(r):
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = f"{arch}_{shape_name}_{mesh_name}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(r, f, indent=2)

    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        _write(rec)
        return rec
    dims = MESHES[mesh_name]
    n_dev = math.prod(dims)
    t0 = time.time()
    try:
        with fake_world(n_dev):
            plan = make_plan(dims, "meta")
            fn, args = build_step(
                cfg, plan, shape, mechanism=mechanism, packed=packed,
                q_chunk=q_chunk, remat=remat, seq_parallel=seq_parallel,
                sp_compress=sp_compress, agg_dtype=agg_dtype, zero1=zero1,
                kv_quant=kv_quant, ssm_chunk=ssm_chunk,
            )
            t_build = time.time() - t0
            with hlo_analysis.counting() as counts:
                out = fn(*args)
            t_run = time.time() - t0 - t_build
            arg_bytes = hlo_analysis.storage_bytes(args)
            out_bytes = hlo_analysis.storage_bytes(out)
            del out
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        _write(rec)
        return rec

    coll = hlo_analysis.collective_bytes(counts.collectives)
    flops = float(counts.flops)
    bytes_accessed = float(counts.bytes)
    terms = hlo_analysis.roofline_terms(flops, bytes_accessed, coll.total_bytes, H100)
    mflops_global = hlo_analysis.model_flops(cfg, shape, tp=plan.tp)
    mflops_per_dev = mflops_global / n_dev
    from repro_torch.launch import memory_model

    limit = hbm_limit()
    analytical = memory_model.estimate(
        cfg, shape, plan.shape,
        seq_parallel=(seq_parallel if seq_parallel is not None else True),
        zero1=zero1, kv_quant=kv_quant, hbm_bytes=limit,
    )
    mem = {
        # the meta run's storages: the rank's arguments, its outputs (in
        # place updates included), and the peak of those the step made
        "meta_argument_bytes": arg_bytes,
        "meta_output_bytes": out_bytes,
        "meta_peak_bytes": counts.peak_bytes,
        # analytical per-rank memory model: the fits check
        "analytical": {k: float(v) for k, v in analytical.items()},
        "hbm_limit": limit,
        "fits": bool(analytical["fits"]),
    }
    rec.update(
        status="ok",
        devices=n_dev,
        build_s=round(t_build, 1),
        run_s=round(t_run, 1),
        per_device_flops=flops,
        per_device_hbm_bytes=bytes_accessed,
        kernel_bytes=dict(counts.kernel_bytes),
        dispatched_ops=counts.ops,
        collective=coll.summary(),
        roofline=terms,
        model_flops_per_device=mflops_per_dev,
        useful_flops_ratio=(mflops_per_dev / flops) if flops else None,
        memory=mem,
    )
    _write(rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mechanism", default="rqm",
                    help="mechanism spec: registered name or 'name:k=v,...' "
                         "string (e.g. 'qmgeo:c=0.05,m=16,r=0.6'); any "
                         "registered mechanism runs through the mesh step")
    ap.add_argument("--packed", action="store_true", help="lane-packed aggregation")
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true",
                    help="disable Megatron sequence parallelism (perf baseline)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="force SP on (enables SP for prefill, which is "
                         "plain-TP by default)")
    ap.add_argument("--sp-compress", action="store_true",
                    help="int8-compressed SP entry all-gathers (§Perf)")
    ap.add_argument("--agg-dtype", default="int32",
                    choices=["int32", "int16", "auto"],
                    help="SecAgg level width on the wire (§Perf)")
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1 master/optimizer sharding over clients (§Perf)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8-quantized KV cache for decode shapes (§Perf)")
    ap.add_argument("--ssm-chunk", type=int, default=None,
                    help="override the SSD chunk length (§Perf)")
    ap.add_argument("--tag", default="", help="suffix for the artifact file")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    for arch in archs:
        for shape in shapes:
            rec = run_one(
                arch, shape, multi_pod=args.multi_pod, mechanism=args.mechanism,
                packed=args.packed, q_chunk=args.q_chunk,
                remat=not args.no_remat,
                seq_parallel=(False if args.no_seq_parallel
                              else (True if args.seq_parallel else None)),
                sp_compress=args.sp_compress, agg_dtype=args.agg_dtype,
                zero1=args.zero1, kv_quant=args.kv_quant,
                ssm_chunk=args.ssm_chunk,
                out_dir=args.out_dir, tag=args.tag,
            )
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f"compute={r['compute_s']*1e3:.2f}ms "
                         f"memory={r['memory_s']*1e3:.2f}ms "
                         f"coll={r['collective_s']*1e3:.2f}ms "
                         f"dom={r['dominant']} "
                         f"hbm={rec['memory']['analytical']['total']/2**30:.2f}GiB "
                         f"fits={rec['memory']['fits']} "
                         f"(build {rec['build_s']}s run {rec['run_s']}s)")
            elif status == "error":
                extra = rec["error"][:200]
            else:
                extra = rec["reason"][:80]
            print(f"[{status:7s}] {arch} x {shape} x {rec['mesh']} {extra}", flush=True)


if __name__ == "__main__":
    main()

"""Training launcher (counterpart of ``repro/launch/train.py``): the LM
train step (``distributed/step.py``) on random weights and the synthetic
Markov token stream, on the card unless ``--device cpu``.

Three modes:
  * plain run: one process, no client group; each step is grad -> clip
    -> mechanism encode -> decode -> server optimizer at the warmup-cosine
    rate, at full width on the card:
      PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
          --steps 3 --batch 2 --seq 256
  * mesh run: ``--mesh-shape N`` (sugar for ``Nx1``, data x model),
    ``DxM`` or ``PxDxM`` (pod x data x model) makes each process one rank
    of a ``torch.distributed`` group of D (P x D) clients of M model
    ranks, rank = client * M + model index: a client's M ranks run its
    gradient tensor-parallel, and the clients sum their levels over the
    ranks of one model index:
      torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
          --mesh-shape 2x2 --arch mamba2-370m --reduced --steps 4 --batch 4 --seq 32
    On the card each rank takes ``cuda:(LOCAL_RANK mod the visible
    cards)``; ranks that outnumber the cards share them over gloo, on the
    CUDA tensors (``launch/mesh.py:backend``; NCCL refuses two ranks on
    one device), and the run's header names the backend:
      torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh-shape 1x2 \\
          --arch gemma3-4b --steps 3 --batch 2 --seq 256
    One rank (``--mesh-shape 1``) needs no launcher: the group is made in
    process (NCCL on the card).
  * federated run: ``--fed-lm`` trains the same reduced config as the
    'lm' client task through a ``FedTrainer`` (docs/lm_federated.md).

Seeds, not keys: each step's per-leaf kernel seeds are a pure function
of (``--seed``, step, client rank, leaf, shard index), so ``--resume`` restores
{params, opt, server_opt_fp} from ``--ckpt-dir`` and needs no stored
stream. A checkpoint of the reference's launcher does not resume here:
its key stream differs from these seeds by design. A checkpoint holds
the global parameters and optimizer state, gathered over the model axis:
it resumes at any tp whose layouts are the same. Only rank 0 prints,
tracks and saves; every rank restores (its slices). Compute is float32 without TF32
or remat.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.convert import leaves
from repro_torch.core.mechanisms import accepted_options, make_mechanism, mechanism_names
from repro_torch.data.lm import TokenPipeline
from repro_torch.distributed.step import (
    build_train_step_fn,
    make_plan,
    make_train_step,
    round_privacy,
    train_seeds,
)
from repro_torch.eval.lm_eval import batch_to
from repro_torch.launch.mesh import backend
from repro_torch.models import meta as meta_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import ParallelCtx
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.telemetry import NoopTracker, Timings, make_tracker


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mechanism", default="rqm",
                    help="mechanism spec: a registered name or a "
                         "'name:k=v,...' string, e.g. 'rqm', "
                         "'qmgeo:c=0.05,m=16,r=0.6' "
                         f"(registered: {', '.join(mechanism_names())}); "
                         "--clip/--m/--q/--delta-ratio act as defaults")
    ap.add_argument("--clip", type=float, default=0.02)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--q", type=float, default=0.42)
    ap.add_argument("--delta-ratio", type=float, default=1.0)
    ap.add_argument("--target-eps", type=float, default=None,
                    help="drive the run BACKWARDS from a privacy budget: "
                         "calibrate the --mechanism family's privacy knob "
                         "(rqm q / pbm theta / qmgeo r) so the composed "
                         "(eps, --target-delta)-DP epsilon of --steps steps "
                         "hits this target (repro_torch.privacy.calibrate); "
                         "the knob flag (e.g. --q) is then ignored")
    ap.add_argument("--target-delta", type=float, default=1e-5,
                    help="delta for --target-eps calibration")
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--server-opt", "--optimizer", dest="server_opt",
                    default="sgd",
                    help="server optimizer applied at the decode-then-"
                         "apply boundary (sgd | momentum | adam); "
                         "--optimizer is the legacy spelling")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2x1 => (data,model); 2x2x1 => (pod,data,model); "
                         "a single number N is sugar for Nx1: pure client "
                         "parallelism over (data,) with a trivial model axis; "
                         "1x2: one client tensor-parallel over 2 ranks")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore params + optimizer state from the latest "
                         "checkpoint in --ckpt-dir and continue from that "
                         "step (the kernel seeds derive from the step, so "
                         "the continuation matches the uninterrupted run)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--track", default=None,
                    help="tracker spec: 'json:runs/lm.json', "
                         "'csv:runs/lm.csv', or a '+'-joined composite; one "
                         "record per step")
    ap.add_argument("--fed-lm", action="store_true",
                    help="federated private LM fine-tuning: run --arch as "
                         "the 'lm' client task through a FedTrainer "
                         "(docs/lm_federated.md); --steps is the round "
                         "budget, --batch/--seq the PER-CLIENT batch")
    ap.add_argument("--fed-engine", default="scan",
                    help="round engine spec for --fed-lm (scan | perround "
                         "| host | shard[:shards=..] | async[:..])")
    ap.add_argument("--clients", type=int, default=64,
                    help="--fed-lm population size")
    ap.add_argument("--cohort", type=int, default=8,
                    help="--fed-lm clients per round")
    ap.add_argument("--fed-shards", type=int, default=None,
                    help="--fed-lm shard-engine client shards")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="--fed-lm tensor-parallel model shards (above 1: "
                         "--fed-engine shard over shards x model-shards ranks)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _device(name: str) -> torch.device:
    """``--device``; under torchrun, a cuda rank takes its local card
    (its local rank modulo the visible cards: ranks share cards when they
    outnumber them)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch.cuda.is_available() is False; "
                               "pass --device cpu to run the plain PyTorch versions")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def _init_from_env(device: torch.device) -> None:
    """Join the default process group that torchrun's environment
    describes (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), if any."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or world <= 1:
        return
    name = backend(device, world)
    dist.init_process_group(name, init_method="env://",
                            device_id=device if "nccl" in name else None)


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.fed_lm:
        return _fed_lm(args, ap)

    device = _device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = InputShape("cli", args.seq, args.batch, "train")
    plan = None
    if args.mesh_shape:
        dims = tuple(int(x) for x in args.mesh_shape.split("x"))
        if len(dims) == 1:
            # pure client parallelism: a trivial size-1 model axis
            dims = (dims[0], 1)
        _init_from_env(device)
        plan = make_plan(dims, device)
    n_clients = plan.n_clients if plan else 1
    ctx = plan.ctx() if plan else ParallelCtx()
    client = ctx.client_index
    lead = client == 0 and ctx.model_index() == 0
    say = print if lead else (lambda *a, **k: None)
    if plan is not None:
        say(f"[mesh] {dict(plan.shape)}: {n_clients} client(s) x tp {plan.tp} on "
            f"{device.type}, backend {dist.get_backend()}")
    if args.target_eps is not None:
        # Backwards mode: solve for the mechanism from the privacy budget
        # (privacy/calibrate.py) instead of specifying the knob by hand.
        from repro_torch.core.mechanisms import parse_mechanism_spec
        from repro_torch.privacy.calibrate import calibrate, calibration_knobs

        name, explicit = parse_mechanism_spec(args.mechanism)
        knob = calibration_knobs().get(name)
        if knob is None:
            ap.error(f"--target-eps requires a calibratable mechanism "
                     f"({', '.join(calibration_knobs())}), got {name!r}")
        if knob.option in explicit:
            ap.error(f"--mechanism fixes {knob.option}="
                     f"{explicit[knob.option]} but --target-eps solves for "
                     f"{knob.option}; drop one of the two")
        pool = dict(c=args.clip, m=args.m, delta_ratio=args.delta_ratio)
        opts = {k: v for k, v in pool.items() if k in accepted_options(name)}
        opts.update(explicit)
        res = calibrate(
            name, target_eps=args.target_eps, target_delta=args.target_delta,
            rounds=args.steps, cohort=n_clients, **opts,
        )
        mech = res.mechanism
        say(f"[privacy] calibrated {res.describe()}")
    else:
        # CLI flags are defaults; options inline in the spec override them.
        mech = make_mechanism(
            args.mechanism, c=args.clip, m=args.m, q=args.q,
            delta_ratio=args.delta_ratio,
        )
    # Self-accounting: the step's privacy comes from the very mechanism
    # object that encodes. RDP composes additively over steps.
    eps = round_privacy(mech, n_clients, alphas=(8.0,))[8.0]
    say(f"[privacy] {mech.describe()}: per-step aggregate eps(alpha=8) = "
        f"{eps:.4f} with n_clients={n_clients}; "
        f"total over {args.steps} steps = {eps * args.steps:.4f}")
    opt = make_optimizer(args.server_opt)
    lr_fn = warmup_cosine(args.lr, warmup=args.steps // 10 + 1, total_steps=args.steps,
                          device=device)
    pipe = TokenPipeline(cfg, args.seq, args.batch, seed=args.seed)
    tracker = make_tracker(args.track if lead else None)
    tracker.run_started({
        "kind": "lm_train", "engine": "lm_step", "arch": args.arch,
        "reduced": args.reduced, "mechanism": mech.describe(),
        "steps": args.steps, "batch": args.batch, "seq": args.seq,
        "server_opt": args.server_opt, "mesh": args.mesh_shape,
        "per_step_eps_alpha8": eps, "backend": device.type,
    })
    shards = None  # the per-leaf seed-folding indices
    if plan is not None:
        # float32, as the reference's launcher; no remat (it moves memory,
        # not values)
        step_fn, specs = make_train_step(cfg, plan, mech, opt, lr_fn, shape,
                                         packed=args.packed, remat=False,
                                         compute_dtype=torch.float32)
        ctx, shards = specs["ctx"], specs["shard_seeds"]
    else:
        step_fn = build_train_step_fn(cfg, mech, opt, lr_fn, ctx, packed=args.packed,
                                      remat=False, compute_dtype=torch.float32)
    # every rank draws the global tree leaf by leaf and keeps its slices
    params = model_lib.init_params(torch.Generator(device).manual_seed(args.seed + 1), cfg,
                                   device=device, tp=ctx.tp,
                                   keep=meta_lib.slicer(ctx.tp, ctx.model_index()))
    opt_state = opt.init(params)
    meta = model_lib.param_meta(cfg, tp=ctx.tp)
    params, opt_state, start = _maybe_resume(args, params, opt_state, say, meta, ctx)
    out = _loop(args, pipe, step_fn, params, opt_state, start, device=device,
                client=client, lead=lead, tracker=tracker, mech_desc=mech.describe(),
                shards=shards, meta=meta, ctx=ctx)
    return {**out, "mechanism": mech}


def _fed_lm(args, ap):
    """--fed-lm: the federated counterpart of the per-step LM run — the
    'lm' client task (fed/tasks.py) on any registered round engine, with
    the full FedTrainer surface (privacy accounting, checkpoints on
    round boundaries, tracker records per round)."""
    from repro_torch.fed.config import FedConfig
    from repro_torch.fed.trainer import FedTrainer

    if args.target_eps is not None:
        ap.error("--fed-lm does not take --target-eps yet: calibrate the "
                 "mechanism against the cohort with repro_torch.privacy.calibrate "
                 "and pass the resulting spec via --mechanism")
    if args.mesh_shape:
        ap.error("--fed-lm meshes come from the round engine: use "
                 "--fed-engine shard with --fed-shards/--model-shards "
                 "instead of --mesh-shape")
    if not args.reduced:
        ap.error("--fed-lm requires --reduced (federated fine-tuning of "
                 "the full-size configs is not CPU-feasible)")
    mech = make_mechanism(
        args.mechanism, c=args.clip, m=args.m, q=args.q,
        delta_ratio=args.delta_ratio,
    )
    # the shard engine's ranks (shards x model shards) under torchrun
    device = _device(args.device)
    _init_from_env(device)
    task = (f"lm:model={args.arch},seq_len={args.seq},"
            f"batch={args.batch}")
    cfg = FedConfig(
        engine=args.fed_engine, task=task, rounds=args.steps,
        num_clients=args.clients, clients_per_round=args.cohort,
        lr=args.lr, seed=args.seed, server_opt=args.server_opt,
        shards=args.fed_shards, model_shards=args.model_shards,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    lead = not dist.is_initialized() or dist.get_rank() == 0
    tr = FedTrainer(mech, cfg, device=device, tracker=make_tracker(args.track if lead else None))
    eps = tr.per_round_eps[0] if len(tr.per_round_eps) else float("nan")
    say = print if lead else (lambda *a, **k: None)
    say(f"[fed-lm] task={tr.task.spec()} engine={cfg.engine} "
          f"dim={int(tr.flat.numel())} cohort={args.cohort}/{args.clients} "
          f"per-round eps(alpha={cfg.accountant_alphas[0]:g})={eps:.4f}")
    start = 0
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt-dir")
        start = tr.restore_checkpoint()
        say(f"[resume] restored round {start} from {args.ckpt_dir}")
    records = tr.train(rounds=args.steps - start, eval_every=max(args.log_every, 1), log=say)
    return {"trainer": tr, "records": records}


def _opt_fingerprint(server_opt: str) -> np.ndarray:
    """(32,) uint8 sha256 of the optimizer name — saved with every
    checkpoint so --resume can refuse a mismatched --server-opt instead
    of silently dropping (or failing to find) the optimizer state."""
    return np.frombuffer(hashlib.sha256(server_opt.encode()).digest(),
                         np.uint8)


def _global_state(tree, meta, ctx, fn):
    """``fn(params_tree, meta, ctx)`` applied to the params tree and to
    each of the optimizer state's params-shaped entries (adam's and
    momentum's ``m``, ``v``; sgd's ``()`` and adam's ``t`` as they are)."""
    if isinstance(tree, dict) and set(tree) == set(meta):
        return fn(tree, meta, ctx)
    if isinstance(tree, dict):
        return {k: _global_state(v, meta, ctx, fn) for k, v in tree.items()}
    return tree


def _shard_to(device):
    def shard(tree, meta, ctx):
        return meta_lib.tree_map(
            lambda m, t: meta_lib.shard_leaf(t, m, ctx.tp, ctx.model_index()).to(
                device, copy=True),
            meta, tree)
    return shard


def _maybe_resume(args, params, opt_state, say, meta, ctx):
    """--resume: restore {params, opt} from the latest checkpoint in
    --ckpt-dir; the kernel seeds derive from the step and the data
    pipeline is stateless per step, so the continuation matches the
    uninterrupted run exactly. Every rank restores: over a model axis the
    global trees, on the host, of which it keeps its slices. Returns the
    (possibly restored) state and the start step."""
    if not args.resume:
        return params, opt_state, 0
    if not args.ckpt_dir:
        raise SystemExit("--resume requires --ckpt-dir")
    step0 = latest_step(args.ckpt_dir)
    if step0 is None:
        say(f"[resume] no checkpoints in {args.ckpt_dir}; starting fresh")
        return params, opt_state, 0
    # fingerprint first, alone: a mismatched --server-opt may not even
    # share the checkpoint's optimizer-state tree, which would abort the
    # full restore with a missing-leaf error before this clearer one
    try:
        fp = restore(args.ckpt_dir, step0,
                     {"server_opt_fp": np.zeros(32, np.uint8)})
    except KeyError:
        raise SystemExit(
            f"--resume: checkpoint step {step0} in {args.ckpt_dir} "
            f"predates the resume metadata (no optimizer fingerprint / "
            f"RNG key saved) and cannot be resumed exactly; re-train "
            f"with this build to produce resumable checkpoints"
        )
    if not np.array_equal(fp["server_opt_fp"],
                          _opt_fingerprint(args.server_opt)):
        raise SystemExit(
            f"--resume: the checkpoint in {args.ckpt_dir} was written "
            f"with a different --server-opt than {args.server_opt!r}; "
            f"pass the original optimizer (continuing with another would "
            f"silently diverge from the uninterrupted run)"
        )
    like = {"params": params, "opt": opt_state}
    if ctx.model:
        # the checkpoint's global shapes, on the host (adam's step count
        # stays as it is, on the device)
        like = _global_state(like, meta, ctx, lambda t, m, _: meta_lib.tree_map(
            lambda mm, leaf: torch.empty(mm.shape, dtype=leaf.dtype), m, t))
    tree = restore(args.ckpt_dir, step0, like)
    if ctx.model:
        device = leaves(params)[0].device
        tree = _global_state(tree, meta, ctx, _shard_to(device))
    say(f"[resume] restored step {step0} from {args.ckpt_dir}")
    return tree["params"], tree["opt"], step0


def _loop(args, pipe, step_fn, params, opt_state, start=0, *, device, client, lead,
          tracker=None, mech_desc="", shards=None, meta=None, ctx=None) -> dict:
    """Steps ``start`` to ``--steps``; returns the final ``params``,
    ``opt_state`` and ``metrics`` (floats) and the per-step ``losses``
    (read back once, at the end, unless a tracker or a log line reads
    them sooner)."""
    tracker = make_tracker(tracker)
    tracked = not isinstance(tracker, NoopTracker)
    timings = Timings()
    n_leaves = len(leaves(params))
    losses, metrics = [], {}
    t0 = time.time()
    for step in range(start, args.steps):
        ts = time.perf_counter()
        with timings.scope("step"):
            batch = batch_to(pipe.batch(step), device)
            seeds = train_seeds(args.seed, step, client, n_leaves, shards)
            params, opt_state, metrics = step_fn(params, opt_state, step, batch, seeds)
            if tracked:
                # reading metrics blocks on the step: the tracked rate is
                # the real step rate, not the async enqueue rate
                metrics = {k: float(v) for k, v in metrics.items()}
        losses.append(metrics["loss"])
        if tracked:
            elapsed = time.perf_counter() - ts
            tracker.log_round({
                "round": step + 1, "engine": "lm_step",
                "mechanism": mech_desc, "loss": metrics["loss"],
                "rounds_per_sec": 1.0 / max(elapsed, 1e-9),
                "extra": {
                    "ce_loss": metrics["ce_loss"],
                    "tokens_per_sec": args.batch * args.seq / max(elapsed, 1e-9),
                },
            })
        if lead and ((step + 1) % args.log_every == 0 or step == start):
            m = {k: float(v) for k, v in metrics.items()}
            rate = (step + 1 - start) * args.batch * args.seq / (time.time() - t0)
            print(f"step {step+1:5d} loss={m['loss']:.4f} ce={m['ce_loss']:.4f} "
                  f"tok/s={rate:,.0f}", flush=True)
        if args.ckpt_dir and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            tree = {"params": params, "opt": opt_state}
            if ctx is not None and ctx.model and client == 0:
                # the global trees: every model rank of client 0 gathers
                tree = _global_state(tree, meta, ctx, meta_lib.gather_tree)
            if lead:
                save(args.ckpt_dir, step + 1,
                     {**tree, "server_opt_fp": _opt_fingerprint(args.server_opt)})
    if tracked:
        tracker.log_timings(timings.summary())
    tracker.close()
    if lead:
        print(f"done in {time.time()-t0:.1f}s")
    return {"params": params, "opt_state": opt_state, "start": start,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "losses": [float(v) for v in losses]}


if __name__ == "__main__":
    main()

"""The end-to-end example of the PyTorch/CUDA port (src/repro_torch): the
paper's experiment (Sec 6.2 / Fig 3), federated DP-SGD on synthetic
EMNIST with RQM, against PBM, the QMGeo-style quantizer and noise-free
clipped SGD, with exact Renyi accounting across rounds. It takes the
flags of examples/fl_emnist.py:

  PYTHONPATH=src python examples/fl_emnist_torch.py --rounds 300
  PYTHONPATH=src python examples/fl_emnist_torch.py --rounds 300 --mechanism rqm \\
      --delta-ratio 0.66 --q 0.33
  PYTHONPATH=src python examples/fl_emnist_torch.py --rounds 300 \\
      --subsampling poisson --dropout 0.1     # realistic cohorts

Runs on the GPU (``--device cuda``, the default) or, with the plain
PyTorch versions of every kernel, on the CPU (``--device cpu``).
Heterogeneous cohorts (``--subsampling poisson`` selects each client
i.i.d. a round, ``--dropout`` drops selected clients i.i.d.) are
accounted at each round's realized size. ``--target-eps`` calibrates
each private family's knob to the budget (the other options fixed) and
halts a run when the budget is spent:

  PYTHONPATH=src python examples/fl_emnist_torch.py --rounds 50 --clients 400 \
      --per-round 8 --mechanism rqm --target-eps 40
"""
import argparse
import dataclasses
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core.mechanisms import (  # noqa: E402
    accepted_options, make_mechanism, mechanism_names, parse_mechanism_spec,
)
from repro_torch.fed.config import FedConfig  # noqa: E402
from repro_torch.fed.engine import engine_names  # noqa: E402
from repro_torch.fed.trainer import FedTrainer  # noqa: E402
from repro_torch.privacy.calibrate import DEFAULT_ALPHAS, calibrate, calibration_knobs  # noqa: E402
from repro_torch.telemetry import parse_tracker_spec  # noqa: E402


def _suffix_track_spec(spec: str, tag: str) -> str:
    """Per-mechanism tracker paths in a multi-mechanism sweep: the
    mechanism tag before the extension of every path in the spec."""
    parts = []
    for sub in spec.split("+"):
        name, opts = parse_tracker_spec(sub)
        if opts.get("path"):
            root, ext = os.path.splitext(str(opts["path"]))
            opts["path"] = f"{root}-{tag}{ext}"
        body = ",".join(f"{k}={v}" for k, v in opts.items())
        parts.append(f"{name}:{body}" if body else name)
    return "+".join(parts)


def run_one(spec, fcfg, device, target_eps=None, resume=False, track=None, multi=False,
            **defaults):
    """One mechanism end to end: build it from the spec (or calibrate its
    family to ``target_eps``), train with the configured engine (resuming
    from its checkpoint directory when asked), report its own accounting."""
    name, explicit = parse_mechanism_spec(spec)
    if target_eps is not None and name in calibration_knobs():
        # the spec's inline options are fixed calibration options too; the
        # knob inside the spec conflicts with solving for it (calibrate raises)
        knob = calibration_knobs()[name]
        opts = {k: v for k, v in defaults.items()
                if k in accepted_options(name) and k != knob.option}
        opts.update(explicit)
        calibrated = calibrate(name, target_eps=target_eps, target_delta=fcfg.budget_delta,
                               rounds=fcfg.rounds, cohort=fcfg.clients_per_round, **opts)
        mech = calibrated.mechanism
        print(f"[{name}] calibrated: {calibrated.describe()}")
    else:
        mech = make_mechanism(spec, **defaults)
    # one artifact per full mechanism spec: a sweep must not interleave
    # checkpoints or tracker series
    tag = f"{name}-{hashlib.sha256(mech.describe().encode()).hexdigest()[:8]}"
    if fcfg.ckpt_dir:
        fcfg = dataclasses.replace(fcfg, ckpt_dir=os.path.join(fcfg.ckpt_dir, tag))
    if track and multi:
        track = _suffix_track_spec(track, tag)
    tr = FedTrainer(mech, fcfg, device=device, tracker=track)
    remaining = fcfg.rounds
    if resume:
        try:
            restored = tr.restore_checkpoint()
        except FileNotFoundError:
            print(f"[{name}] no checkpoints in {fcfg.ckpt_dir}; starting fresh")
        else:
            remaining = max(fcfg.rounds - restored, 0)
            print(f"[{name}] resumed from round {restored} ({fcfg.ckpt_dir}); "
                  f"{remaining} rounds to go")
    hist = tr.train(rounds=remaining, eval_every=25)
    if not hist:
        m = tr.evaluate()
        m["round"] = tr.accountant.rounds
        hist = [m]
    out = {"mechanism": mech.name, "spec": mech.describe(), "history": hist}
    if tr.realized_n and min(tr.realized_n) != max(tr.realized_n):
        out["realized_cohorts"] = {
            "min": min(tr.realized_n), "max": max(tr.realized_n),
            "mean": sum(tr.realized_n) / len(tr.realized_n),
        }
    tr.tracker.close()
    per_round = mech.per_round_epsilon(fcfg.clients_per_round, 8.0)
    if per_round > 0:
        out["per_round_eps_alpha8"] = per_round
        out["rdp_eps_alpha8"] = tr.accountant.rdp_epsilon(8.0)
        eps, alpha = tr.accountant.dp_epsilon(1e-5)
        out["dp_eps_at_1e-5"] = eps
        out["dp_alpha"] = alpha
        print(f"[{mech.name}] total RDP eps(alpha=8) = {out['rdp_eps_alpha8']:.3f}; "
              f"(eps, delta=1e-5)-DP eps = {eps:.3f} via alpha={alpha}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--clients", type=int, default=3400)
    ap.add_argument("--per-round", type=int, default=40)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--clip", type=float, default=0.02)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--q", type=float, default=0.42)
    ap.add_argument("--delta-ratio", type=float, default=1.0)
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--r", type=float, default=0.6)
    ap.add_argument("--mechanism", default="all",
                    help="'all', a registered name "
                         f"({', '.join(mechanism_names())}), or a 'name:k=v,...' spec "
                         "string; the flags above fill what the spec leaves unset")
    ap.add_argument("--engine", default="scan",
                    help=f"round engine: a registered name ({', '.join(engine_names())}) "
                         "or a 'name:k=v,...' spec string, e.g. 'shard:shards=1': 'scan' "
                         "= blocks of captured CUDA-graph rounds, 'perround' = the same "
                         "round eagerly, 'host' = the legacy host loop, 'shard' = rounds "
                         "over a process group")
    ap.add_argument("--server-opt", default="sgd",
                    help="server optimizer: 'sgd', 'momentum' or 'adam'")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (a subdirectory per mechanism)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N rounds (requires --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from --ckpt-dir and continue "
                         "bit for bit")
    ap.add_argument("--shards", type=int, default=None,
                    help="engine=shard: ranks of the process group (default: all)")
    ap.add_argument("--staging", default="full", choices=["full", "stream"],
                    help="engine=shard: 'stream' stages only each block's cohorts")
    ap.add_argument("--fused-rounds", action="store_true",
                    help="fused clip -> encode -> sum and decode -> apply kernels "
                         "(bit-identical results)")
    ap.add_argument("--subsampling", default="fixed", choices=["fixed", "poisson"],
                    help="'poisson' includes each client i.i.d. at rate "
                         "per_round/clients; rounds are accounted at the realized size")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="i.i.d. dropout probability of each selected client")
    ap.add_argument("--target-eps", type=float, default=None,
                    help="calibrate each private family to this total (eps, "
                         "--target-delta)-DP budget over --rounds, and halt when spent")
    ap.add_argument("--target-delta", type=float, default=1e-5)
    ap.add_argument("--track", default=None,
                    help="tracker spec: 'json:runs/fl.json', 'csv:runs/fl.csv', or a "
                         "'+'-joined composite; with --mechanism all each mechanism "
                         "writes its own suffixed file")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default=None, help="write results JSON")
    args = ap.parse_args()
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")

    fcfg = FedConfig(
        num_clients=args.clients, clients_per_round=args.per_round,
        rounds=args.rounds, lr=args.lr, eval_size=1000,
        data_noise=1.5, data_deform=1.2,  # see benchmarks/fig3_fl_emnist.py
        engine=args.engine, shards=args.shards, staging=args.staging,
        fused_rounds=args.fused_rounds, server_opt=args.server_opt,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        subsampling=args.subsampling, dropout=args.dropout,
        budget_eps=args.target_eps, budget_delta=args.target_delta,
        # budget mode: account on the alpha grid calibration optimizes
        # over, so the run affords exactly the calibrated rounds
        accountant_alphas=(tuple(DEFAULT_ALPHAS) if args.target_eps is not None
                           else FedConfig.accountant_alphas),
    )
    specs = ["none", "rqm", "pbm", "qmgeo"] if args.mechanism == "all" else [args.mechanism]
    defaults = dict(c=args.clip, m=args.m, q=args.q, delta_ratio=args.delta_ratio,
                    theta=args.theta, r=args.r)
    results = [run_one(s, fcfg, args.device, target_eps=args.target_eps, resume=args.resume,
                       track=args.track, multi=len(specs) > 1, **defaults)
               for s in specs]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print("wrote", args.out)


if __name__ == "__main__":
    main()

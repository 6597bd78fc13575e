"""Train a language model with RQM in the loop on the PyTorch port (the
counterpart of examples/train_lm_rqm.py): the distributed train step
(grad -> clip -> RQM -> SecAgg sum -> decode -> SGD) of
``repro_torch.distributed.step`` on a reduced architecture, on the card
unless ``--device cpu``.

  PYTHONPATH=src python examples/train_lm_rqm_torch.py --arch qwen3-moe-30b-a3b \\
      --steps 150 --compare [--device cpu]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import leaves  # noqa: E402
from repro_torch.core.mechanisms import make_mechanism  # noqa: E402
from repro_torch.data.lm import TokenPipeline  # noqa: E402
from repro_torch.distributed.step import build_train_step_fn, train_seeds  # noqa: E402
from repro_torch.eval.lm_eval import batch_to  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.common import ParallelCtx  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.schedules import warmup_cosine  # noqa: E402


def run(arch, mechanism, steps, batch, seq, clip, lr, seed=0, log=True, device="cuda"):
    """The per-step ce losses of ``steps`` steps (read back at log steps
    and at the end)."""
    device = torch.device(device)
    cfg = get_config(arch, reduced=True)
    mech = make_mechanism(mechanism, c=clip)
    opt = make_optimizer("sgd")
    step_fn = build_train_step_fn(
        cfg, mech, opt, warmup_cosine(lr, steps // 10 + 1, steps, device=device), ParallelCtx())
    params = model_lib.init_params(torch.Generator(device).manual_seed(seed), cfg,
                                   device=device)
    opt_state = opt.init(params)
    pipe = TokenPipeline(cfg, seq, batch, seed=seed)
    n_leaves = len(leaves(params))
    losses = []
    for step in range(steps):
        b = batch_to(pipe.batch(step), device)
        params, opt_state, m = step_fn(params, opt_state, step, b,
                                       train_seeds(seed + 1, step, 0, n_leaves))
        losses.append(m["ce_loss"])
        if log and ((step + 1) % 25 == 0 or step == 0):
            print(f"  [{mechanism:5s}] step {step+1:4d} ce={float(losses[-1]):.4f}")
    return [float(v) for v in losses]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clip", type=float, default=0.02)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--mechanism", default="rqm")
    ap.add_argument("--compare", action="store_true",
                    help="run rqm vs pbm vs noise-free")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    names = ["none", "rqm", "pbm"] if args.compare else [args.mechanism]
    final = {}
    for n in names:
        print(f"training {args.arch} with mechanism={n}")
        losses = run(args.arch, n, args.steps, args.batch, args.seq,
                     args.clip, args.lr, device=args.device)
        final[n] = losses[-1]
    print("final ce:", {k: round(v, 4) for k, v in final.items()})
    return final


if __name__ == "__main__":
    main()

"""Serve a small model with batched requests on the PyTorch/CUDA port
(src/repro_torch): static batching of a request queue over the port's
prefill/decode runtime, on the reduced configs (counterpart of
examples/serve_demo.py, whose request queue it draws: the same prompts).

  PYTHONPATH=src python examples/serve_demo_torch.py --arch gemma3-4b --requests 6 \\
      [--device cpu]

On the GPU (``--device cuda``, the default) or the CPU (``--device cpu``).
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    device = torch.device(args.device)
    params = model_lib.init_params(torch.Generator(device).manual_seed(0), cfg, device=device)
    pfx = cfg.frontend.prefix_len if cfg.frontend else 0

    # request queue -> fixed-size batches (simple static batching)
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab_size, size=args.prompt_len - pfx).astype(np.int32)
             for _ in range(args.requests)]
    served, outputs, t0 = 0, [], time.time()
    while queue:
        batch_reqs = [queue.pop(0) for _ in range(min(args.batch, len(queue)))]
        while len(batch_reqs) < args.batch:  # pad the last batch
            batch_reqs.append(batch_reqs[-1])
        toks = torch.from_numpy(np.stack(batch_reqs)).to(device)
        pe = torch.zeros((args.batch, pfx, cfg.d_model), device=device) if pfx else None
        gen = generate(params, cfg, toks, args.gen, pe,
                       capacity=args.prompt_len + args.gen)[0].cpu().numpy()
        served += len(batch_reqs)
        outputs.append(gen)
        print(f"batch done: generated {gen.shape[1]} tokens x {gen.shape[0]} requests; "
              f"sample: {gen[0][:10].tolist()}")
    dt = time.time() - t0
    print(f"served {served} requests ({served * args.gen} tokens) "
          f"in {dt:.1f}s = {served * args.gen / dt:,.0f} tok/s")
    return outputs


if __name__ == "__main__":
    main()

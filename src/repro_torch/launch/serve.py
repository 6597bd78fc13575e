"""Serving launcher (counterpart of ``repro/launch/serve.py``): batched
prefill and greedy decode of synthetic prompts on random weights, with
prefill and decode tokens/s. On the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --reduced \\
      --batch 4 --prompt-len 64 --gen 32 [--device cpu]

The parameters are drawn from a ``torch.Generator`` on the device (the
full-width configs in seconds), the prompt from a second one. The
decode loop keeps each next token on the device and reads nothing back
until generation ends. Compute is float32, as the reference's launcher
passes it.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import model as model_lib
from repro_torch.models.common import ParallelCtx


def synthetic_prompt(cfg: ModelConfig, batch: int, prompt_len: int,
                     generator: torch.Generator, device):
    """Random prompt tokens (batch, prompt_len - P) and, for a config
    with a modality frontend, its P prefix embeddings at scale 0.02."""
    pfx = cfg.frontend.prefix_len if cfg.frontend else 0
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len - pfx), generator=generator,
                         device=generator.device, dtype=torch.int32).to(device)
    pe = None
    if pfx:
        pe = (torch.randn((batch, pfx, cfg.d_model), generator=generator,
                          device=generator.device) * 0.02).to(device)
    return toks, pe


def generate(params: dict, cfg: ModelConfig, tokens: torch.Tensor, gen: int,
             prefix_embeds: Optional[torch.Tensor] = None, capacity: Optional[int] = None):
    """Prefill, then ``gen - 1`` greedy decode steps: (B, gen) int32
    tokens on the device, the caches, and the host seconds of prefill and
    of the decode loop (the card synchronised at each end)."""
    ctx = ParallelCtx()
    B = tokens.shape[0]
    prompt_len = tokens.shape[1] + (prefix_embeds.shape[1] if prefix_embeds is not None else 0)
    shape = InputShape("serve", capacity or prompt_len + gen, B, "decode")
    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    nxt, caches = model_lib.prefill(params, cfg, ctx, tokens, shape, prefix_embeds,
                                    compute_dtype=torch.float32)
    sync()
    t_prefill = time.perf_counter() - t0
    generated = [nxt]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        nxt, caches = model_lib.decode_step(params, caches, cfg, ctx, nxt[:, None],
                                            prompt_len + i, compute_dtype=torch.float32)
        generated.append(nxt)
    sync()
    t_decode = time.perf_counter() - t0
    return torch.stack(generated, dim=1), caches, t_prefill, t_decode


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    device = torch.device(args.device)
    params = model_lib.init_params(torch.Generator(device).manual_seed(args.seed), cfg,
                                   device=device)
    toks, pe = synthetic_prompt(cfg, args.batch, args.prompt_len,
                                torch.Generator(device).manual_seed(args.seed + 1), device)
    gen, _, t_prefill, t_decode = generate(params, cfg, toks, args.gen, pe)
    gen = gen.cpu()
    out = {"prefill_s": t_prefill, "decode_s": t_decode,
           "prefill_tok_per_s": args.batch * args.prompt_len / t_prefill,
           "decode_tok_per_s": args.batch * (args.gen - 1) / max(t_decode, 1e-9),
           "tokens": gen.tolist()}
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill:.2f}s "
          f"({out['prefill_tok_per_s']:,.0f} tok/s)")
    print(f"decode: {args.gen - 1} steps in {t_decode:.2f}s "
          f"({out['decode_tok_per_s']:,.0f} tok/s)")
    print("sample:", gen[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()

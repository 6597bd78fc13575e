"""Held-out LM evaluation (counterpart of ``repro/eval/lm_eval.py``):
batched CE / perplexity over a TokenPipeline stream (a seed disjoint
from training)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm import TokenPipeline
from repro_torch.models import model as model_lib
from repro_torch.models.common import ParallelCtx


def perplexity(ce_loss: float) -> float:
    return float(math.exp(min(ce_loss, 30.0)))


def batch_to(batch: dict, device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def stream_ce(params: dict, cfg: ModelConfig, pipe: TokenPipeline, batches: int,
              device, ctx: ParallelCtx = ParallelCtx()) -> tuple[float, float]:
    """Token-weighted mean CE over the pipeline's first ``batches``
    batches, and the tokens it counted (over a model axis: ``params``
    this rank's slices, every rank of ``ctx``'s model group calling)."""
    tot_ce, tot_tok = 0.0, 0.0
    for i in range(batches):
        _, aux = model_lib.loss_fn(params, cfg, ctx, batch_to(pipe.batch(i), device))
        tot_ce += float(aux["ce_loss"]) * float(aux["n_tokens"])
        tot_tok += float(aux["n_tokens"])
    return tot_ce / max(tot_tok, 1.0), tot_tok


def evaluate_lm(params: dict, cfg: ModelConfig, *, seq_len: int = 256, batch: int = 8,
                batches: int = 4, seed: int = 9_999) -> dict:
    """Returns {"ce": mean CE, "ppl": perplexity, "tokens": n} on a held-out
    synthetic stream, on the device of ``params``."""
    ce, tokens = stream_ce(params, cfg, TokenPipeline(cfg, seq_len, batch, seed=seed), batches,
                           params["final_norm"].device)
    return {"ce": ce, "ppl": perplexity(ce), "tokens": int(tokens)}

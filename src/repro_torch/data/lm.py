"""Synthetic LM token pipeline for the transformer architectures (the
port's own numpy copy of ``repro/data/lm.py``: the same batches for the
same ``(cfg, seq_len, batch, seed, branch, step)``).

A deterministic order-1 Markov stream with per-document structure: learnable
(loss strictly decreases with training) yet generated offline with no
dataset dependency. Produces sharding-ready global batches: tokens (B, S)
and next-token labels, with frontend-prefix handling for VLM/audio archs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


def _markov_matrix(vocab: int, branch: int, seed: int) -> np.ndarray:
    """Sparse-ish row-stochastic transition structure (branch successors)."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branch))
    probs = rng.dirichlet([1.0] * branch, size=vocab)
    return succ, probs


@dataclasses.dataclass
class TokenPipeline:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 8

    def __post_init__(self):
        vocab = min(self.cfg.vocab_size, 8192)  # effective vocab of the stream
        self.effective_vocab = vocab
        self.succ, self.probs = _markov_matrix(vocab, self.branch, self.seed)
        self._cum = np.cumsum(self.probs, axis=1)

    def batch(self, step: int):
        """Deterministic global batch for `step`: dict matching
        distributed.step.batch_structs (tokens, labels[, prefix_embeds])."""
        rng = np.random.default_rng((self.seed, step))
        B = self.global_batch
        Pfx = self.cfg.frontend.prefix_len if self.cfg.frontend else 0
        S_tok = self.seq_len - Pfx
        toks = np.empty((B, S_tok + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.effective_vocab, size=B)
        r = rng.random((S_tok, B))
        for t in range(S_tok):
            cur = toks[:, t]
            choice = (r[t][:, None] > self._cum[cur]).sum(axis=1)
            toks[:, t + 1] = self.succ[cur, np.minimum(choice, self.branch - 1)]
        tokens = toks[:, :-1]
        labels_tok = toks[:, 1:]
        labels = np.concatenate(
            [np.full((B, Pfx), -1, np.int32), labels_tok], axis=1
        )
        out = {"tokens": tokens, "labels": labels}
        if Pfx:
            out["prefix_embeds"] = (
                rng.normal(size=(B, Pfx, self.cfg.d_model)).astype(np.float32) * 0.02
            )
        return out


def synthetic_token_batch(cfg: ModelConfig, seq_len: int, batch: int, seed: int = 0):
    """One-shot batch (tests / examples)."""
    return TokenPipeline(cfg, seq_len, batch, seed=seed).batch(0)

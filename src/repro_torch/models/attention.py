"""GQA attention, the training forward (counterpart of the first half of
``repro/models/attention.py``), at tp = 1.

Plain PyTorch ops mirroring the reference's einsums, with its masking as
written: scores masked to ``NEG_INF = -1e30`` (not -inf, so that a fully
masked row stays finite) before a float32 softmax; queries in blocks of
``q_chunk``; a sliding-window layer reads only the ``[block start -
window, block end)`` keys, the front padding masked by ``k_pos >= 0``.
The reference rematerializes each block (``jax.checkpoint``); remat moves
memory, not values, and is left out. The decode half (KV caches, the
ring buffer, flash-decoding) is ROADMAP.md queue A item 13.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    AttnSharding, ParallelCtx, apply_rope, dense_init, plan_attn_sharding, squeeze_tp,
)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static per-layer attention configuration."""

    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0
    window: Optional[int] = None  # sliding-window size; None = full causal
    qkv_bias: bool = False
    q_chunk: int = 256  # query-block size for the chunked train/prefill path
    scale_override: Optional[float] = None

    @property
    def scale(self) -> float:
        return self.scale_override or 1.0 / math.sqrt(self.head_dim)


def plan(spec: AttentionSpec, tp: int) -> AttnSharding:
    return plan_attn_sharding(spec.num_heads, spec.num_kv_heads, tp)


def init_params(generator: torch.Generator, spec: AttentionSpec, device="cuda") -> dict:
    """The reference's parameter layouts at tp = 1."""
    D, hd = spec.d_model, spec.head_dim
    q_dim, kv_dim = spec.num_heads * hd, spec.num_kv_heads * hd

    def init(shape, in_axis):
        return dense_init(generator, shape, in_axis=in_axis, device=device)

    p = {"wq": init((D, 1, q_dim), 0), "wkv": init((D, 1, kv_dim * 2), 0),
         "wo": init((1, q_dim, D), 1)}
    if spec.qkv_bias:
        p["bq"] = torch.zeros((1, q_dim), device=device)
        p["bkv"] = torch.zeros((1, kv_dim * 2), device=device)
    return p


def _project_qkv(params: dict, spec: AttentionSpec, sh: AttnSharding, x, positions):
    """x: (B, S, D) -> q (B,S,ql,hd), k,v (B,S,kvl,hd), rope applied."""
    hd = spec.head_dim
    q = x @ squeeze_tp(params["wq"], 1).to(x.dtype)
    kv = x @ squeeze_tp(params["wkv"], 1).to(x.dtype)
    if spec.qkv_bias:
        q = q + squeeze_tp(params["bq"], 0).to(x.dtype)
        kv = kv + squeeze_tp(params["bkv"], 0).to(x.dtype)
    B, S = x.shape[:2]
    q = q.reshape(B, S, sh.q_local, hd)
    kv = kv.reshape(B, S, sh.kv_local, 2, hd)
    k, v = kv[..., 0, :], kv[..., 1, :]
    q = apply_rope(q, positions, spec.rope_theta, spec.rotary_frac)
    k = apply_rope(k, positions, spec.rope_theta, spec.rotary_frac)
    return q, k, v


def _attend_chunk(q_blk, k, v, q_pos, k_pos, spec: AttentionSpec):
    """q_blk: (B, C, kvl, qpg, hd); k/v: (B, Sk, kvl, hd). Causal + window."""
    scores = torch.einsum("bckgh,bskh->bkgcs", q_blk, k).to(torch.float32)
    scores = scores * spec.scale
    # k_pos >= 0 masks the windowed path's front padding (zero keys whose
    # score 0 would otherwise survive the softmax)
    causal = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] >= 0)
    if spec.window is not None:
        causal = causal & (k_pos[None, :] > q_pos[:, None] - spec.window)
    scores = torch.where(causal[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q_blk.dtype)
    return torch.einsum("bkgcs,bskh->bckgh", w, v)


def forward(params: dict, spec: AttentionSpec, ctx: ParallelCtx, x: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """Training/prefill attention. x: (B, S, D) -> (B, S, D).

    Queries are processed in blocks of q_chunk; for sliding-window layers
    only the [blk_start - window, blk_end) key slice is read."""
    sh = plan(spec, ctx.tp)
    B, S, D = x.shape
    q, k, v = _project_qkv(params, spec, sh, x, positions)
    qpg = sh.q_local // sh.kv_local  # q heads per local kv head
    q = q.reshape(B, S, sh.kv_local, qpg, spec.head_dim)

    C = min(spec.q_chunk, S)
    if S % C != 0:
        C = S  # irregular (small/test) lengths: single chunk
    n_chunks = S // C

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=x.device)

    outs = []
    if spec.window is not None and spec.window < S:
        W = ((spec.window + C - 1) // C) * C  # pad window to chunk multiple
        k_pad = F.pad(k, (0, 0, 0, 0, W, 0))
        v_pad = F.pad(v, (0, 0, 0, 0, W, 0))
        for i in range(n_chunks):
            c0 = i * C
            q_pos = c0 + arange(C)
            k_pos = c0 - W + arange(W + C)  # negatives are padding -> masked
            outs.append(_attend_chunk(q[:, c0:c0 + C], k_pad[:, c0:c0 + W + C],
                                      v_pad[:, c0:c0 + W + C], q_pos, k_pos, spec))
    else:
        k_pos = arange(S)
        for i in range(n_chunks):
            c0 = i * C
            outs.append(_attend_chunk(q[:, c0:c0 + C], k, v, c0 + arange(C), k_pos, spec))
    out = torch.cat(outs, dim=1).reshape(B, S, sh.q_local * spec.head_dim)

    y = out @ squeeze_tp(params["wo"], 0).to(out.dtype)
    y = ctx.sp_scatter(y)
    if sh.dup_attn > 1:
        y = y / sh.dup_attn
    return y

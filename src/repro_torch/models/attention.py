"""GQA attention (counterpart of ``repro/models/attention.py``): the
chunked causal forward (training and prefill), tensor-parallel over the
model axis, and the KV-cache decode.

Plain PyTorch ops mirroring the reference's einsums and casts: each
weight cast to the activations' dtype before its product, the scores
cast to float32 and masked to ``NEG_INF = -1e30`` (not -inf, so that a
fully masked row stays finite) before a float32 softmax, the weights
cast back to the values' dtype; queries in blocks of ``q_chunk``; a
sliding-window layer reads only the ``[block start - window, block
end)`` keys, the front padding masked by ``k_pos >= 0``. The reference
also rematerializes each query block (``jax.checkpoint``); that moves
memory, not values, and is left to the model's per-block remat.

A decode cache is a dict of ``k`` and ``v``, each (B, tp, kvl, S, hd),
of the compute dtype or int8 codes with bfloat16 per-token ``k_scale``/``v_scale``.
Where the reference's ``dynamic_update_slice`` returns new caches,
``decode`` writes the new token into the cache's buffers IN PLACE (a
step at full width would otherwise copy every cache) and returns the
same dict: a cache is not to be reused after the step that wrote it.
Over a model axis of tp, a rank holds ``q_local`` query heads and
``kv_local`` KV heads (``plan_attn_sharding``); where the heads do not
cover the axis, the global parameters hold each slice ``dup_attn``
(``dup_kv``) times, and the out-projection's psum is divided by
``dup_attn``. Flash-decoding (``decode(seq_sharded=True)``): a cache's
sequence dim sharded over the seq axis (``ParallelCtx.seq_axis``, the
client axes), each shard attends over its own keys and the partial
softmaxes combine by a max and a sum over the axis.
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
from repro_torch.models.meta import Meta

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


def init_params(generator: torch.Generator, spec: AttentionSpec, device="cuda", tp: int = 1,
                keep=None, dtype=torch.float32) -> dict:
    """The reference's global parameters at ``tp``, of ``dtype``: distinct
    content per ``tp_attn`` query slice (``kv_shards`` KV slice),
    repeated over the duplicates. ``keep(t, meta)``, if given, takes each
    leaf as it is drawn (``meta.slicer``: a rank's slice)."""
    sh = plan(spec, tp)
    meta = param_meta(spec, tp, dtype)
    D, hd = spec.d_model, spec.head_dim

    def init(name, shape, in_axis, repeat, axis):
        t = dense_init(generator, shape, in_axis=in_axis, device=device, dtype=dtype)
        if repeat > 1:
            t = t.repeat_interleave(repeat, dim=axis)
        return t if keep is None else keep(t, meta[name])

    def zeros(name):
        t = torch.zeros(meta[name].shape, dtype=dtype, device=device)
        return t if keep is None else keep(t, meta[name])

    p = {"wq": init("wq", (D, sh.tp_attn, sh.q_local * hd), 0, sh.dup_attn, 1),
         "wkv": init("wkv", (D, sh.kv_shards, sh.kv_local * hd * 2), 0,
                     sh.dup_kv * sh.dup_attn, 1),
         "wo": init("wo", (sh.tp_attn, sh.q_local * hd, D), 1, sh.dup_attn, 0)}
    if spec.qkv_bias:
        p["bq"] = zeros("bq")
        p["bkv"] = zeros("bkv")
    return p


def param_meta(spec: AttentionSpec, tp: int = 1, dtype=torch.float32) -> dict:
    """Mirrors init_params: (global_shape, dtype, pspec, sync_group)."""
    sh = plan(spec, tp)
    D, hd = spec.d_model, spec.head_dim
    m = {
        "wq": Meta((D, tp, sh.q_local * hd), dtype, (None, "model", None), sh.dup_attn),
        "wkv": Meta((D, tp, sh.kv_local * hd * 2), dtype, (None, "model", None), sh.kv_group),
        "wo": Meta((tp, sh.q_local * hd, D), dtype, ("model", None, None), sh.dup_attn),
    }
    if spec.qkv_bias:
        m["bq"] = Meta((tp, sh.q_local * hd), dtype, ("model", None), sh.dup_attn)
        m["bkv"] = Meta((tp, sh.kv_local * hd * 2), dtype, ("model", None), sh.kv_group)
    return m


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
    q, k, v = _project_qkv(params, spec, sh, x, positions)
    return _attend(params, spec, ctx, sh, q, k, v)


def _attend(params: dict, spec: AttentionSpec, ctx: ParallelCtx, sh: AttnSharding,
            q, k, v) -> torch.Tensor:
    """The chunked causal attention and output projection of ``forward``
    on projected q (B,S,ql,hd), k, v (B,S,kvl,hd)."""
    B, S = q.shape[:2]
    qpg = sh.q_local // sh.kv_local  # q heads per local kv head
    q = q.reshape(B, S, sh.kv_local, qpg, spec.head_dim)

    C = min(spec.q_chunk, S)
    if S % C != 0:
        C = S  # irregular (small/test) lengths: single chunk
    n_chunks = S // C

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=q.device)

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


# ---------------------------------------------------------------------------
# Decode (serve): one new token against a KV cache
# ---------------------------------------------------------------------------


def init_cache_shape(spec: AttentionSpec, tp: int, batch: int, max_len: int) -> dict:
    sh = plan(spec, tp)
    return {
        "k": (batch, tp, sh.kv_local, max_len, spec.head_dim),
        "v": (batch, tp, sh.kv_local, max_len, spec.head_dim),
    }


def quant_kv(x: torch.Tensor):
    """(..., hd) -> (int8 codes, per-vector bfloat16 scale): symmetric
    per-token quantization, ``x / scale`` rounded half to even and clipped
    to +-127, ``scale = max(|x|, 1e-8) / 127``."""
    x = x.to(torch.float32)
    # divide by a device tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not IEEE division
    levels = torch.full((), 127.0, device=x.device)
    scale = x.abs().amax(-1, keepdim=True).clamp(min=1e-8) / levels
    q = torch.round(x / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def _cache_read(cache: dict, prefix: str, dtype) -> torch.Tensor:
    """Read k or v from a cache dict, dequantizing if stored int8."""
    buf = squeeze_tp(cache[prefix], 1)
    if buf.dtype == torch.int8:
        return dequant_kv(buf, squeeze_tp(cache[prefix + "_scale"], 1), dtype)
    return buf


def _cache_write(cache: dict, prefix: str, new: torch.Tensor, idx: int, *,
                 masked_write: Optional[torch.Tensor] = None) -> None:
    """Write one token ``new`` (B, kvl, 1, hd) at sequence index ``idx``
    into the cache's buffers in place, quantizing if the cache is int8.
    Where the boolean ``masked_write`` is False the old entry stays."""
    buf = squeeze_tp(cache[prefix], 1)  # (B, kvl, S, hd), a view
    if buf.dtype == torch.int8:
        q, s = quant_kv(new)
        sc = squeeze_tp(cache[prefix + "_scale"], 1)
        if masked_write is not None:
            q = torch.where(masked_write, q, buf[:, :, idx:idx + 1])
            s = torch.where(masked_write, s, sc[:, :, idx:idx + 1])
        buf[:, :, idx:idx + 1] = q
        sc[:, :, idx:idx + 1] = s
        return
    new = new.to(buf.dtype)
    if masked_write is not None:
        new = torch.where(masked_write, new, buf[:, :, idx:idx + 1])
    buf[:, :, idx:idx + 1] = new


def _attend_cache(params: dict, spec: AttentionSpec, ctx: ParallelCtx, sh: AttnSharding,
                  q: torch.Tensor, cache: dict, valid: torch.Tensor, *,
                  seq_combine: bool = False) -> torch.Tensor:
    """One query (B, kvl, qpg, hd) against the cache's keys where
    ``valid`` (S,), then the output projection: (B, 1, D). With
    ``seq_combine`` the keys are this shard's of a sequence-sharded cache,
    and the shards' partial softmaxes combine over the seq axis
    (flash-decoding): the max of the local maxima, then each shard's
    ``exp(scores - max)``-weighted values and exp-sum, summed over the
    axis (in one collective), divided."""
    B = q.shape[0]
    k_cache = _cache_read(cache, "k", q.dtype)  # (B, kvl, S, hd)
    v_cache = _cache_read(cache, "v", q.dtype)
    scores = torch.einsum("bkgh,bksh->bkgs", q, k_cache).to(torch.float32) * spec.scale
    scores = torch.where(valid[None, None, None], scores, NEG_INF)
    if seq_combine:
        m = ctx.pmax_seq(scores.amax(-1, keepdim=True))
        e = torch.exp(scores - m)
        num = torch.einsum("bkgs,bksh->bkgh", e.to(v_cache.dtype), v_cache)
        den = e.sum(-1, keepdim=True).to(v_cache.dtype)
        both = ctx.psum_seq(torch.cat([num, den], dim=-1))
        attn = both[..., :-1] / both[..., -1:]
    else:
        w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
        attn = torch.einsum("bkgs,bksh->bkgh", w, v_cache)
    attn = attn.reshape(B, 1, sh.q_local * spec.head_dim)
    y = attn @ squeeze_tp(params["wo"], 0).to(attn.dtype)
    y = ctx.psum_model(y)
    if sh.dup_attn > 1:
        y = y / sh.dup_attn
    return y


def decode(params: dict, spec: AttentionSpec, ctx: ParallelCtx, x: torch.Tensor,
           cache: dict, pos: int, *, seq_sharded: bool = False):
    """One decode step. x: (B, 1, D); cache entries (B, 1(tp), kvl, S, hd)
    locally; pos: the number of tokens already in the cache. Writes the
    token's k/v at ``pos`` in place; returns (y (B,1,D), cache).

    seq_sharded: the cache's S dim is sharded over ``ctx.seq_axis``, shard
    i holding keys ``[i S, (i+1) S)``. The shard whose slice holds ``pos``
    writes the token; every other shard keeps its entry (a masked write).
    Without a seq axis this is the plain decode."""
    sh = plan(spec, ctx.tp)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, spec, sh, x, positions)
    q = q.reshape(B, sh.kv_local, sh.q_local // sh.kv_local, spec.head_dim)
    S_local = cache["k"].shape[3]
    k_pos = torch.arange(S_local, device=x.device)
    if seq_sharded:
        shard = ctx.seq_index()
        local = pos - shard * S_local
        write = torch.full((), 0 <= local < S_local, dtype=torch.bool, device=x.device)
        idx = min(max(local, 0), S_local - 1)
        _cache_write(cache, "k", k_new.transpose(1, 2), idx, masked_write=write)
        _cache_write(cache, "v", v_new.transpose(1, 2), idx, masked_write=write)
        k_pos = k_pos + shard * S_local
    else:
        _cache_write(cache, "k", k_new.transpose(1, 2), pos)
        _cache_write(cache, "v", v_new.transpose(1, 2), pos)
    valid = k_pos <= pos
    if spec.window is not None:
        valid = valid & (k_pos > pos - spec.window)
    y = _attend_cache(params, spec, ctx, sh, q, cache, valid,
                      seq_combine=seq_sharded and ctx.seq_axis is not None)
    return y, cache


def prefill_kv(params: dict, spec: AttentionSpec, ctx: ParallelCtx, x: torch.Tensor,
               positions: torch.Tensor, max_len: int):
    """The causal forward of a whole prompt, and its k/v laid out as a
    decode cache of ``max_len`` positions (zero past the prompt).
    Returns (attn_out, cache)."""
    sh = plan(spec, ctx.tp)
    S = x.shape[1]
    q, k, v = _project_qkv(params, spec, sh, x, positions)
    # this rank's cache: its kv_local heads, the tp axis of 1
    cache = {name: k.new_zeros((shape[0], 1) + shape[2:])
             for name, shape in init_cache_shape(spec, ctx.tp, x.shape[0], max_len).items()}
    squeeze_tp(cache["k"], 1)[:, :, :S] = k.transpose(1, 2)
    squeeze_tp(cache["v"], 1)[:, :, :S] = v.transpose(1, 2)
    y = _attend(params, spec, ctx, sh, q, k, v)
    return y, cache

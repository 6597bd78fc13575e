"""Model assembly (counterpart of ``repro/models/model.py``): embedding
-> blocks (attn / ssm / shared_attn, mlp / moe) -> the vocab-parallel,
sequence-chunked LM head loss, tensor-parallel over the model axis; and
the serving path (``prefill``, ``decode_step``, greedy
``lm_head_argmax``) at tp = 1.

Parameter tree (the reference's; on a rank the ``tp`` axes are of size 1):
  embed:      (tp, V_l, D)  vocab-parallel table
  layers[i]:  {"norm1", "attn"/"ssm", ["norm2", "mlp"/"moe"]}; a
              'shared_attn' layer is {} (its params live in "shared")
  shared:     one attention+MLP block reused by every 'shared_attn' layer
  final_norm: (D,)
  lm_head:    (D, tp, V_l)  column-parallel

With sequence parallelism the residual stream between blocks is (B,
S/tp, D): ``sp_slice`` enters it after the embedding, each block
all-gathers on entry and psum_scatters on exit. Everything computes in float32, the compute dtype the reference's lm task
passes. The reference's remat (``jax.checkpoint`` of blocks and CE
chunks) moves memory, not values, and is left out
(``torch.utils.checkpoint`` does not compose with ``torch.func``).

Serving: ``prefill`` runs a prompt and builds one cache a layer (an
attention layer's k/v, a sliding-window layer's as a ring buffer of
``min(capacity, window)`` slots; an SSM layer's recurrent state), and
``decode_step`` feeds one token a step, writing those caches IN PLACE
and returning them (the reference returns new ones). ``cache_meta``, the
caches' sharding over a mesh (and with it the int8 KV layout), and
greedy decoding over a model axis (``lm_head_argmax``'s pmin) are
ROADMAP.md queue A item 13.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import InputShape, LayerSpec, ModelConfig
from repro_torch.models import attention, mlp, moe, ssm
from repro_torch.models.common import ParallelCtx, dense_init, rms_norm, squeeze_tp
from repro_torch.models.meta import Meta


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: ModelConfig, layer: LayerSpec, device, tp: int, keep):
    D = cfg.d_model
    if layer.kind == "shared_attn":
        return {}  # params live in the shared block
    p = {"norm1": torch.zeros((D,), device=device)}
    if layer.kind == "ssm":
        p["ssm"] = ssm.init_params(generator, cfg.ssm, device, tp, keep)
        return p
    p["attn"] = attention.init_params(generator, cfg.attn_spec(layer), device, tp, keep)
    p["norm2"] = torch.zeros((D,), device=device)
    if cfg.moe is not None:
        p["moe"] = moe.init_params(generator, cfg.moe, device, tp, keep)
    elif cfg.mlp_kind is not None:
        p["mlp"] = mlp.init_params(generator, cfg.mlp_kind, D, cfg.d_ff, device, tp, keep)
    return p


def _layer_meta(cfg: ModelConfig, layer: LayerSpec, tp: int) -> dict:
    D = cfg.d_model
    m = {"norm1": Meta((D,), torch.float32, (None,), tp)}
    if layer.kind == "ssm":
        m["ssm"] = ssm.param_meta(cfg.ssm, tp)
        return m
    if layer.kind == "shared_attn":
        return {}
    m["attn"] = attention.param_meta(cfg.attn_spec(layer), tp)
    m["norm2"] = Meta((D,), torch.float32, (None,), tp)
    if cfg.moe is not None:
        m["moe"] = moe.param_meta(cfg.moe, tp)
    elif cfg.mlp_kind is not None:
        m["mlp"] = mlp.param_meta(cfg.mlp_kind, D, cfg.d_ff, tp)
    return m


def _shared_layerspec(cfg: ModelConfig) -> LayerSpec:
    for layer in cfg.layers:
        if layer.kind == "shared_attn":
            return layer
    raise ValueError("no shared_attn layer in config")


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda", tp: int = 1,
                keep=None) -> dict:
    """Random float32 parameters of the reference's global shapes at
    ``tp``, drawn from ``generator`` on its device leaf by leaf (the
    reference draws from ``jax.random``: values differ, shapes and the
    special leaves do not). ``keep(t, meta)``, if given, takes each
    sharded leaf as it is drawn: ``meta.slicer(tp, index)`` keeps model
    rank ``index``'s slice, so that a rank never holds the global tree
    and every rank draws the same one."""
    D = cfg.d_model
    meta = param_meta(cfg, tp)

    def init(name, in_axis):
        t = dense_init(generator, meta[name].shape, in_axis=in_axis, device=device)
        return t if keep is None else keep(t, meta[name])

    params = {
        "embed": init("embed", 2),
        "layers": tuple(_layer_init(generator, cfg, layer, device, tp, keep)
                        for layer in cfg.layers),
        "final_norm": torch.zeros((D,), device=device),
    }
    if cfg.shared_attn:
        spec = cfg.attn_spec(_shared_layerspec(cfg))
        params["shared"] = {
            "norm1": torch.zeros((D,), device=device),
            "attn": attention.init_params(generator, spec, device, tp, keep),
            "norm2": torch.zeros((D,), device=device),
            "mlp": mlp.init_params(generator, cfg.mlp_kind, D, cfg.shared_d_ff, device, tp,
                                   keep),
        }
    params["lm_head"] = init("lm_head", 0)
    return params


def param_meta(cfg: ModelConfig, tp: int = 1) -> dict:
    """The Meta tree of ``init_params``' parameters (``models/meta.py``)."""
    D = cfg.d_model
    V = cfg.padded_vocab(tp)
    m = {
        "embed": Meta((tp, V // tp, D), torch.float32, ("model", None, None), 1),
        "layers": tuple(_layer_meta(cfg, layer, tp) for layer in cfg.layers),
        "final_norm": Meta((D,), torch.float32, (None,), tp),
        "lm_head": Meta((D, tp, V // tp), torch.float32, (None, "model", None), 1),
    }
    if cfg.shared_attn:
        spec = cfg.attn_spec(_shared_layerspec(cfg))
        m["shared"] = {
            "norm1": Meta((D,), torch.float32, (None,), tp),
            "attn": attention.param_meta(spec, tp),
            "norm2": Meta((D,), torch.float32, (None,), tp),
            "mlp": mlp.param_meta(cfg.mlp_kind, D, cfg.shared_d_ff, tp),
        }
    return m


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed(params: dict, cfg: ModelConfig, ctx: ParallelCtx, tokens: torch.Tensor):
    """tokens (B, S) -> (B, S, D): the rank's rows of the table, psummed
    over the model axis."""
    table = squeeze_tp(params["embed"], 0)  # (V_l, D)
    v_l = table.shape[0]
    ids = tokens.to(torch.int64) - ctx.model_index() * v_l
    valid = (ids >= 0) & (ids < v_l)
    emb = table[ids.clamp(0, v_l - 1)]
    emb = torch.where(valid[..., None], emb, 0)
    return ctx.psum_model(emb)


def lm_head_loss(params: dict, cfg: ModelConfig, ctx: ParallelCtx, h: torch.Tensor,
                 labels: torch.Tensor, *, seq_chunk: int = 512):
    """Vocab-parallel cross entropy over the PADDED vocab (its extra
    columns take part in the log-sum-exp). h: (B, S, D); labels: (B, S),
    positions with label < 0 masked out. Returns (mean_loss, n_tokens).
    A rank makes its (B, chunk, V/tp) logits a sequence chunk at a time;
    the log-sum-exp and the target logit combine over the model axis by
    pmax (of a value no gradient flows through) and psum."""
    head = squeeze_tp(params["lm_head"], 1)  # (D, V_l)
    v_l = head.shape[1]
    lo = ctx.model_index() * v_l
    B, S, _ = h.shape
    cs = min(seq_chunk, S)
    n_chunks = S // cs if S % cs == 0 else 1
    if S % cs != 0:
        cs = S
    labels = labels.to(torch.int64)

    def chunk_loss(h_c, labels_c):  # (B, cs, D), (B, cs)
        logits = (h_c @ head.to(h_c.dtype)).to(torch.float32)
        # the max is only a stabilization shift: no gradient through it
        mx = ctx.pmax_model(logits.amax(-1, keepdim=True).detach())
        sumexp = torch.exp(logits - mx).sum(-1)
        lse = torch.log(ctx.psum_model(sumexp)) + mx[..., 0]
        ids = labels_c - lo
        valid = (ids >= 0) & (ids < v_l)
        tgt_local = logits.gather(-1, ids.clamp(0, v_l - 1)[..., None])[..., 0]
        tgt = ctx.psum_model(torch.where(valid, tgt_local, 0.0))
        mask = (labels_c >= 0).to(torch.float32)
        return ((lse - tgt) * mask).sum()

    per_chunk = torch.stack([chunk_loss(h[:, i * cs:(i + 1) * cs], labels[:, i * cs:(i + 1) * cs])
                             for i in range(n_chunks)])
    mask = (labels >= 0).to(torch.float32)
    n_tok = mask.sum().clamp(min=1.0)
    return per_chunk.sum() / n_tok, n_tok


def lm_head_argmax(params: dict, ctx: ParallelCtx, h: torch.Tensor) -> torch.Tensor:
    """Greedy next token. h: (B, D) -> (B,) int32; among equal logits the
    smallest id (``torch.argmax`` returns the first maximum)."""
    if ctx.model:
        raise NotImplementedError(
            "greedy decoding over a model axis (lm_head_argmax's pmin over it) is not "
            "ported yet: ROADMAP.md queue A item 13")
    head = squeeze_tp(params["lm_head"], 1)
    logits = (h @ head.to(h.dtype)).to(torch.float32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _block_apply(layer_params: dict, shared_params: Optional[dict], cfg: ModelConfig,
                 layer: LayerSpec, ctx: ParallelCtx, x: torch.Tensor, positions):
    if layer.kind == "ssm":
        h = ctx.sp_gather(rms_norm(x, layer_params["norm1"]))
        return x + ssm.forward(layer_params["ssm"], cfg.ssm, ctx, h), None
    p = shared_params if layer.kind == "shared_attn" else layer_params
    spec = cfg.attn_spec(layer)
    h = ctx.sp_gather(rms_norm(x, p["norm1"]))
    x = x + attention.forward(p["attn"], spec, ctx, h, positions)
    h = ctx.sp_gather(rms_norm(x, p["norm2"]))
    aux = None
    if layer.kind != "shared_attn" and cfg.moe is not None:
        y, aux = moe.forward(layer_params["moe"], cfg.moe, ctx, h)
    else:
        y = mlp.forward(p["mlp"], cfg.mlp_kind, ctx, h)
    return x + y, aux


def forward_hidden(params: dict, cfg: ModelConfig, ctx: ParallelCtx, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor] = None):
    """tokens (B, S_t); prefix_embeds (B, P, D) or None -> hidden (B, S, D)
    with S = P + S_t, and the summed MoE aux loss."""
    x = embed(params, cfg, ctx, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds, x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x = ctx.sp_slice(x)

    aux_losses = []
    for layer_params, layer in zip(params["layers"], cfg.layers):
        x, aux = _block_apply(layer_params, params.get("shared"), cfg, layer, ctx, x,
                              positions)
        if aux is not None:
            aux_losses.append(aux["moe_aux_loss"])
    x = ctx.sp_gather(rms_norm(x, params["final_norm"]))
    moe_aux = sum(aux_losses) if aux_losses else torch.zeros((), device=x.device)
    return x, {"moe_aux_loss": moe_aux}


def loss_fn(params: dict, cfg: ModelConfig, ctx: ParallelCtx, batch: dict):
    """Next-token CE (+ MoE aux). batch: {"tokens", "labels"[,
    "prefix_embeds"]}; labels align with the FULL sequence (prefix
    positions carry -1)."""
    h, aux = forward_hidden(params, cfg, ctx, batch["tokens"], batch.get("prefix_embeds"))
    loss, n_tok = lm_head_loss(params, cfg, ctx, h, batch["labels"])
    total = loss + aux["moe_aux_loss"]
    return total, {"ce_loss": loss, "n_tokens": n_tok, **aux}


# ---------------------------------------------------------------------------
# Serving: prefill, decode
# ---------------------------------------------------------------------------


def _mlp_or_moe(layer_params: dict, p: dict, cfg: ModelConfig, layer: LayerSpec,
                ctx: ParallelCtx, h: torch.Tensor, *, decode: bool) -> torch.Tensor:
    if layer.kind != "shared_attn" and cfg.moe is not None:
        return moe.forward(layer_params["moe"], cfg.moe, ctx, h, decode=decode)[0]
    return mlp.forward(p["mlp"], cfg.mlp_kind, ctx, h)


def decode_step(params: dict, caches: tuple, cfg: ModelConfig, ctx: ParallelCtx,
                tokens: torch.Tensor, pos: int):
    """One decode step. tokens (B, 1); pos: the tokens already in the
    caches. Writes the caches in place; returns (next_token (B,), caches)."""
    x = embed(params, cfg, ctx, tokens)
    for layer_params, layer, cache in zip(params["layers"], cfg.layers, caches):
        if layer.kind == "ssm":
            h = rms_norm(x, layer_params["norm1"])
            x = x + ssm.decode(layer_params["ssm"], cfg.ssm, ctx, h, cache)[0]
            continue
        p = params.get("shared") if layer.kind == "shared_attn" else layer_params
        spec = cfg.attn_spec(layer)
        S_c = cache["k"].shape[3]
        h = rms_norm(x, p["norm1"])
        if layer.window is not None and S_c <= layer.window:
            # ring-buffer window cache: write at pos % window
            y, _ = _decode_ring(p["attn"], spec, ctx, h, cache, pos, S_c)
        else:
            y, _ = attention.decode(p["attn"], spec, ctx, h, cache, pos)
        x = x + y
        h = rms_norm(x, p["norm2"])
        x = x + _mlp_or_moe(layer_params, p, cfg, layer, ctx, h, decode=True)
    x = rms_norm(x, params["final_norm"])
    return lm_head_argmax(params, ctx, x[:, 0]), caches


def _decode_ring(attn_params: dict, spec, ctx: ParallelCtx, x: torch.Tensor, cache: dict,
                 pos: int, window: int) -> torch.Tensor:
    """Sliding-window decode against a ring-buffer cache of ``window``
    slots, the token written at slot ``pos % window``; the keys' absolute
    positions are rebuilt from the write pointer. Writes the cache in
    place; returns (y (B, 1, D), cache)."""
    sh = attention.plan(spec, ctx.tp)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = attention._project_qkv(attn_params, spec, sh, x, positions)
    q = q.reshape(B, sh.kv_local, sh.q_local // sh.kv_local, spec.head_dim)
    slot = pos % window
    attention._cache_write(cache, "k", k_new.transpose(1, 2), slot)
    attention._cache_write(cache, "v", v_new.transpose(1, 2), slot)
    # absolute position of ring slot s: the most recent write to that slot
    slots = torch.arange(window, device=x.device)
    abs_pos = torch.where(slots <= slot, pos - slot + slots, pos - slot - window + slots)
    valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - window)
    return attention._attend_cache(attn_params, spec, ctx, sh, q, cache, valid), cache


def prefill(params: dict, cfg: ModelConfig, ctx: ParallelCtx, tokens: torch.Tensor,
            shape: InputShape, prefix_embeds: Optional[torch.Tensor] = None):
    """Run the prompt through the model, building the decode caches for
    ``shape.seq_len`` positions (prompt and generation). tokens (B, S_t);
    prefix_embeds (B, P, D) or None. Returns (next_token (B,), caches)."""
    x = embed(params, cfg, ctx, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x = ctx.sp_slice(x)
    caches = []
    for layer_params, layer in zip(params["layers"], cfg.layers):
        if layer.kind == "ssm":
            h = ctx.sp_gather(rms_norm(x, layer_params["norm1"]))
            y, state = ssm.forward(layer_params["ssm"], cfg.ssm, ctx, h, return_state=True)
            x = x + y
            caches.append({k: t.to(torch.float32) for k, t in state.items()})
            continue
        p = params.get("shared") if layer.kind == "shared_attn" else layer_params
        spec = cfg.attn_spec(layer)
        S_c = shape.seq_len if layer.window is None else min(shape.seq_len, layer.window)
        h = ctx.sp_gather(rms_norm(x, p["norm1"]))
        y, cache = attention.prefill_kv(p["attn"], spec, ctx, h, positions,
                                        max_len=max(S_c, S))
        if layer.window is not None and S_c < S:
            # re-lay the last S_c keys into ring order (key p at slot
            # p % S_c), the invariant _decode_ring reads
            idx = [0] * S_c
            for pos_abs in range(S - S_c, S):
                idx[pos_abs % S_c] = pos_abs
            idx = torch.tensor(idx, dtype=torch.int64, device=x.device)
            cache = {k: t.index_select(3, idx) for k, t in cache.items()}
        x = x + y
        h = ctx.sp_gather(rms_norm(x, p["norm2"]))
        x = x + _mlp_or_moe(layer_params, p, cfg, layer, ctx, h, decode=False)
        caches.append(cache)
    x = ctx.sp_gather(rms_norm(x, params["final_norm"]))
    return lm_head_argmax(params, ctx, x[:, -1]), tuple(caches)

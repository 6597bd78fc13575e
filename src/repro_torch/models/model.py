"""Model assembly (counterpart of ``repro/models/model.py``): embedding
-> blocks (attn / ssm / shared_attn, mlp / moe) -> the vocab-parallel,
sequence-chunked LM head loss, tensor-parallel over the model axis; and
the serving path (``cache_meta``, ``prefill``, ``decode_step``, greedy
``lm_head_argmax``), over a model axis and, for long-context decode, a
sequence-sharded cache.

Parameter tree (the reference's; on a rank the ``tp`` axes are of size 1):
  embed:      (tp, V_l, D)  vocab-parallel table
  layers[i]:  {"norm1", "attn"/"ssm", ["norm2", "mlp"/"moe"]}; a
              'shared_attn' layer is {} (its params live in "shared")
  shared:     one attention+MLP block reused by every 'shared_attn' layer
  final_norm: (D,)
  lm_head:    (D, tp, V_l)  column-parallel

With sequence parallelism the residual stream between blocks is (B,
S/tp, D): ``sp_slice`` enters it after the embedding, each block
all-gathers on entry and psum_scatters on exit. The residual stream
computes in ``compute_dtype`` (the reference's defaults: float32 for
``forward_hidden``, bfloat16 for ``loss_fn``, ``prefill`` and
``decode_step``; the lm task and the launchers pass float32), each
weight cast to it before its product, norms, softmaxes, the router and
the SSD scan in float32. ``remat`` checkpoints each block
(``torch.utils.checkpoint``, non-reentrant: nothing inside a block is
saved, its forward runs again in the backward, as the reference's
``jax.checkpoint`` with ``nothing_saveable``), and each sequence chunk
of the loss (``lm_head_loss``, which the reference checkpoints always);
it moves memory, not values. It does not compose with ``torch.func`` (the lm task's
``vmap(grad)``), whose callers pass ``remat=False`` as the reference's
do.

Serving: ``prefill`` runs a prompt and builds one cache a layer (an
attention layer's k/v, a sliding-window layer's as a ring buffer of
``min(capacity, window)`` slots; an SSM layer's recurrent state), and
``decode_step`` feeds one token a step, writing those caches IN PLACE
and returning them (the reference returns new ones). ``cache_meta`` lays
the caches out over a mesh (batch-sharded over the client axes, or at
batch 1 a full-attention layer's cache sharded on its sequence dim for
flash-decoding), of the compute dtype (the SSM state ``h`` float32) or
int8 K/V codes with bfloat16 per-token scales.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import InputShape, LayerSpec, ModelConfig
from repro_torch.models import attention, mlp, moe, ssm
from repro_torch.models.common import ParallelCtx, dense_init, rms_norm, squeeze_tp
from repro_torch.models.meta import Meta


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: ModelConfig, layer: LayerSpec, device, tp: int, keep, dtype):
    D = cfg.d_model
    if layer.kind == "shared_attn":
        return {}  # params live in the shared block
    p = {"norm1": torch.zeros((D,), dtype=dtype, device=device)}
    if layer.kind == "ssm":
        p["ssm"] = ssm.init_params(generator, cfg.ssm, device, tp, keep, dtype)
        return p
    p["attn"] = attention.init_params(generator, cfg.attn_spec(layer), device, tp, keep, dtype)
    p["norm2"] = torch.zeros((D,), dtype=dtype, device=device)
    if cfg.moe is not None:
        p["moe"] = moe.init_params(generator, cfg.moe, device, tp, keep, dtype)
    elif cfg.mlp_kind is not None:
        p["mlp"] = mlp.init_params(generator, cfg.mlp_kind, D, cfg.d_ff, device, tp, keep,
                                   dtype)
    return p


def _layer_meta(cfg: ModelConfig, layer: LayerSpec, tp: int, dtype) -> dict:
    D = cfg.d_model
    m = {"norm1": Meta((D,), dtype, (None,), tp)}
    if layer.kind == "ssm":
        m["ssm"] = ssm.param_meta(cfg.ssm, tp, dtype)
        return m
    if layer.kind == "shared_attn":
        return {}
    m["attn"] = attention.param_meta(cfg.attn_spec(layer), tp, dtype)
    m["norm2"] = Meta((D,), dtype, (None,), tp)
    if cfg.moe is not None:
        m["moe"] = moe.param_meta(cfg.moe, tp, dtype)
    elif cfg.mlp_kind is not None:
        m["mlp"] = mlp.param_meta(cfg.mlp_kind, D, cfg.d_ff, tp, dtype)
    return m


def _shared_layerspec(cfg: ModelConfig) -> LayerSpec:
    for layer in cfg.layers:
        if layer.kind == "shared_attn":
            return layer
    raise ValueError("no shared_attn layer in config")


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda", tp: int = 1,
                keep=None, dtype=torch.float32) -> dict:
    """Random parameters of the reference's global shapes at ``tp``, of
    ``dtype`` (the MoE router and the SSM's ``A_log``, ``D_skip`` and
    ``dt_bias`` float32 always), drawn in float32 from ``generator`` on
    its device leaf by leaf and cast (the reference draws from
    ``jax.random``: values differ, shapes and the special leaves do not).
    ``keep(t, meta)``, if given, takes each sharded leaf as it is drawn:
    ``meta.slicer(tp, index)`` keeps model rank ``index``'s slice, so that
    a rank never holds the global tree and every rank draws the same one."""
    D = cfg.d_model
    meta = param_meta(cfg, tp, dtype)

    def init(name, in_axis):
        t = dense_init(generator, meta[name].shape, in_axis=in_axis, device=device, dtype=dtype)
        return t if keep is None else keep(t, meta[name])

    def zeros():
        return torch.zeros((D,), dtype=dtype, device=device)

    params = {
        "embed": init("embed", 2),
        "layers": tuple(_layer_init(generator, cfg, layer, device, tp, keep, dtype)
                        for layer in cfg.layers),
        "final_norm": zeros(),
    }
    if cfg.shared_attn:
        spec = cfg.attn_spec(_shared_layerspec(cfg))
        params["shared"] = {
            "norm1": zeros(),
            "attn": attention.init_params(generator, spec, device, tp, keep, dtype),
            "norm2": zeros(),
            "mlp": mlp.init_params(generator, cfg.mlp_kind, D, cfg.shared_d_ff, device, tp,
                                   keep, dtype),
        }
    params["lm_head"] = init("lm_head", 0)
    return params


def param_meta(cfg: ModelConfig, tp: int = 1, dtype=torch.float32) -> dict:
    """The Meta tree of ``init_params``' parameters (``models/meta.py``)."""
    D = cfg.d_model
    V = cfg.padded_vocab(tp)
    m = {
        "embed": Meta((tp, V // tp, D), dtype, ("model", None, None), 1),
        "layers": tuple(_layer_meta(cfg, layer, tp, dtype) for layer in cfg.layers),
        "final_norm": Meta((D,), dtype, (None,), tp),
        "lm_head": Meta((D, tp, V // tp), dtype, (None, "model", None), 1),
    }
    if cfg.shared_attn:
        spec = cfg.attn_spec(_shared_layerspec(cfg))
        m["shared"] = {
            "norm1": Meta((D,), dtype, (None,), tp),
            "attn": attention.param_meta(spec, tp, dtype),
            "norm2": Meta((D,), dtype, (None,), tp),
            "mlp": mlp.param_meta(cfg.mlp_kind, D, cfg.shared_d_ff, tp, dtype),
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
                 labels: torch.Tensor, *, seq_chunk: int = 512, remat: bool = False):
    """Vocab-parallel cross entropy over the PADDED vocab (its extra
    columns take part in the log-sum-exp). h: (B, S, D); labels: (B, S),
    positions with label < 0 masked out. Returns (mean_loss, n_tokens).
    A rank makes its (B, chunk, V/tp) logits a sequence chunk at a time;
    the log-sum-exp and the target logit combine over the model axis by
    pmax (of a value no gradient flows through) and psum. ``remat``: each
    chunk checkpointed, as the reference checkpoints every chunk (its
    logits made again in the backward, so one chunk's live at a time);
    off, every chunk's logits are kept for the backward (``torch.func``'s
    transforms, which the lm task's ``vmap(grad)`` is, take no
    checkpoint)."""
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

    def run(h_c, labels_c):
        if remat:
            return checkpoint(chunk_loss, h_c, labels_c, use_reentrant=False)
        return chunk_loss(h_c, labels_c)

    per_chunk = torch.stack([run(h[:, i * cs:(i + 1) * cs], labels[:, i * cs:(i + 1) * cs])
                             for i in range(n_chunks)])
    mask = (labels >= 0).to(torch.float32)
    n_tok = mask.sum().clamp(min=1.0)
    return per_chunk.sum() / n_tok, n_tok


def lm_head_argmax(params: dict, ctx: ParallelCtx, h: torch.Tensor) -> torch.Tensor:
    """Greedy next token over the vocab-parallel head. h: (B, D) -> (B,)
    int32; among equal logits the smallest id. Over a model axis: each
    rank's best logit and its (first) id, offset to the global vocab;
    the max over the axis; the ids of the ranks holding it, the min over
    the axis (the others offer int32's max)."""
    head = squeeze_tp(params["lm_head"], 1)
    v_l = head.shape[1]
    logits = (h @ head.to(h.dtype)).to(torch.float32)
    local_arg = torch.argmax(logits, dim=-1).to(torch.int32)  # the first maximum
    if not ctx.model:
        return local_arg
    local_arg = local_arg + ctx.model_index() * v_l
    local_best = logits.amax(dim=-1)
    best = ctx.pmax_model(local_best)
    cand = torch.where(local_best >= best, local_arg, torch.iinfo(torch.int32).max)
    return ctx.pmin_model(cand)


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
                   prefix_embeds: Optional[torch.Tensor] = None, *, remat: bool = False,
                   compute_dtype=torch.float32):
    """tokens (B, S_t); prefix_embeds (B, P, D) or None -> hidden (B, S, D)
    of ``compute_dtype`` with S = P + S_t, and the summed MoE aux loss.
    ``remat``: each block checkpointed (its forward run again in the
    backward, nothing inside it saved)."""
    x = embed(params, cfg, ctx, tokens).to(compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(compute_dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x = ctx.sp_slice(x)

    aux_losses = []
    for layer_params, layer in zip(params["layers"], cfg.layers):
        if remat:
            x, aux = checkpoint(_block_apply, layer_params, params.get("shared"), cfg, layer,
                                ctx, x, positions, use_reentrant=False)
        else:
            x, aux = _block_apply(layer_params, params.get("shared"), cfg, layer, ctx, x,
                                  positions)
        if aux is not None:
            aux_losses.append(aux["moe_aux_loss"])
    x = ctx.sp_gather(rms_norm(x, params["final_norm"]))
    moe_aux = sum(aux_losses) if aux_losses else torch.zeros((), device=x.device)
    return x, {"moe_aux_loss": moe_aux}


def loss_fn(params: dict, cfg: ModelConfig, ctx: ParallelCtx, batch: dict, *,
            remat: bool = True, compute_dtype=torch.bfloat16):
    """Next-token CE (+ MoE aux). batch: {"tokens", "labels"[,
    "prefix_embeds"]}; labels align with the FULL sequence (prefix
    positions carry -1). The reference's defaults: each block and each
    chunk of the loss checkpointed, bfloat16 compute."""
    h, aux = forward_hidden(params, cfg, ctx, batch["tokens"], batch.get("prefix_embeds"),
                            remat=remat, compute_dtype=compute_dtype)
    loss, n_tok = lm_head_loss(params, cfg, ctx, h, batch["labels"], remat=remat)
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


def cache_meta(cfg: ModelConfig, tp: int, shape: InputShape, client_axes: tuple, *,
               dtype=torch.bfloat16, kv_quant: bool = False) -> tuple:
    """The Meta tree of the KV/SSM caches of one serving shape (global
    shapes; a pspec entry ``client_axes`` is a dim sharded over the
    clients, ``"model"`` one over the model axis).

    A batch above 1 is sharded over the client axes, each shard holding
    the whole sequence. At batch 1 (``long_500k``) a full-attention
    layer's cache is sharded over the client axes on its SEQUENCE dim
    (flash-decoding); a sliding-window layer keeps a ring of ``min(seq_len,
    window)`` slots and the SSM states are replicated. ``kv_quant``
    stores K/V as int8 codes and bfloat16 per-token scales (``k_scale``,
    ``v_scale``, of shape ``k.shape[:-1] + (1,)``). ``dtype`` is the
    compute dtype's: of K/V and the SSM conv tails; the SSM state ``h`` is
    float32 always."""
    B = shape.global_batch
    seq_sharded = B == 1
    # the entry as a PartitionSpec holds it: None for no axes, a name for one
    client_axes = tuple(client_axes)
    client_axes = (client_axes[0] if len(client_axes) == 1 else client_axes) or None
    batch_spec = None if seq_sharded else client_axes
    seq_spec = client_axes if seq_sharded else None
    caches = []
    for layer in cfg.layers:
        if layer.kind == "ssm":
            s = ssm.init_state_shape(cfg.ssm, tp, B)
            caches.append({
                "h": Meta(s["h"], torch.float32, (batch_spec, "model", None, None, None), 1),
                "conv_x": Meta(s["conv_x"], dtype, (batch_spec, "model", None, None), 1),
                "conv_bc": Meta(s["conv_bc"], dtype, (batch_spec, None, None), 1),
            })
            continue
        # a sliding-window layer reads only the last `window` keys: a ring
        # of that many slots, replicated at batch 1
        S_c = shape.seq_len if layer.window is None else min(shape.seq_len, layer.window)
        layer_seq_spec = seq_spec if layer.window is None else None
        c = attention.init_cache_shape(cfg.attn_spec(layer), tp, B, S_c)
        pspec = (batch_spec, "model", None, layer_seq_spec, None)
        if kv_quant:
            scale_shape = c["k"][:-1] + (1,)
            caches.append({"k": Meta(c["k"], torch.int8, pspec, 1),
                           "k_scale": Meta(scale_shape, torch.bfloat16, pspec, 1),
                           "v": Meta(c["v"], torch.int8, pspec, 1),
                           "v_scale": Meta(scale_shape, torch.bfloat16, pspec, 1)})
        else:
            caches.append({"k": Meta(c["k"], dtype, pspec, 1),
                           "v": Meta(c["v"], dtype, pspec, 1)})
    return tuple(caches)


def decode_step(params: dict, caches: tuple, cfg: ModelConfig, ctx: ParallelCtx,
                tokens: torch.Tensor, pos: int, *, seq_sharded: bool = False,
                compute_dtype=torch.bfloat16):
    """One decode step in ``compute_dtype``. tokens (B, 1); pos: the
    tokens already in the caches. Writes the caches in place; returns
    (next_token (B,), caches). seq_sharded: the full-attention layers'
    caches are sharded on their sequence dim over ``ctx.seq_axis``
    (``cache_meta`` at batch 1), and decode by flash-decoding;
    sliding-window rings are whole."""
    x = embed(params, cfg, ctx, tokens).to(compute_dtype)
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
            y, _ = attention.decode(p["attn"], spec, ctx, h, cache, pos,
                                    seq_sharded=seq_sharded and layer.window is None)
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
            shape: InputShape, prefix_embeds: Optional[torch.Tensor] = None, *,
            compute_dtype=torch.bfloat16):
    """Run the prompt through the model in ``compute_dtype``, building the
    decode caches for ``shape.seq_len`` positions (prompt and
    generation). tokens (B, S_t); prefix_embeds (B, P, D) or None.
    Returns (next_token (B,), caches)."""
    x = embed(params, cfg, ctx, tokens).to(compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(compute_dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x = ctx.sp_slice(x)
    caches = []
    for layer_params, layer in zip(params["layers"], cfg.layers):
        if layer.kind == "ssm":
            h = ctx.sp_gather(rms_norm(x, layer_params["norm1"]))
            y, state = ssm.forward(layer_params["ssm"], cfg.ssm, ctx, h, return_state=True)
            x = x + y
            # the recurrent state float32, the conv tails the compute dtype
            caches.append({k: t.to(torch.float32 if t.dim() == 5 else compute_dtype)
                           for k, t in state.items()})
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

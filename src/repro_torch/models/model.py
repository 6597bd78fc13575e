"""Model assembly (counterpart of ``repro/models/model.py``'s parameter and
training halves), at tp = 1: embedding -> blocks (attn / ssm /
shared_attn, mlp / moe) -> the vocab-chunked LM head loss.

Parameter tree (the reference's, leading ``tp`` axes kept at size 1):
  embed:      (tp, V_l, D)
  layers[i]:  {"norm1", "attn"/"ssm", ["norm2", "mlp"/"moe"]}; a
              'shared_attn' layer is {} (its params live in "shared")
  shared:     one attention+MLP block reused by every 'shared_attn' layer
  final_norm: (D,)
  lm_head:    (D, tp, V_l)

Everything computes in float32, the compute dtype the reference's lm task
passes. The reference's remat (``jax.checkpoint`` of blocks and CE
chunks) moves memory, not values, and is left out
(``torch.utils.checkpoint`` does not compose with ``torch.func``). Serving (caches, prefill, decode) is
ROADMAP.md queue A item 13.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention, mlp, moe, ssm
from repro_torch.models.common import ParallelCtx, dense_init, rms_norm, squeeze_tp


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: ModelConfig, layer: LayerSpec, device):
    D = cfg.d_model
    if layer.kind == "shared_attn":
        return {}  # params live in the shared block
    p = {"norm1": torch.zeros((D,), device=device)}
    if layer.kind == "ssm":
        p["ssm"] = ssm.init_params(generator, cfg.ssm, device)
        return p
    p["attn"] = attention.init_params(generator, cfg.attn_spec(layer), device)
    p["norm2"] = torch.zeros((D,), device=device)
    if cfg.moe is not None:
        p["moe"] = moe.init_params(generator, cfg.moe, device)
    elif cfg.mlp_kind is not None:
        p["mlp"] = mlp.init_params(generator, cfg.mlp_kind, D, cfg.d_ff, device)
    return p


def _shared_layerspec(cfg: ModelConfig) -> LayerSpec:
    for layer in cfg.layers:
        if layer.kind == "shared_attn":
            return layer
    raise ValueError("no shared_attn layer in config")


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Random float32 parameters of the reference's shapes at tp = 1,
    drawn on the CPU from ``generator`` (the reference draws from
    ``jax.random``: values differ, shapes and the special leaves do not)."""
    D = cfg.d_model
    V = cfg.padded_vocab(1)
    params = {
        "embed": dense_init(generator, (1, V, D), in_axis=2, device=device),
        "layers": tuple(_layer_init(generator, cfg, layer, device) for layer in cfg.layers),
        "final_norm": torch.zeros((D,), device=device),
    }
    if cfg.shared_attn:
        spec = cfg.attn_spec(_shared_layerspec(cfg))
        params["shared"] = {
            "norm1": torch.zeros((D,), device=device),
            "attn": attention.init_params(generator, spec, device),
            "norm2": torch.zeros((D,), device=device),
            "mlp": mlp.init_params(generator, cfg.mlp_kind, D, cfg.shared_d_ff, device),
        }
    params["lm_head"] = dense_init(generator, (D, 1, V), in_axis=0, device=device)
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed(params: dict, cfg: ModelConfig, ctx: ParallelCtx, tokens: torch.Tensor):
    """tokens (B, S) -> (B, S, D)."""
    table = squeeze_tp(params["embed"], 0)  # (V_l, D)
    v_l = table.shape[0]
    ids = tokens.to(torch.int64) - ctx.model_index() * v_l
    valid = (ids >= 0) & (ids < v_l)
    emb = table[ids.clamp(0, v_l - 1)]
    emb = torch.where(valid[..., None], emb, 0)
    return ctx.psum_model(emb)


def lm_head_loss(params: dict, cfg: ModelConfig, ctx: ParallelCtx, h: torch.Tensor,
                 labels: torch.Tensor, *, seq_chunk: int = 512):
    """Cross entropy over the PADDED vocab (its extra columns take part in
    the log-sum-exp). h: (B, S, D); labels: (B, S), positions with label
    < 0 masked out. Returns (mean_loss, n_tokens). The logits are made a
    sequence chunk at a time."""
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


# ---------------------------------------------------------------------------
# Forward (train)
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

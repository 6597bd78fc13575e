"""Analytical per-rank device-memory model (counterpart of
``repro/launch/memory_model.py``): every term derived from the config,
the input shape and the mesh, as the reference derives it.

  train:  params (float32) + optimizer state + grads (float32) + one
          leaf's levels and clip copies + saved residual-stream
          activations (remat: one (B_l, S[/tp], D) tensor of the compute
          dtype per layer) + a transient working set; ZeRO-1: the
          parameters and gradients of 2-byte compute, the float32 master
          (and moments) divided over the clients
  decode: params (bfloat16) + KV/SSM caches + a small working set
  prefill: params (bfloat16) + caches + the forward's working set

The reference checks the total against a TPU v5e's 16 GiB; here ``fits``
checks it against ``hbm_bytes``, by default the card's own
(``torch.cuda.get_device_properties(0).total_memory``). The model counts
what the reference's XLA program holds; the port's eager step also holds
the decoded update tree (``ROADMAP.md`` §B), which no term counts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.convert import leaves
from repro_torch.models import meta as meta_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import plan_attn_sharding


def _leaf_device_bytes(m: meta_lib.Meta, mesh_shape: dict) -> float:
    n = 1
    for d in m.shape:
        n *= d
    shard = 1
    for entry in m.pspec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            shard *= mesh_shape[a]
    return n * torch.empty((), dtype=m.dtype).element_size() / shard


def params_device_bytes(meta_tree, mesh_shape: dict) -> float:
    """Bytes a rank holds of ``meta_tree``'s leaves on ``mesh_shape``
    (axis name -> size; each leaf divided by the axes its pspec names)."""
    return sum(_leaf_device_bytes(m, mesh_shape) for m in leaves(meta_tree))


def max_leaf_device_bytes(meta_tree, mesh_shape: dict) -> float:
    return max(_leaf_device_bytes(m, mesh_shape) for m in leaves(meta_tree))


def estimate(cfg: ModelConfig, shape: InputShape, mesh_shape: dict, *, optimizer: str = "sgd",
             seq_parallel: bool = True, compute_bytes: int = 2, zero1: bool = False,
             kv_quant: bool = False, hbm_bytes: Optional[float] = None) -> dict:
    """The reference's terms in bytes a rank (train: ``params``,
    ``optimizer`` or ``master+optimizer``, ``grads+levels``,
    ``saved_activations``, ``working_set``; serve: ``params``, ``caches``,
    ``working_set``), their ``total``, and ``fits``: ``total <
    hbm_bytes`` (None: the card's memory, read on the card; None when no
    card is present)."""
    tp = mesh_shape.get("model", 1)
    n_clients = 1
    for a, s in mesh_shape.items():
        if a != "model":
            n_clients *= s
    D = cfg.d_model
    B_l = max(1, shape.global_batch // n_clients)
    S = shape.seq_len
    L = cfg.num_layers

    meta_train = model_lib.param_meta(cfg, tp=tp, dtype=torch.float32)
    p_bytes = params_device_bytes(meta_train, mesh_shape)

    if shape.kind == "train":
        opt_factor = {"sgd": 0.0, "momentum": 1.0, "adam": 2.0}[optimizer]
        s_store = S // tp if seq_parallel else S
        saved_acts = L * B_l * s_store * D * compute_bytes
        # transient working set: a few gathered residual copies + the widest
        # sublayer intermediate + one attention score chunk + one CE chunk
        h_full = B_l * S * D * compute_bytes
        widest = 0
        if cfg.d_ff:
            widest = B_l * S * (cfg.d_ff // max(tp, 1)) * compute_bytes * 2
        if cfg.moe is not None:
            e_l = cfg.moe.num_experts // max(tp, 1)
            C = max(1, int(cfg.moe.capacity_factor * B_l * S * cfg.moe.top_k
                           / cfg.moe.num_experts))
            widest = max(widest, 3 * e_l * C * D * compute_bytes
                         + 2 * B_l * S * cfg.moe.num_experts * 4)
        if cfg.ssm is not None:
            hl = cfg.ssm.num_heads // max(tp, 1)
            Q = cfg.ssm.chunk
            widest = max(widest, B_l * (S // Q) * Q * Q * hl * 4
                         + 2 * B_l * S * (cfg.ssm.d_inner // max(tp, 1)) * compute_bytes)
        score_chunk = 0
        if cfg.num_heads:
            sh = plan_attn_sharding(cfg.num_heads, cfg.num_kv_heads, tp)
            k_span = min(S, max((layer.window or S) for layer in cfg.layers) + cfg.q_chunk)
            score_chunk = B_l * sh.q_local * cfg.q_chunk * k_span * 4 * 2
        v_l = cfg.padded_vocab(tp) // tp
        ce_chunk = 2 * B_l * min(512, S) * v_l * 4
        workset = 4 * h_full + max(widest, score_chunk, ce_chunk)
        # levels and clip copies live a leaf at a time (the encode -> sum
        # -> decode loop consumes one gradient leaf at a time): ~2 copies
        # of the largest leaf, not a whole extra tree
        leaf_transient = 2 * max_leaf_device_bytes(meta_train, mesh_shape)
        if zero1:
            # 2-byte compute params + the float32 master sharded over the
            # clients; 2-byte grads from autograd
            n_coords = p_bytes / 4
            out = {
                "params": n_coords * 2,
                "master+optimizer": (1 + opt_factor) * p_bytes / max(1, n_clients),
                "grads+levels": n_coords * 2 + leaf_transient,
                "saved_activations": saved_acts,
                "working_set": workset,
            }
        else:
            out = {
                "params": p_bytes,
                "optimizer": opt_factor * p_bytes,
                "grads+levels": p_bytes + leaf_transient,  # float32 grad tree
                "saved_activations": saved_acts,
                "working_set": workset,
            }
    else:
        meta_serve = model_lib.param_meta(cfg, tp=tp, dtype=torch.bfloat16)
        p_bytes = params_device_bytes(meta_serve, mesh_shape)
        caches = model_lib.cache_meta(cfg, tp, shape, tuple(a for a in mesh_shape if a != "model"),
                                      kv_quant=kv_quant)
        c_bytes = params_device_bytes(caches, mesh_shape)
        if shape.kind == "prefill":
            workset = 4 * B_l * S * D * compute_bytes
        else:
            workset = 64 * 1024**2
        out = {"params": p_bytes, "caches": c_bytes, "working_set": workset}

    out["total"] = sum(out.values())
    if hbm_bytes is None and torch.cuda.is_available():
        hbm_bytes = torch.cuda.get_device_properties(0).total_memory
    out["fits"] = None if hbm_bytes is None else out["total"] < hbm_bytes
    return out

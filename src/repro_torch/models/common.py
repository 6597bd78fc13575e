"""Shared model primitives (counterpart of ``repro/models/common.py``).

The reference runs its layers inside a manual ``shard_map`` over a
(pod, data, model) mesh; on one device it passes a ``ParallelCtx`` with
``model_axis=None`` and every collective is the identity. The port runs
that case only, tp = 1: the tensor-parallel mesh, with its psums and the
compressed sequence-parallel all-gather, is ROADMAP.md queue A item 12.
Parameter layouts keep the reference's leading ``tp`` axes (of size 1),
so a parameter tree carries across unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The mesh seen from inside a layer, at tp = 1: every collective is
    the identity and the model index is 0."""

    model_axis: Optional[str] = None
    tp: int = 1

    def __post_init__(self):
        if self.model_axis is not None or self.tp != 1:
            raise NotImplementedError(
                "a model axis (tp > 1) is not ported yet: ROADMAP.md queue A item 12")

    def psum_model(self, x):
        return x

    def pmax_model(self, x):
        return x

    def model_index(self) -> int:
        return 0

    def sp_gather(self, x):
        return x

    def sp_scatter(self, x):
        return x

    def sp_slice(self, x):
        return x


# ---------------------------------------------------------------------------
# Attention sharding geometry (pure Python, as in the reference)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSharding:
    """How H query heads and KV kv_heads map onto a tp-way model axis.

    tp_attn:  number of distinct Q-head slices (power of 2, divides tp).
    dup_attn: tp // tp_attn — whole-attention duplication factor.
    kv_shards: number of distinct KV-head slices within tp_attn.
    dup_kv:   tp_attn // kv_shards (KV params further duplicated).
    q_local / kv_local: heads held per device (content duplicated dup times).
    """

    tp: int
    tp_attn: int
    dup_attn: int
    kv_shards: int
    dup_kv: int
    q_local: int
    kv_local: int


def plan_attn_sharding(num_heads: int, num_kv_heads: int, tp: int) -> AttnSharding:
    if num_heads % num_kv_heads != 0:
        raise ValueError(f"H={num_heads} not a multiple of kv={num_kv_heads}")
    p2 = num_heads & -num_heads  # largest power of 2 dividing H
    tp_attn = min(p2, tp)
    dup_attn = tp // tp_attn
    kv_shards = min(num_kv_heads, tp_attn)
    dup_kv = tp_attn // kv_shards
    q_local = num_heads // tp_attn
    kv_local = max(1, num_kv_heads // tp_attn)
    # Per-shard q heads must share the shard's kv heads contiguously.
    group = num_heads // num_kv_heads
    if kv_local == 1 and q_local > group:
        raise ValueError(
            f"unsupported geometry H={num_heads} kv={num_kv_heads} tp={tp}: "
            f"{q_local} local q heads span multiple kv heads with kv_local=1"
        )
    return AttnSharding(tp=tp, tp_attn=tp_attn, dup_attn=dup_attn, kv_shards=kv_shards,
                        dup_kv=dup_kv, q_local=q_local, kv_local=kv_local)


# ---------------------------------------------------------------------------
# Small shared layers
# ---------------------------------------------------------------------------


def squeeze_tp(p: torch.Tensor, axis: int) -> torch.Tensor:
    """Drop a parameter's size-1 ``tp`` axis."""
    return p.squeeze(axis) if p.shape[axis] == 1 else p


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``1 + weight`` scale (zero-initialised weights)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + weight.to(torch.float32))).to(dtype)


def rope_frequencies(head_dim: int, theta: float, rotary_frac: float = 1.0, device=None):
    """Inverse frequencies for the rotated portion of the head dim."""
    rot = int(head_dim * rotary_frac)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) int.

    Partial rotary (rotary_frac < 1) rotates only the first ``rot`` dims,
    in interleaved pairs (the ChatGLM-style "2d" RoPE)."""
    head_dim = x.shape[-1]
    inv, rot = rope_frequencies(head_dim, theta, rotary_frac, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), x[..., rot:]], dim=-1)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               device="cuda") -> torch.Tensor:
    """A float32 normal truncated to +-2 standard deviations, at
    ``1/sqrt(fan_in)`` (``fan_in = shape[in_axis]``), drawn on the
    generator's device and then moved to ``device``: a CPU generator gives
    the same values wherever they go, a CUDA generator draws on the card
    (a full-width model in seconds, where the CPU takes minutes)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(device)

"""Gradient clipping (Algorithm 1, line 5; counterpart of
``repro/core/clipping.py``).

The paper's mechanisms are per-coordinate on [-c, c], so the faithful clip is
a per-coordinate value clip. Global-norm clipping is provided for comparison
ablations (it composes with a per-coordinate c = norm_bound since each
coordinate of a norm-clipped vector lies in [-c, c]).

Trees are the port's nested dicts (or lists, tuples) of tensors; leaves
are visited in ``convert.leaves`` order, the sorted keys of the
reference's ``tree_leaves``.
"""
from __future__ import annotations

import torch

from repro_torch.convert import leaves, map_leaves


def value_clip(tree, c: float):
    """Per-coordinate clip of every leaf to [-c, c]."""
    return map_leaves(lambda i, g: g.clamp(-c, c), tree)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of all leaves, a 0-d float32 tensor: each leaf's sum of
    squares in float32, added leaf by leaf in key order (the reference's
    Python ``sum`` over ``tree_leaves``), then the square root."""
    total = 0
    for g in leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def global_norm_clip(tree, max_norm: float):
    """Scale the whole tree so its global L2 norm is <= max_norm; each
    scaled leaf is computed in float32 (a narrower leaf promoted, as the
    reference's ``g * scale`` promotes) and cast back to its own dtype."""
    norm = global_norm(tree)
    # divide by a device tensor: PyTorch's ``scalar / tensor`` multiplies
    # by the reciprocal, which is not IEEE division
    bound = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    scale = torch.clamp(bound / torch.clamp(norm, min=1e-12), max=1.0)
    return map_leaves(
        lambda i, g: (g.to(torch.promote_types(g.dtype, torch.float32)) * scale).to(g.dtype),
        tree)

"""Parameter metadata (counterpart of ``repro/models/meta.py``), at tp = 1.

Every parameter leaf is described by a ``Meta``: its GLOBAL shape, its
dtype, its partition spec over the mesh (a tuple of axis names or
``None``, the reference's ``PartitionSpec`` entries) and its
gradient-sync subgroup size on the model axis:

  sync == 1    fully sharded leaf (distinct content per shard): no sync.
  sync == g    duplicated across aligned subgroups of size g: gradients
               are summed over the subgroup.
  sync == tp   replicated leaf: gradients summed over the whole model axis.

At tp = 1 every ``sync`` is 1 and ``sync_grads`` is the identity; the
model axis above 1, and with it the shardings and the dry run's
shape structs, is ROADMAP.md queue A item 12. A Meta tree has the
parameters' structure, so ``convert.leaves`` gives its leaves in the
reference's ``tree_flatten`` order (sorted dict keys), the order in
which the train step's per-leaf seeds are handed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.convert import leaves
from repro_torch.models.common import ParallelCtx


@dataclasses.dataclass(frozen=True)
class Meta:
    shape: tuple
    dtype: Any
    pspec: Optional[tuple]
    sync: int = 1


def check_tp(tp: int) -> None:
    """Refuse a model axis above 1 (the layers' ``param_meta``)."""
    if tp != 1:
        raise NotImplementedError(
            f"param_meta at tp={tp}: a model axis (tp > 1) is not ported yet: "
            f"ROADMAP.md queue A item 12")


def is_meta(x) -> bool:
    return isinstance(x, Meta)


def tree_map(f, tree, *rest):
    """``f(meta, *others)`` at every Meta of ``tree``, the ``rest`` trees
    read at the same places; the result keeps ``tree``'s structure."""
    if is_meta(tree):
        return f(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    raise TypeError(f"not a Meta tree node: {type(tree)!r}")


def sync_grads(grads, meta_tree, ctx: ParallelCtx):
    """Tensor-parallel gradient correction: the identity at tp = 1."""
    if ctx.tp != 1:
        raise NotImplementedError(
            "sync_grads at tp > 1 is not ported yet: ROADMAP.md queue A item 12")
    return grads


def _size(m: Meta) -> int:
    return math.prod(m.shape)


def param_bytes(meta_tree) -> int:
    return sum(_size(m) * torch.empty((), dtype=m.dtype).element_size()
               for m in leaves(meta_tree))


def param_count(meta_tree) -> int:
    return sum(_size(m) for m in leaves(meta_tree))

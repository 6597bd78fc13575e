"""Parameter metadata (counterpart of ``repro/models/meta.py``).

Every parameter leaf is described by a ``Meta``: its GLOBAL shape, its
dtype, its partition spec over the mesh (a tuple of axis names or
``None``, the reference's ``PartitionSpec`` entries) and its
gradient-sync subgroup size on the model axis:

  sync == 1    fully sharded leaf (distinct content per shard): no sync.
  sync == g    duplicated across aligned subgroups of size g: gradients
               are summed over the subgroup.
  sync == tp   replicated leaf: gradients summed over the whole model axis.

A Meta tree has the parameters' structure, so ``convert.leaves`` gives
its leaves in the reference's ``tree_flatten`` order (sorted dict keys),
the order in which the train step's gradients and per-leaf seeds are
handed. The reference's ``shardings`` (a ``NamedSharding`` a leaf) has
two counterparts here, one process a rank: ``shard_leaf`` takes a rank's
slice of a global leaf along its "model" dim and along every dim sharded
over the client axes (a cache's batch, or its sequence at batch 1;
``models/model.py:cache_meta``), and ``gather_leaf`` puts the model
ranks' slices back together. ``zeros`` makes a rank's zero leaves (the
caches a decode starts from), ``shape_dtype_structs`` the global leaves
on the meta device (shapes and dtypes, nothing allocated).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.convert import leaves
from repro_torch.models import common
from repro_torch.models.common import ParallelCtx


@dataclasses.dataclass(frozen=True)
class Meta:
    shape: tuple
    dtype: Any
    pspec: Optional[tuple]
    sync: int = 1


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


def model_dim(m: Meta) -> int:
    """The leaf's dim sharded over the model axis, or -1 (replicated)."""
    return next((i for i, e in enumerate(m.pspec or ()) if e == "model"), -1)


def client_dims(m: Meta) -> list:
    """The leaf's dims sharded over the client axes (a pspec entry that
    names axes other than the model axis)."""
    return [i for i, e in enumerate(m.pspec or ()) if e not in (None, "model", ())]


def local_shape(m: Meta, tp: int, n_clients: int = 1) -> tuple:
    """A rank's shape of the leaf (its model dim divided by tp, each client
    dim by ``n_clients``)."""
    d, shape = model_dim(m), list(m.shape)
    if d >= 0:
        shape[d] //= tp
    for d in client_dims(m):
        shape[d] //= n_clients
    return tuple(shape)


def shard_leaf(p: torch.Tensor, m: Meta, tp: int, index: int, *, client: int = 0,
               n_clients: int = 1) -> torch.Tensor:
    """Model rank ``index``'s slice (a view) of the global leaf ``p``: its
    block ``index`` of ``tp`` along the model dim, the whole of a
    replicated leaf (the reference's ``fed/tasks.py:shard_params``); and
    client ``client``'s block of ``n_clients`` along each client dim."""
    d = model_dim(m)
    if d >= 0 and tp > 1:
        size = p.shape[d] // tp
        p = p.narrow(d, index * size, size)
    if n_clients > 1:
        for d in client_dims(m):
            size = p.shape[d] // n_clients
            p = p.narrow(d, client * size, size)
    return p


def shape_dtype_structs(meta_tree, tp: int = 1, n_clients: int = 1):
    """The tree of ``meta_tree``'s leaves as tensors on the meta device
    (shape and dtype, nothing allocated): the counterpart of the
    reference's ``jax.ShapeDtypeStruct`` tree. Global shapes by default; a
    rank's (``local_shape``) at ``tp`` model ranks and ``n_clients``."""
    return tree_map(lambda m: torch.empty(local_shape(m, tp, n_clients), dtype=m.dtype,
                                          device="meta"), meta_tree)


def zeros(meta_tree, tp: int = 1, n_clients: int = 1, device="cuda"):
    """A rank's zero leaves of ``meta_tree`` (``local_shape``, each its
    Meta's dtype) on ``device``."""
    return tree_map(lambda m: torch.zeros(local_shape(m, tp, n_clients), dtype=m.dtype,
                                          device=device), meta_tree)


def gather_leaf(p: torch.Tensor, m: Meta, ctx: ParallelCtx) -> torch.Tensor:
    """The global leaf from every model rank's slice ``p``: a tiled
    all_gather along the model dim over the model group (a replicated
    leaf as it is)."""
    d = model_dim(m)
    if d < 0 or not ctx.model:
        return p
    return common._all_gather(p, ctx.model_group, ctx.tp, d)


def shard_tree(tree, meta_tree, tp: int, index: int):
    """``shard_leaf`` at every leaf of a global tree."""
    return tree_map(lambda m, p: shard_leaf(p, m, tp, index), meta_tree, tree)


def gather_tree(tree, meta_tree, ctx: ParallelCtx):
    """``gather_leaf`` at every leaf of a rank's tree."""
    return tree_map(lambda m, p: gather_leaf(p, m, ctx), meta_tree, tree)


def slicer(tp: int, index: int):
    """``keep(t, m)`` for the layers' ``init_params``: model rank
    ``index``'s slice of a freshly drawn global leaf, in a buffer of its
    own (the global leaf is freed once dropped)."""
    if tp == 1:
        return None

    def keep(t: torch.Tensor, m: Meta) -> torch.Tensor:
        return shard_leaf(t, m, tp, index).clone()

    return keep


def sync_grads(grads: list, meta_tree, ctx: ParallelCtx) -> list:
    """Tensor-parallel gradient correction of the list ``grads``
    (``convert.leaves`` order of ``meta_tree``): a leaf duplicated over
    the whole model axis (``sync >= tp``) psums its gradient over it, one
    duplicated over aligned subgroups (``1 < sync < tp``) sums over its
    subgroup, a sharded one (``sync == 1``) keeps its own."""
    if not ctx.model:
        return grads
    out = []
    for g, m in zip(grads, leaves(meta_tree)):
        if m.sync >= ctx.tp:
            g = ctx.psum_model(g)
        elif m.sync > 1:
            g = ctx.subgroup_psum(g, m.sync)
        out.append(g)
    return out


def _size(m: Meta) -> int:
    return math.prod(m.shape)


def param_bytes(meta_tree) -> int:
    return sum(_size(m) * torch.empty((), dtype=m.dtype).element_size()
               for m in leaves(meta_tree))


def param_count(meta_tree) -> int:
    return sum(_size(m) for m in leaves(meta_tree))

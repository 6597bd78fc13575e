"""Carry parameters between the two packages.

The flat parameter vector follows ``jax.flatten_util.ravel_pytree`` of
the reference's params tree: dict keys in sorted order at every level
(for the CNN ``b1, b2, conv1, conv2, dense1, dense2``), tuple and list
entries in order, empty containers (and None) contributing nothing, each
leaf flattened row-major in its own layout. Flat coordinate ``c``, and
so the RNG counter ``row * dim + c`` of the round kernels, then means the
same weight in both packages.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def tree_from_numpy(tree, device="cuda"):
    """A nested params tree of numpy arrays (dicts, tuples, lists; the
    reference's LM params) -> the same tree of tensors on ``device``,
    floating leaves as float32 (a bfloat16 leaf exactly)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating) or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def shard_from_numpy(tree, meta_tree, tp: int, index: int, device="cuda", *, client: int = 0,
                     n_clients: int = 1):
    """The reference's GLOBAL tree at ``tp`` (numpy, as its
    ``init_params(key, cfg, tp)`` draws it, duplicated slices repeated)
    -> model rank ``index``'s slices as tensors on ``device``, each
    through ``models/meta.py:shard_leaf`` (and client ``client``'s block
    of ``n_clients`` along a dim sharded over the clients: a ZeRO-1
    master's), each of its Meta's dtype: a bfloat16 tree crosses exactly,
    through float32."""
    from repro_torch.models import meta as meta_lib

    return meta_lib.tree_map(
        lambda m, a: meta_lib.shard_leaf(tree_from_numpy(a, "cpu"), m, tp, index, client=client,
                                         n_clients=n_clients)
        .to(m.dtype).clone().to(device), meta_tree, tree)


def zero1_init_master(tree, meta_tree, tp: int, n_clients: int):
    """The reference's ``zero1_init_master`` of a GLOBAL numpy parameter
    tree at ``tp`` (float32 or bfloat16): the global master tree, float32
    tensors on the CPU (``distributed/step.py:zero1_init_master``); a
    rank's shard of it through ``shard_from_numpy(master, master_meta,
    tp, index, client=c, n_clients=n_clients)``."""
    from repro_torch.distributed.step import zero1_init_master as init

    return init(tree_from_numpy(tree, "cpu"), meta_tree, tp, n_clients)


def _as_tensor(a, dtype) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, through float32, exactly) or
    tensor as a tensor of ``dtype``, on the CPU or where it lies."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    a = np.asarray(a)
    if a.dtype != np.int8:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _rank_piece(t: torch.Tensor, m, tp: int, index: int, client: int, n_clients: int,
                key=None) -> torch.Tensor:
    """Model rank ``index``'s and client ``client``'s piece (a view) of a
    leaf given in its global layout at ``tp`` (the shape of ``m``) or in
    the one-rank layout (its model dim of 1). From the one-rank layout,
    as the reference's ``tests/sharded_checks.py`` re-lays a leaf: where
    the leaf's content dim holds ``n`` distinct slices for the ``tp``
    ranks (KV heads fewer than tp: ``n < tp``), rank ``index`` takes slice
    ``index // (tp // n)``, the copies duplicated across model ranks; a
    leaf of no such dim is the same on every rank; an SSM ``w_zx``'s z
    and x streams are split each."""
    from repro_torch.models import meta as meta_lib

    if tuple(t.shape) != tuple(m.shape):
        ax = meta_lib.model_dim(m)
        if ax < 0 or t.shape[ax] != 1 or m.shape[ax] != tp or t.dim() != len(m.shape):
            raise ValueError(f"a leaf of shape {tuple(t.shape)} is neither the global "
                             f"{m.shape} nor its one-rank layout")
        diff = [i for i in range(t.dim()) if i != ax and t.shape[i] != m.shape[i]]
        if key == "w_zx":
            z, x = t.chunk(2, dim=-1)
            t = torch.cat([_rank_piece(h, dataclasses.replace(m, shape=m.shape[:-1] + (
                m.shape[-1] // 2,)), tp, index, 0, 1) for h in (z, x)], dim=-1)
        elif diff:
            (c,) = diff
            dup = tp // (t.shape[c] // m.shape[c])
            t = t.narrow(c, (index // dup) * m.shape[c], m.shape[c])
        return meta_lib.shard_leaf(t, m, 1, 0, client=client, n_clients=n_clients)
    return meta_lib.shard_leaf(t, m, tp, index, client=client, n_clients=n_clients)


def _walk(f, tree, meta_tree, key=None):
    if isinstance(meta_tree, dict):
        return {k: _walk(f, tree[k], v, k) for k, v in meta_tree.items()}
    if isinstance(meta_tree, (tuple, list)):
        return type(meta_tree)(_walk(f, t, v, key) for t, v in zip(tree, meta_tree))
    if meta_tree is None:
        return None
    return f(tree, meta_tree, key)


def cache_from_numpy(caches, cache_meta, tp: int, index: int, *, client: int = 0,
                     n_clients: int = 1, device="cuda"):
    """The reference's caches (numpy, GLOBAL layout: as its serve steps
    return them at ``tp``, or a one-rank prefill's at tp = 1) -> this
    rank's local caches by ``cache_meta`` (``models/model.py``): model
    rank ``index``'s slice (``_rank_piece``: KV heads fewer than tp are
    duplicated across model ranks, not split) and client ``client``'s
    block of ``n_clients`` along a batch or, at batch 1, sequence dim
    sharded over the clients; each leaf in a buffer of its own on
    ``device``, of its Meta's dtype (int8 codes, bfloat16 scales)."""
    return _walk(lambda a, m, key: _rank_piece(_as_tensor(a, m.dtype), m, tp, index, client,
                                               n_clients, key).clone().to(device),
                 caches, cache_meta)


def shard_from_one_rank(tree, meta_tree, tp: int, index: int):
    """A one-rank (tp = 1) tree of tensors (parameters or caches) -> model
    rank ``index``'s pieces at ``tp`` by ``meta_tree`` (``_rank_piece``),
    each in a buffer of its own where it lies: every rank of a model axis
    serving the model that the one-rank tree is."""
    return _walk(lambda t, m, key: _rank_piece(t, m, tp, index, 0, 1, key).clone(),
                 tree, meta_tree)


class _Leaf:
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


def _structure(tree, leaves: list):
    """The tree's skeleton (leaves as ``_Leaf``), appending its tensors to
    ``leaves`` in ravel_pytree order."""
    if isinstance(tree, dict):
        return {k: _structure(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_structure(v, leaves) for v in tree)
    if tree is None:
        return None
    leaves.append(tree)
    return _Leaf(tree.shape)


def leaves(tree) -> list:
    """The tree's leaves in ravel_pytree order."""
    out: list = []
    _structure(tree, out)
    return out


def map_leaves(fn, tree):
    """The tree with leaf ``t``, the i-th in ravel_pytree order, replaced
    by ``fn(i, t)``."""
    out: list = []
    skeleton = _structure(tree, out)
    return _fill(skeleton, iter([fn(i, t) for i, t in enumerate(out)]))


def ravel(params) -> tuple[torch.Tensor, "Unravel"]:
    """Flatten a params tree in ravel_pytree order; returns the flat
    vector and the inverse map."""
    leaves: list = []
    skeleton = _structure(params, leaves)
    flat = torch.cat([t.reshape(-1) for t in leaves])
    return flat, Unravel(skeleton)


class Unravel:
    """flat vector -> params tree of views, for a fixed tree layout."""

    def __init__(self, skeleton):
        self.skeleton = skeleton
        # the leaves' shapes and sizes in flat order
        self.shapes = tuple(leaf.shape for leaf in _skeleton_leaves(skeleton))
        self.sizes = [math.prod(shape) for shape in self.shapes]
        self.size = sum(self.sizes)

    def __call__(self, flat: torch.Tensor):
        if flat.shape != (self.size,):
            raise ValueError(f"flat vector must be ({self.size},), got {tuple(flat.shape)}")
        # one split: its backward is a single cat (a slice per leaf would
        # fill and add a full-width zero buffer per leaf under vmap(grad))
        pieces = flat.split(self.sizes)
        return _fill(self.skeleton, iter(p.view(s) for p, s in zip(pieces, self.shapes)))


def _fill(node, views):
    if isinstance(node, dict):
        return {k: _fill(v, views) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_fill(v, views) for v in node)
    if node is None:
        return None
    return next(views)


def _skeleton_leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _skeleton_leaves(v)
    elif isinstance(node, (tuple, list)):
        for v in node:
            yield from _skeleton_leaves(v)
    elif node is not None:
        yield node

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

import math

import numpy as np
import torch


def tree_from_numpy(tree, device="cuda"):
    """A nested params tree of numpy arrays (dicts, tuples, lists; the
    reference's LM params) -> the same tree of tensors on ``device``,
    floating leaves as float32."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def shard_from_numpy(tree, meta_tree, tp: int, index: int, device="cuda"):
    """The reference's GLOBAL tree at ``tp`` (numpy, as its
    ``init_params(key, cfg, tp)`` draws it, duplicated slices repeated)
    -> model rank ``index``'s slices as tensors on ``device``, each
    through ``models/meta.py:shard_leaf``."""
    from repro_torch.models import meta as meta_lib

    return meta_lib.tree_map(
        lambda m, a: meta_lib.shard_leaf(tree_from_numpy(a, "cpu"), m, tp, index)
        .clone().to(device), meta_tree, tree)


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

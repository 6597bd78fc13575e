"""Server optimizers (counterpart of ``repro/optim/optimizers.py``):
Algorithm 1 line 11, ``w <- w - lr * g_hat``, generalized behind the
reference's ``init`` / ``update`` interface, so every engine's round goes
through the same decode-then-apply boundary.

``sgd`` is stateless (``()``); ``momentum`` keeps ``{"m"}`` and ``adam``
``{"m", "v", "t"}``, ``t`` a 0-d int32 tensor on the parameters' device.
Each update is the reference's expression, op for op, in the parameters'
dtype, with nothing read back to the host, so a captured CUDA graph
replays it. The state tensors are fresh each update: the scan engine
copies them into its static buffers.

The parameters are one flat tensor (the round engines') or a tree of
nested dicts, tuples and lists of tensors (the LM train step's). A tree
is updated leaf by leaf, each leaf by the flat expression, as the
reference's ``tree_map`` does: the moments are trees of the parameters'
structure, and ``adam`` keeps one ``t`` for the whole tree. ``lr`` is a
float or a 0-d float32 tensor (a schedule's rate).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.convert import leaves, map_leaves


def _is_tree(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def _zeros_like(params):
    if _is_tree(params):
        return map_leaves(lambda i, p: torch.zeros_like(p), params)
    return torch.zeros_like(params)


def _device(params) -> torch.device:
    return (leaves(params)[0] if _is_tree(params) else params).device


def _leafwise(fn, params, *trees) -> tuple:
    """``fn(p, *others)`` of each leaf ``p`` of ``params`` and the leaves
    at its place in ``trees``, one leaf at a time; ``fn`` returns a tuple,
    and each of its entries is gathered into a tree of ``params``'
    structure (for a flat ``params``, the entries themselves)."""
    if not _is_tree(params):
        return fn(params, *trees)
    others = [leaves(t) for t in trees]
    out = [fn(p, *(o[i] for o in others)) for i, p in enumerate(leaves(params))]
    return tuple(map_leaves(lambda i, _: out[i][k], params) for k in range(len(out[0])))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params, lr) ->
    (new_params, new_state)``."""

    name: str
    init: Callable
    update: Callable


def sgd(weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        # weight_decay = 0 leaves the decay term out: the update is then
        # literally p - lr * g, with lr rounded to the params' dtype, the
        # expression the fused decode-apply kernels compute (an added
        # 0.0 * p would turn -0.0 into +0.0)
        def leaf(p, g):
            if weight_decay:
                return (p - lr * (g + weight_decay * p).to(p.dtype),)
            return (p - lr * g.to(p.dtype),)

        return _leafwise(leaf, params, grads)[0], state

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_like(params)}

    def update(grads, state, params, lr):
        def leaf(p, g, m):
            m = beta * m + g
            # the decay term is always added, as in the reference
            return p - lr * (m + weight_decay * p).to(p.dtype), m

        new, m = _leafwise(leaf, params, grads, state["m"])
        return new, {"m": m}

    return Optimizer("momentum", init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "t": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        # float32 bias corrections, computed on the device, once a tree
        tf = t.to(torch.float32)
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf

        def leaf(p, g, m, v):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return p - lr * (step + weight_decay * p).to(p.dtype), m, v

        new, m, v = _leafwise(leaf, params, grads, state["m"], state["v"])
        return new, {"m": m, "v": v, "t": t}

    return Optimizer("adam", init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam}


def make_optimizer(name: str, **options) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}")
    return OPTIMIZERS[name](**options)


def clone_state(state):
    """A copy of an optimizer state (``()`` or a dict of tensors)."""
    return {k: v.clone() for k, v in state.items()} if isinstance(state, dict) else state


def copy_state_(dst, src) -> None:
    """Write the state ``src`` into the tensors of ``dst``, in place."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            v.copy_(src[k])

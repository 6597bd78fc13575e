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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


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

    def update(grads: torch.Tensor, state, params: torch.Tensor, lr: float):
        # weight_decay = 0 leaves the decay term out: the update is then
        # literally p - lr * g, with lr rounded to the params' dtype, the
        # expression the fused decode-apply kernels compute (an added
        # 0.0 * p would turn -0.0 into +0.0)
        if weight_decay:
            return params - lr * (grads + weight_decay * params).to(params.dtype), state
        return params - lr * grads.to(params.dtype), state

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": torch.zeros_like(params)}

    def update(grads, state, params, lr):
        m = beta * state["m"] + grads
        # the decay term is always added, as in the reference
        return params - lr * (m + weight_decay * params).to(params.dtype), {"m": m}

    return Optimizer("momentum", init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": torch.zeros_like(params), "v": torch.zeros_like(params),
                "t": torch.zeros((), dtype=torch.int32, device=params.device)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = b1 * state["m"] + (1 - b1) * grads
        v = b2 * state["v"] + (1 - b2) * torch.square(grads)
        # float32 bias corrections, computed on the device
        tf = t.to(torch.float32)
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new = params - lr * (step + weight_decay * params).to(params.dtype)
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

"""Server optimizers (counterpart of ``repro/optim/optimizers.py``):
Algorithm 1 line 11, ``w <- w - lr * g_hat``, behind the reference's
``init`` / ``update`` interface, so the materialized round goes through
the same decode-then-apply boundary. Plain SGD is ported; momentum and
adam are refused by ``fed/config.py`` (ROADMAP.md queue A item 8).
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


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads: torch.Tensor, state, params: torch.Tensor, lr: float):
        # literally p - lr * g, with lr rounded to the params' dtype: the
        # fused decode-apply kernels compute the same expression
        return params - lr * grads.to(params.dtype), state

    return Optimizer("sgd", init, update)


def make_optimizer(name: str) -> Optimizer:
    if name != "sgd":
        raise NotImplementedError(
            f"server_opt={name!r} is not ported yet: ROADMAP.md queue A item 8")
    return sgd()

"""Server optimizers (counterpart of ``repro/optim/optimizers.py``): plain
SGD, Algorithm 1 line 11, ``w <- w - lr * g_hat``. On the main path the
decode-apply kernels run this update; ``fed/config.py`` refuses the
optimizers not ported yet."""
from __future__ import annotations

import torch


def sgd(params: torch.Tensor, grads: torch.Tensor, lr: float) -> torch.Tensor:
    return params - lr * grads.to(params.dtype)

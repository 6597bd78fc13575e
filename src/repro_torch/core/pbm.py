"""Poisson Binomial Mechanism (PBM) baseline (Chen et al., ICML 2022),
counterpart of ``repro/core/pbm.py``.

Each device maps its clipped scalar x in [-c, c] to p(x) = 1/2 + theta x / c
and releases z ~ Binomial(m, p(x)) (``kernels/pbm_kernel.py`` draws it from
the counter PRNG). The server decode of the SecAgg sum of n devices,

    g_hat = c / (theta m n) * (z_sum - n m / 2),

is unbiased for mean(x_i).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PBMParams:
    c: float
    m: int
    theta: float

    def __post_init__(self):
        if not 0.0 < self.theta <= 0.5:
            raise ValueError(f"theta must be in (0, 1/2], got {self.theta}")
        if self.m < 1:
            raise ValueError(f"m must be >= 1, got {self.m}")

    @property
    def bits_per_coordinate(self) -> float:
        return float(np.log2(self.m + 1))


def decode_sum(z_sum: torch.Tensor, n: int, params: PBMParams) -> torch.Tensor:
    """Unbiased decode of the SecAgg sum of n devices' Binomial draws. The
    scale and the centre are Python doubles rounded once to float32, as
    XLA rounds the reference's weakly typed constants."""
    scale = float(np.float32(params.c / (params.theta * params.m * n)))
    centre = float(np.float32(0.5 * n * params.m))
    return scale * (z_sum.to(torch.float32) - centre)

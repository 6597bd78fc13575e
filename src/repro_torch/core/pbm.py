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

from repro_torch.core.grid import f32_const


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


def quantize_with_uniforms(x: torch.Tensor, u: torch.Tensor, params: PBMParams) -> torch.Tensor:
    """Deterministic core: z = #{t : u[t] < p(x)}, int32, where u has
    shape ``(m,) + x.shape`` and ``p(x) = 1/2 + theta x / c`` in float32
    (``theta`` and ``c`` rounded once, the division IEEE)."""
    c = float(np.float32(params.c))
    x = x.to(torch.float32).clamp(-c, c)
    p = 0.5 + f32_const(params.theta, x.device) * x / f32_const(c, x.device)
    return (u < p[None]).sum(0, dtype=torch.int32)


def decode_sum(z_sum: torch.Tensor, n, params: PBMParams) -> torch.Tensor:
    """Unbiased decode of the SecAgg sum of n devices' Binomial draws. At
    an int n the scale and the centre are Python doubles rounded once to
    float32, as XLA rounds the reference's weakly typed constants; at a
    0-d int32 device count they are the reference's float32 arithmetic at
    a traced n, left to right: ``f32(c) / (f32(theta m) f32(n))`` and
    ``(f32(0.5) f32(n)) f32(m)``."""
    if isinstance(n, torch.Tensor):
        dev = n.device
        nf = n.reshape(()).to(torch.float32)
        scale = f32_const(params.c, dev) / (f32_const(params.theta * params.m, dev) * nf)
        centre = f32_const(0.5, dev) * nf * f32_const(params.m, dev)
    else:
        scale = float(np.float32(params.c / (params.theta * params.m * n)))
        centre = float(np.float32(0.5 * n * params.m))
    return scale * (z_sum.to(torch.float32) - centre)

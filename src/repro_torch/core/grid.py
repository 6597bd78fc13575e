"""Quantization-grid geometry of RQM (counterpart of ``repro/core/grid.py``).

The grid is the paper's (Algorithm 2, lines 2-3):

    X_max = c + delta
    B(i)  = -X_max + 2 * i * X_max / (m - 1),   i = 0..m-1

``x_max`` and ``step`` are Python doubles, exactly as in the reference;
the kernels round them to float32 once, at the call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


class GridGeometry:
    """The shared m-level grid over [-(c+delta), c+delta]; inheriting
    dataclasses provide the ``c``, ``delta`` and ``m`` fields."""

    @property
    def x_max(self) -> float:
        return self.c + self.delta

    @property
    def step(self) -> float:
        return 2.0 * self.x_max / (self.m - 1)

    @property
    def bits_per_coordinate(self) -> float:
        """Client -> aggregator message size per gradient coordinate."""
        return float(np.log2(self.m))

    def levels(self) -> np.ndarray:
        """B(0..m-1) as a float64 numpy array."""
        i = np.arange(self.m, dtype=np.float64)
        return -self.x_max + 2.0 * i * self.x_max / (self.m - 1)


@dataclasses.dataclass(frozen=True)
class RQMParams(GridGeometry):
    """Hyperparameters of the Randomized Quantization Mechanism.

    c: clipping threshold; delta: range extension; m: number of levels;
    q: probability of keeping each interior level.
    """

    c: float
    delta: float
    m: int
    q: float

    def __post_init__(self):
        if self.c <= 0:
            raise ValueError(f"c must be > 0, got {self.c}")
        if self.delta <= 0:
            raise ValueError(
                f"delta must be > 0 (delta=0 gives eps=inf, Thm 5.2), got {self.delta}"
            )
        if self.m < 2:
            raise ValueError(f"m must be >= 2, got {self.m}")
        if not 0.0 < self.q < 1.0:
            raise ValueError(f"q must be in (0,1), got {self.q}")


def decode_scale(n: int, params: GridGeometry) -> float:
    """``2 x_max / (n (m-1))`` as the reference computes it: a Python
    double, rounded to float32 only where it meets a float32 tensor."""
    return 2.0 * params.x_max / (n * (params.m - 1))


def decode_sum(z_sum: torch.Tensor, n: int, params: GridGeometry) -> torch.Tensor:
    """Server decode of the SecAgg sum of n devices' levels (Algorithm 1
    l.10): ``g_hat = -(c+delta) + z_sum * 2 (c+delta) / (n (m-1))``."""
    scale = float(np.float32(decode_scale(n, params)))
    return float(np.float32(-params.x_max)) + z_sum.to(torch.float32) * scale

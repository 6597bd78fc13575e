"""Quantization-grid geometry of RQM (counterpart of ``repro/core/grid.py``).

The grid is the paper's (Algorithm 2, lines 2-3):

    X_max = c + delta
    B(i)  = -X_max + 2 * i * X_max / (m - 1),   i = 0..m-1

``x_max`` and ``step`` are Python doubles, exactly as in the reference;
the kernels round them to float32 once, at the call.

The cohort size of a decode is a Python int for fixed cohorts, and a 0-d
int32 device tensor (``count``) for heterogeneous ones, whose realized
size exists only on the device in a captured round. The reference
computes the scale in two ways to match: a Python double rounded once
to float32 at a static n, and float32 arithmetic at a traced n
(``f32(2 x_max) / f32(n (m-1))``), which differ by one ULP at some n
(18 of n = 1..89 at c = 0.02, m = 16). ``decode_sum`` reproduces each.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes


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

    def epsilon_infinity(self) -> float:
        """Theorem 5.2's closed-form upper bound on D_inf (the eps of
        (eps, 0)-DP): log(2 (1-q)^2 (1 + c/delta)) + m log(1/(1-q))."""
        return float(np.log(2.0 * (1.0 - self.q) ** 2 * (1.0 + self.c / self.delta))
                     + self.m * np.log(1.0 / (1.0 - self.q)))


def decode_scale(n: int, params: GridGeometry) -> float:
    """``2 x_max / (n (m-1))`` as the reference computes it: a Python
    double, rounded to float32 only where it meets a float32 tensor."""
    return 2.0 * params.x_max / (n * (params.m - 1))


def f32_const(value: float, device) -> torch.Tensor:
    """``value`` rounded once to float32, as a 0-d tensor on ``device``
    (made once per value and device: making it on the card copies from
    the host, which a captured round may not do)."""
    return _f32_const(float(np.float32(value)), torch.device(device))


@functools.lru_cache(maxsize=None)
def _f32_const(value: float, device: torch.device) -> torch.Tensor:
    # made outside any dispatch mode: it is made once a process, so the
    # dry run's counts (launch/hlo_analysis.py) of a step must not depend
    # on whether an earlier call made it
    with _disable_current_modes():
        return torch.tensor(value, dtype=torch.float32, device=device)


def decode_scale_dev(count: torch.Tensor, params: GridGeometry) -> torch.Tensor:
    """The scale at a device count, as the reference computes it at a
    traced n: ``f32(2 x_max) / f32(n (m-1))``, the int32 product converted
    once, an IEEE division of two 0-d float32 tensors."""
    denom = (count.reshape(()) * (params.m - 1)).to(torch.float32)
    return f32_const(2.0 * params.x_max, count.device) / denom


def decode_sum(z_sum: torch.Tensor, n, params: GridGeometry) -> torch.Tensor:
    """Server decode of the SecAgg sum of n devices' levels (Algorithm 1
    l.10): ``g_hat = -(c+delta) + z_sum * 2 (c+delta) / (n (m-1))``. ``n``
    is an int, or a 0-d int32 device count (the traced form)."""
    if isinstance(n, torch.Tensor):
        scale = decode_scale_dev(n, params)
    else:
        scale = float(np.float32(decode_scale(n, params)))
    return float(np.float32(-params.x_max)) + z_sum.to(torch.float32) * scale


def encode_value(z: torch.Tensor, params: GridGeometry) -> torch.Tensor:
    """A level index mapped back to its grid value B(z) (single device):
    ``-(c+delta) + z * step`` in float32."""
    return float(np.float32(-params.x_max)) + z.to(torch.float32) * float(np.float32(params.step))

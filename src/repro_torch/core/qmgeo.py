"""QMGeo-style truncated-geometric randomized quantizer, counterpart of
``repro/core/qmgeo.py``.

Per coordinate x in [-c, c] on RQM's m-level grid over [-(c+delta), c+delta]:

  1. stochastic rounding to j in {lo, lo+1}, up with probability
     (x - B(lo)) / step;
  2. truncated two-sided geometric noise: release k with probability
     r^|k-j| / Z_j over k = 0..m-1, drawn by inverse CDF over the m levels.

``quantize_with_uniforms`` is the plain PyTorch version of the device
function in ``kernels/csrc/qmgeo_encode.cuh``: the same float32 steps in the
same grouping, with ``torch.exp`` where the kernel calls ``expf``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import grid
from repro_torch.core.grid import GridGeometry


@dataclasses.dataclass(frozen=True)
class QMGeoParams(GridGeometry):
    """c: clipping threshold; delta: range extension; m: number of levels;
    r: geometric noise ratio in (0, 1) (larger r: flatter noise, more
    privacy)."""

    c: float
    delta: float
    m: int
    r: float

    def __post_init__(self):
        if self.c <= 0:
            raise ValueError(f"c must be > 0, got {self.c}")
        if self.delta < 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        if self.m < 2:
            raise ValueError(f"m must be >= 2, got {self.m}")
        if not 0.0 < self.r < 1.0:
            raise ValueError(f"r must be in (0,1), got {self.r}")


def f32_constants(params: QMGeoParams) -> dict:
    """The float32 scalars the encode uses, each rounded once from the
    reference's Python double (``core/qmgeo.py:163-172``)."""
    r = float(params.r)
    return {
        "c": float(np.float32(params.c)),
        "x_max": float(np.float32(params.x_max)),
        "step": float(np.float32(params.step)),
        "log_r": float(np.float32(math.log(r))),
        "inv_1mr": float(np.float32(1.0 / (1.0 - r))),
        "r_over_1mr": float(np.float32(r / (1.0 - r))),
    }


def round_to_level(x: torch.Tensor, u_round: torch.Tensor, params: QMGeoParams):
    """Step 1 of the encode: ``(j, p_up)``, the level x rounds to and the
    probability it had of rounding up."""
    k = f32_constants(params)
    # divide by a device tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not IEEE division
    step = torch.tensor(k["step"], dtype=torch.float32, device=x.device)
    x = x.to(torch.float32).clamp(-k["c"], k["c"])
    lo = torch.floor((x + k["x_max"]) / step).clamp(0, params.m - 2).to(torch.int32)
    b_lo = -k["x_max"] + lo.to(torch.float32) * k["step"]
    p_up = (x - b_lo) / step
    return lo + (u_round < p_up).to(torch.int32), p_up


def quantize_with_uniforms(x: torch.Tensor, u_round: torch.Tensor, u_noise: torch.Tensor,
                           params: QMGeoParams) -> torch.Tensor:
    """int32 levels of ``x`` given its two uniforms per element."""
    if u_round.shape != x.shape or u_noise.shape != x.shape:
        raise ValueError(f"uniforms {tuple(u_round.shape)}, {tuple(u_noise.shape)} "
                         f"must have the shape of x {tuple(x.shape)}")
    k = f32_constants(params)
    m = params.m
    j, _ = round_to_level(x, u_round, params)
    jf = j.to(torch.float32)

    # 2. Z_j = (1 - r^{j+1}) / (1-r) + r (1 - r^{m-1-j}) / (1-r), then the
    #    inverse CDF over the m levels
    z_norm = ((1.0 - torch.exp((jf + 1.0) * k["log_r"])) * k["inv_1mr"]
              + k["r_over_1mr"] * (1.0 - torch.exp((float(m - 1) - jf) * k["log_r"])))
    t = u_noise * z_norm
    cum = torch.zeros_like(jf)
    z = torch.zeros_like(j)
    for lvl in range(m):
        cum = cum + torch.exp(torch.abs(float(lvl) - jf) * k["log_r"])
        z = z + (cum <= t).to(torch.int32)
    # round-off in Z against the accumulated cum can push t past it
    return z.clamp(max=m - 1)


def decode_sum(z_sum: torch.Tensor, n: int, params: QMGeoParams) -> torch.Tensor:
    """The shared affine grid decode (same grid as RQM)."""
    return grid.decode_sum(z_sum, n, params)

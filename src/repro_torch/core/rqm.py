"""The Randomized Quantization Mechanism, Algorithm 2 of the paper, with
injected uniforms (counterpart of ``repro/core/rqm.py``).

``quantize_with_uniforms`` is the deterministic core the kernels are held
to: the same uniforms in, the same levels out. The reference's
``quantize(x, key)`` draws them from ``jax.random``, which this package
does not reimplement; the kernels draw them from the counter-based
splitmix32 stream (``kernels/ref.py`` routes those draws through here).

Per coordinate x in [-c, c]:

  1. grid  B(i) = -(c+delta) + i * step, i = 0..m-1  (see core.grid)
  2. keep mask: B(0), B(m-1) always kept; interior level i kept iff
     u_level[i] < q
  3. i_lo = max kept index <= j, i_hi = min kept index >= j+1,
     where x in [B(j), B(j+1))
  4. z = i_hi with prob (x - B(i_lo)) / (B(i_hi) - B(i_lo)), else i_lo
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.grid import GridGeometry, RQMParams, decode_sum, f32_const

__all__ = ["RQMParams", "bin_index", "decode_sum", "encode_value", "quantize_with_uniforms"]

# Python doubles enter as f32_const: rounded once to float32, as XLA rounds
# a weakly typed constant, and 0-d tensors, so that dividing by one is IEEE
# division on the card too (PyTorch's CUDA division by a Python scalar
# multiplies by its reciprocal)


def bin_index(x: torch.Tensor, params: GridGeometry) -> torch.Tensor:
    """j such that x in [B(j), B(j+1)), clipped to [0, m-2]."""
    j = torch.floor((x + f32_const(params.x_max, x.device)) / f32_const(params.step, x.device))
    return j.clamp(0, params.m - 2).to(torch.int32)


def encode_value(z: torch.Tensor, params: GridGeometry) -> torch.Tensor:
    """Map a level index back to its grid value B(z), in float32."""
    return f32_const(-params.x_max, z.device) + z.to(torch.float32) * f32_const(params.step, z.device)


def quantize_with_uniforms(x: torch.Tensor, u_levels: torch.Tensor, u_round: torch.Tensor,
                           params: RQMParams) -> torch.Tensor:
    """Deterministic RQM core: uniforms in, int32 levels out.

    x: any shape, clipped to [-c, c]; u_levels: ``x.shape + (m,)`` level
    keep draws; u_round: ``x.shape`` rounding draws. Returns int32 levels
    in [0, m-1] of x's shape."""
    m = params.m
    if tuple(u_levels.shape) != tuple(x.shape) + (m,):
        raise ValueError(f"u_levels shape {tuple(u_levels.shape)} != {tuple(x.shape) + (m,)}")
    if tuple(u_round.shape) != tuple(x.shape):
        raise ValueError(f"u_round shape {tuple(u_round.shape)} != {tuple(x.shape)}")
    dev = x.device
    c = float(np.float32(params.c))
    x = x.to(torch.float32).clamp(-c, c)
    j = bin_index(x, params)

    idx = torch.arange(m, dtype=torch.int32, device=dev)
    interior = (idx > 0) & (idx < m - 1)
    # endpoints always kept, an interior level iff its draw is below q
    keep = torch.where(interior, u_levels < f32_const(params.q, dev), True)
    j_b = j[..., None]
    # largest kept index <= j (keep[0] is True), smallest kept > j (keep[m-1])
    i_lo = torch.where(keep & (idx <= j_b), idx, -1).amax(-1)
    i_hi = torch.where(keep & (idx > j_b), idx, m).amin(-1)

    b_lo = encode_value(i_lo, params)
    b_hi = encode_value(i_hi, params)
    p_up = (x - b_lo) / (b_hi - b_lo)
    return torch.where(u_round.to(torch.float32) < p_up, i_hi, i_lo).to(torch.int32)

"""The element-wise RQM encode on explicit RNG counters.

Counterpart of ``repro/kernels/rqm_kernel.py``. ``rqm_encode_counters``
is the plain PyTorch version of the device function in
``csrc/rqm_encode.cuh``, which the CUDA quantize and round-sum kernels
inline; the float32 operations and their order are the same in both:

  1. clip x to [-c, c];
  2. bin ``j = floor((x + x_max) / step)`` clamped to [0, m-2];
  3. interior level ``l`` (streams 1..m-2) is kept iff its uniform is
     below q; the endpoints are always kept; take the nearest kept level
     below (``i_lo``) and above (``i_hi``) the bin;
  4. round up to ``i_hi`` iff the stream-m uniform is below
     ``(x - B(i_lo)) / (B(i_hi) - B(i_lo))``.

``rqm_quantize`` encodes a (rows, dim) batch (the Pallas kernel
``rqm_quantize_2d``, CUDA entry ``rqm_quantize`` in ``csrc/quantize.cu``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.grid import RQMParams
from repro_torch.kernels import quantize
from repro_torch.kernels._build import F32, I32
from repro_torch.kernels.prng import random_uniform


def f32_constants(params: RQMParams) -> dict:
    """The float32 scalars the encode uses, each rounded once from the
    reference's Python double (``rqm_kernel.py:73-79``)."""
    return {
        "c": float(np.float32(params.c)),
        "x_max": float(np.float32(params.x_max)),
        "step": float(np.float32(params.step)),
        "q": float(np.float32(params.q)),
    }


def kernel_args(params: RQMParams):
    """ctypes types and values of the constants the CUDA entries take."""
    k = f32_constants(params)
    return (F32, F32, F32, F32, I32), (k["c"], k["x_max"], k["step"], k["q"], params.m)


def rqm_bracket(x: torch.Tensor, seed: int, counter: torch.Tensor, params: RQMParams):
    """Steps 1-3 of the encode: ``(j, i_lo, i_hi, p_up)``, the bin, the
    nearest kept levels below and above it, and the probability of
    rounding up to ``i_hi``."""
    k = f32_constants(params)
    m = params.m
    # divide by a device tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not IEEE division
    step = torch.tensor(k["step"], dtype=torch.float32, device=x.device)
    x = x.to(torch.float32).clamp(-k["c"], k["c"])
    j = torch.floor((x + k["x_max"]) / step).clamp(0, m - 2).to(torch.int32)

    i_lo = torch.zeros_like(j)
    i_hi = torch.full_like(j, m - 1)
    for lvl in range(1, m - 1):
        keep = random_uniform(seed, counter, lvl) < k["q"]
        below = lvl <= j
        i_lo = torch.where(keep & below, lvl, i_lo)
        i_hi = torch.where(keep & ~below, torch.clamp(i_hi, max=lvl), i_hi)

    b_lo = -k["x_max"] + i_lo.to(torch.float32) * k["step"]
    b_hi = -k["x_max"] + i_hi.to(torch.float32) * k["step"]
    p_up = (x - b_lo) / (b_hi - b_lo)
    return j, i_lo, i_hi, p_up


def rqm_encode_counters(x: torch.Tensor, seed: int, counter: torch.Tensor,
                        params: RQMParams) -> torch.Tensor:
    """int32 RQM levels of ``x`` where element i draws counter ``counter[i]``."""
    _, i_lo, i_hi, p_up = rqm_bracket(x, seed, counter, params)
    u_round = random_uniform(seed, counter, params.m)
    return torch.where(u_round < p_up, i_hi, i_lo).to(torch.int32)


def rqm_quantize_plain(x: torch.Tensor, seed: int, params: RQMParams,
                       row_offset: int = 0) -> torch.Tensor:
    """Plain version of ``rqm_quantize``."""
    return quantize.quantize_plain(rqm_encode_counters, x, seed, params, row_offset)


def rqm_quantize(x: torch.Tensor, seed: int, params: RQMParams,
                 row_offset: int = 0) -> torch.Tensor:
    """int32 RQM levels of a (rows, dim) float32 batch; element (r, c)
    draws counter ``(row_offset + r) * dim + c``."""
    return quantize.quantize("rqm_quantize", rqm_encode_counters, kernel_args(params),
                             x, seed, params, row_offset)

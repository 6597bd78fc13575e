"""The element-wise PBM encode on explicit RNG counters, counterpart of
``repro/kernels/pbm_kernel.py``.

``pbm_encode_counters`` is the plain PyTorch version of the device function
in ``csrc/pbm_encode.cuh``: m Bernoulli trials on streams 0..m-1,

    z = sum_{t < m} [u_t < 1/2 + (theta * x) / c],

in that association. ``pbm_quantize`` encodes a (rows, dim) batch (the
Pallas kernel ``pbm_quantize_2d``, CUDA entry ``pbm_quantize`` in
``csrc/quantize.cu``).

The device function tests each draw in integers, ``bits <= (K << 8) - 1``
with K = ``prob_threshold(p)``; ``pbm_encode_threshold`` transcribes that
form for the tests, which hold it to the float compare above.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pbm import PBMParams
from repro_torch.kernels import quantize
from repro_torch.kernels._build import F32, I32
from repro_torch.kernels.prng import MASK32, random_bits, random_uniform


def f32_constants(params: PBMParams) -> dict:
    """The float32 scalars the encode uses, each rounded once from the
    reference's Python double (``pbm_kernel.py:26-29``)."""
    return {"c": float(np.float32(params.c)), "theta": float(np.float32(params.theta))}


def kernel_args(params: PBMParams):
    """ctypes types and values of the constants the CUDA entries take."""
    k = f32_constants(params)
    return (F32, F32, I32), (k["c"], k["theta"], params.m)


def success_prob(x: torch.Tensor, params: PBMParams) -> torch.Tensor:
    """float32 p(x) = 1/2 + (theta * clip(x)) / c; NaN stays NaN."""
    k = f32_constants(params)
    # divide by a device tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not IEEE division
    c = torch.tensor(k["c"], dtype=torch.float32, device=x.device)
    x = x.to(torch.float32).clamp(-k["c"], k["c"])
    return 0.5 + (k["theta"] * x) / c


def pbm_encode_counters(x: torch.Tensor, seed, counter: torch.Tensor,
                        params: PBMParams) -> torch.Tensor:
    """int32 Binomial(m, p(x)) draws where element i draws counter ``counter[i]``."""
    p = success_prob(x, params)
    z = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for trial in range(params.m):
        z = z + (random_uniform(seed, counter, trial) < p).to(torch.int32)
    return z


def prob_threshold(prob: torch.Tensor) -> torch.Tensor:
    """int64 K = ceil(prob * 2**24), saturated to [0, 2**24], 0 where prob
    is NaN. A draw's uniform ``k * 2**-24`` (k = bits >> 8) is below the
    float32 prob iff the integer k is below K: the product is exact in
    float32, and an integer is below a real iff it is below its ceiling."""
    k = torch.ceil(prob.to(torch.float32) * float(1 << 24))
    return torch.nan_to_num(k, nan=0.0).clamp(0, 1 << 24).to(torch.int64)


def pbm_encode_threshold(x: torch.Tensor, seed, counter: torch.Tensor,
                         params: PBMParams) -> torch.Tensor:
    """``pbm_encode_counters`` as ``csrc/pbm_encode.cuh`` computes it: each
    draw's 32 bits against ``(K << 8) - 1`` (mod 2**32), which K = 2**24
    wraps to take every draw, and a count of 0 where K is 0."""
    k = prob_threshold(success_prob(x, params))
    threshold = ((k << 8) - 1) & MASK32
    z = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for trial in range(params.m):
        z = z + (random_bits(seed, counter, trial) <= threshold).to(torch.int32)
    return torch.where(k != 0, z, 0)


def pbm_quantize_plain(x: torch.Tensor, seed, params: PBMParams,
                       row_offset: int = 0) -> torch.Tensor:
    """Plain version of ``pbm_quantize``."""
    return quantize.quantize_plain(pbm_encode_counters, x, seed, params, row_offset)


def pbm_quantize(x: torch.Tensor, seed, params: PBMParams,
                 row_offset: int = 0) -> torch.Tensor:
    """int32 PBM levels (0..m) of a (rows, dim) float32 batch; element
    (r, c) draws counter ``(row_offset + r) * dim + c``."""
    return quantize.quantize("pbm_quantize", pbm_encode_counters, kernel_args(params),
                             x, seed, params, row_offset)

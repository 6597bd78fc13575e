"""The element-wise RQM encode on explicit RNG counters.

Counterpart of ``repro/kernels/rqm_kernel.py``. ``rqm_encode_counters``
is the plain PyTorch version of the device function in
``csrc/rqm_encode.cuh``, which the CUDA quantize and round-sum kernels
inline; the steps and their float32 operations are the same in both:

  1. clip x to [-c, c];
  2. bin ``j = floor((x + x_max) / step)`` clamped to [0, m-2];
  3. interior level ``l`` (streams 1..m-2) is kept iff its uniform is
     below q, tested in integers: its bits are at most ``keep_le``
     (``keep_constants``); the kept levels form a bit mask, 32 levels a
     word, and the nearest kept level below (``i_lo``) and above
     (``i_hi``) the bin are its highest set bit at or below j and its
     lowest set bit above j; the endpoints are always kept;
  4. round up to ``i_hi`` iff the stream-m uniform is below
     ``(x - B(i_lo)) / (B(i_hi) - B(i_lo))``.

The reference (``rqm_kernel.py:85-90``) finds the same bracket with a
running max and min over the levels' float uniforms; both give the same
levels for every input.

``rqm_quantize`` encodes a (rows, dim) batch (the Pallas kernel
``rqm_quantize_2d``, CUDA entry ``rqm_quantize`` in ``csrc/quantize.cu``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.grid import RQMParams
from repro_torch.kernels import quantize
from repro_torch.kernels._build import F32, I32, U32
from repro_torch.kernels.prng import MASK32, random_bits, random_uniform

MASK_LEVELS = 32  # levels per keep-mask word, as in csrc/rqm_encode.cuh


def f32_constants(params: RQMParams) -> dict:
    """The float32 scalars of the encode's float steps, each rounded once
    from the reference's Python double (``rqm_kernel.py:73-79``); q enters
    as ``keep_constants``."""
    return {
        "c": float(np.float32(params.c)),
        "x_max": float(np.float32(params.x_max)),
        "step": float(np.float32(params.step)),
    }


def keep_threshold(q: float) -> int:
    """K = ceil(float32(q) * 2**24). A draw's uniform ``k * 2**-24`` (k =
    bits >> 8, exact in float32) is below float32 q iff the integer k is
    below K: the product is exact in a double, and an integer is below a
    real iff it is below its ceiling."""
    return math.ceil(float(np.float32(q)) * (1 << 24))


def keep_constants(q: float) -> tuple[int, int]:
    """``(keep_le, keep_any)``: a level is kept iff its 32 random bits are
    at most keep_le and keep_any is set. ``bits >> 8 < K`` iff ``bits <
    K << 8`` iff ``bits <= (K << 8) - 1``; K = 2**24 (float32(q) == 1)
    wraps to 2**32 - 1 and keeps every draw, as it should; K = 0 (float32(q)
    == 0) wraps too, so keep_any is 0 then and keeps none."""
    k = keep_threshold(q)
    return ((k << 8) - 1) & MASK32, MASK32 if k else 0


def kernel_args(params: RQMParams):
    """ctypes types and values of the constants the CUDA entries take."""
    k = f32_constants(params)
    return ((F32, F32, F32, U32, U32, I32),
            (k["c"], k["x_max"], k["step"], *keep_constants(params.q), params.m))


def _highest_bit(v: torch.Tensor) -> torch.Tensor:
    """31 - clz: the index of the highest set bit of each nonzero int64
    ``v`` below 2**32 (its float64 conversion is exact)."""
    return torch.frexp(v.to(torch.float64)).exponent.to(torch.int64) - 1


def _lowest_bit(v: torch.Tensor) -> torch.Tensor:
    """ffs - 1: the index of the lowest set bit of each nonzero ``v``."""
    return _highest_bit(v & -v)


def keep_mask(seed, counter: torch.Tensor, params: RQMParams, base: int) -> torch.Tensor:
    """int64 keep bits of the interior levels ``base .. base + 31`` (bit b
    for level base + b) of each counter."""
    keep_le, keep_any = keep_constants(params.q)
    mask = torch.zeros(counter.shape, dtype=torch.int64, device=counter.device)
    for lvl in range(max(base, 1), min(base + MASK_LEVELS, params.m - 1)):
        keep = (random_bits(seed, counter, lvl) <= keep_le).to(torch.int64)
        mask |= keep << (lvl - base)
    return mask & keep_any


def rqm_bracket(x: torch.Tensor, seed, counter: torch.Tensor, params: RQMParams):
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

    i_lo = torch.zeros(j.shape, dtype=torch.int64, device=x.device)
    i_hi = torch.full_like(i_lo, m - 1)
    for base in range(0, m - 1, MASK_LEVELS):  # mask words in level order
        mask = keep_mask(seed, counter, params, base)
        rel = j.to(torch.int64) - base  # the bin's bit in this word
        at_or_below = torch.where(rel < 0, 0, (2 << rel.clamp(0, MASK_LEVELS - 1)) - 1)
        lo, hi = mask & at_or_below, mask & ~at_or_below
        i_lo = torch.where(lo != 0, base + _highest_bit(lo), i_lo)
        i_hi = torch.where((hi != 0) & (i_hi == m - 1), base + _lowest_bit(hi), i_hi)
    i_lo, i_hi = i_lo.to(torch.int32), i_hi.to(torch.int32)

    b_lo = -k["x_max"] + i_lo.to(torch.float32) * k["step"]
    b_hi = -k["x_max"] + i_hi.to(torch.float32) * k["step"]
    p_up = (x - b_lo) / (b_hi - b_lo)
    return j, i_lo, i_hi, p_up


def rqm_encode_counters(x: torch.Tensor, seed, counter: torch.Tensor,
                        params: RQMParams) -> torch.Tensor:
    """int32 RQM levels of ``x`` where element i draws counter ``counter[i]``."""
    _, i_lo, i_hi, p_up = rqm_bracket(x, seed, counter, params)
    u_round = random_uniform(seed, counter, params.m)
    return torch.where(u_round < p_up, i_hi, i_lo).to(torch.int32)


def rqm_quantize_plain(x: torch.Tensor, seed, params: RQMParams,
                       row_offset: int = 0) -> torch.Tensor:
    """Plain version of ``rqm_quantize``."""
    return quantize.quantize_plain(rqm_encode_counters, x, seed, params, row_offset)


def rqm_quantize(x: torch.Tensor, seed, params: RQMParams,
                 row_offset: int = 0) -> torch.Tensor:
    """int32 RQM levels of a (rows, dim) float32 batch; element (r, c)
    draws counter ``(row_offset + r) * dim + c``."""
    return quantize.quantize("rqm_quantize", rqm_encode_counters, kernel_args(params),
                             x, seed, params, row_offset)

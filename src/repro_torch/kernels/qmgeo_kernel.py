"""The element-wise QMGeo encode on explicit RNG counters, counterpart of
``repro/kernels/qmgeo_kernel.py``.

``qmgeo_encode_counters`` is the plain PyTorch version of the device
function in ``csrc/qmgeo_encode.cuh``: stream 0 drives the stochastic
rounding and stream 1 the truncated-geometric noise of
``core/qmgeo.py:quantize_with_uniforms``. ``qmgeo_quantize`` encodes a
(rows, dim) batch (the Pallas kernel ``qmgeo_quantize_2d``, CUDA entry
``qmgeo_quantize`` in ``csrc/quantize.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.core.qmgeo import QMGeoParams, f32_constants, quantize_with_uniforms
from repro_torch.kernels import quantize
from repro_torch.kernels._build import F32, I32
from repro_torch.kernels.prng import random_uniform


def kernel_args(params: QMGeoParams):
    """ctypes types and values of the constants the CUDA entries take."""
    k = f32_constants(params)
    return ((F32,) * 6 + (I32,),
            (k["c"], k["x_max"], k["step"], k["log_r"], k["inv_1mr"], k["r_over_1mr"],
             params.m))


def qmgeo_encode_counters(x: torch.Tensor, seed: int, counter: torch.Tensor,
                          params: QMGeoParams) -> torch.Tensor:
    """int32 QMGeo levels where element i draws counter ``counter[i]``."""
    return quantize_with_uniforms(x, random_uniform(seed, counter, 0),
                                  random_uniform(seed, counter, 1), params)


def qmgeo_quantize_plain(x: torch.Tensor, seed: int, params: QMGeoParams,
                         row_offset: int = 0) -> torch.Tensor:
    """Plain version of ``qmgeo_quantize``."""
    return quantize.quantize_plain(qmgeo_encode_counters, x, seed, params, row_offset)


def qmgeo_quantize(x: torch.Tensor, seed: int, params: QMGeoParams,
                   row_offset: int = 0) -> torch.Tensor:
    """int32 QMGeo levels of a (rows, dim) float32 batch; element (r, c)
    draws counter ``(row_offset + r) * dim + c``."""
    return quantize.quantize("qmgeo_quantize", qmgeo_encode_counters, kernel_args(params),
                             x, seed, params, row_offset)

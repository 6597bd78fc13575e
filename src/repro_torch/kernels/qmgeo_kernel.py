"""The element-wise QMGeo encode on explicit RNG counters, counterpart of
``repro/kernels/qmgeo_kernel.py``.

``qmgeo_encode_counters`` is the plain PyTorch version of the device
function in ``csrc/qmgeo_encode.cuh``: stream 0 drives the stochastic
rounding and stream 1 the truncated-geometric noise of
``core/qmgeo.py:quantize_with_uniforms``. ``qmgeo_quantize`` encodes a
(rows, dim) batch (the Pallas kernel ``qmgeo_quantize_2d``, CUDA entry
``qmgeo_quantize`` in ``csrc/quantize.cu``).

The device function takes the noise step from per-block level tables:
``level_tables`` and ``level_search`` transcribe them for the tests
(``qmgeo_encode_tabled``), which hold them to the running walk of
``quantize_with_uniforms`` and to the JAX reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.qmgeo import (
    QMGeoParams,
    f32_constants,
    quantize_with_uniforms,
    round_to_level,
)
from repro_torch.kernels import quantize
from repro_torch.kernels._build import F32, I32
from repro_torch.kernels.prng import random_uniform


def kernel_args(params: QMGeoParams):
    """ctypes types and values of the constants the CUDA entries take."""
    k = f32_constants(params)
    return ((F32,) * 6 + (I32,),
            (k["c"], k["x_max"], k["step"], k["log_r"], k["inv_1mr"], k["r_over_1mr"],
             params.m))


def qmgeo_encode_counters(x: torch.Tensor, seed, counter: torch.Tensor,
                          params: QMGeoParams) -> torch.Tensor:
    """int32 QMGeo levels where element i draws counter ``counter[i]``."""
    return quantize_with_uniforms(x, random_uniform(seed, counter, 0),
                                  random_uniform(seed, counter, 1), params)


TREE_MAX_M = 64  # larger m walk over the weights, as in csrc/qmgeo_encode.cuh


def level_tables(params: QMGeoParams, device=None):
    """The tables a block of ``csrc/qmgeo_encode.cuh`` builds, with the
    plain version's float32 steps: ``(weight, norm, tree)``. ``weight[d]
    = exp(d log r)`` for d in [0, m]; ``norm[j]`` the normaliser Z_j;
    ``tree`` (P, m), P the least power of two >= m, or None above
    TREE_MAX_M: node n (1 <= n < P) of column j holds the running sum
    C[j][k] of ``weight[|i - j|]`` over i <= k for the k that the binary
    search reads at n, +inf for k >= m; row 0 is unused. (Without a tree
    the device keeps the first 4096 weights in shared memory, makes the
    rest in the element by the same expression, and forms ``norm[j]`` in
    the element: the same values.)"""
    k = f32_constants(params)
    m = params.m
    weight = torch.exp(torch.arange(m + 1, dtype=torch.float32, device=device) * k["log_r"])
    j = torch.arange(m, device=device)
    norm = ((1.0 - weight[j + 1]) * k["inv_1mr"]
            + k["r_over_1mr"] * (1.0 - weight[m - 1 - j]))
    if m > TREE_MAX_M:
        return weight, norm, None
    span = 1 << (m - 1).bit_length()
    tree = torch.zeros((span, m), dtype=torch.float32, device=device)
    cum = torch.zeros(m, dtype=torch.float32, device=device)
    for idx in range(span - 1):
        if idx < m:
            cum = cum + weight[(idx - j).abs()]
        v = idx + 1
        node = (v + span) >> (v & -v).bit_length()
        tree[node] = cum if idx < m else float("inf")
    return weight, norm, tree


def level_search(tables, j: torch.Tensor, target: torch.Tensor, m: int) -> torch.Tensor:
    """int32 ``min(#{k : C[j][k] <= target}, m - 1)``: the binary search
    down the tree (``n = 2n + [tree[n][j] <= target]`` log2(P) times,
    count ``n - P``) or, without a tree, the walk over the weights."""
    weight, _, tree = tables
    j = j.to(torch.int64)
    if tree is not None:
        span = tree.shape[0]
        n = torch.ones_like(j)
        for _ in range(span.bit_length() - 1):
            n = 2 * n + (tree[n, j] <= target).to(torch.int64)
        z = n - span
    else:
        cum = torch.zeros(target.shape, dtype=torch.float32, device=target.device)
        z = torch.zeros_like(j)
        for lvl in range(m):
            cum = cum + weight[(lvl - j).abs()]
            z = z + (cum <= target).to(torch.int64)
    return z.clamp(max=m - 1).to(torch.int32)


def qmgeo_encode_tabled(x: torch.Tensor, seed, counter: torch.Tensor,
                        params: QMGeoParams) -> torch.Tensor:
    """``qmgeo_encode_counters`` as ``csrc/qmgeo_encode.cuh`` computes it:
    the rounding, then ``target = u_noise * Z[j]`` searched in the tables."""
    j, _ = round_to_level(x, random_uniform(seed, counter, 0), params)
    tables = level_tables(params, x.device)
    target = random_uniform(seed, counter, 1) * tables[1][j.to(torch.int64)]
    return level_search(tables, j, target, params.m)


def qmgeo_quantize_plain(x: torch.Tensor, seed, params: QMGeoParams,
                         row_offset: int = 0) -> torch.Tensor:
    """Plain version of ``qmgeo_quantize``."""
    return quantize.quantize_plain(qmgeo_encode_counters, x, seed, params, row_offset)


def qmgeo_quantize(x: torch.Tensor, seed, params: QMGeoParams,
                   row_offset: int = 0) -> torch.Tensor:
    """int32 QMGeo levels of a (rows, dim) float32 batch; element (r, c)
    draws counter ``(row_offset + r) * dim + c``."""
    return quantize.quantize("qmgeo_quantize", qmgeo_encode_counters, kernel_args(params),
                             x, seed, params, row_offset)

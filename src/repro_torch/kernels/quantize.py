"""The per-element quantize of a (rows, dim) cohort batch, shared by the
three mechanisms' kernel modules (``rqm_kernel``, ``pbm_kernel``,
``qmgeo_kernel``).

Counterpart of the reference's ``*_quantize_2d`` Pallas kernels and their
``_*_block`` bodies: element (r, c) draws RNG counter ``(row_offset + r) *
dim + c`` (mod 2**32), the counter the fused round sums give it too, so
``quantize(...).sum(0)`` equals the round sum bit for bit. A CUDA tensor
launches the mechanism's entry in ``csrc/quantize.cu``; a CPU tensor runs
the plain version, the mechanism's ``*_encode_counters`` on those counters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, P, U32
from repro_torch.kernels.prng import MASK32, mul32

_ARGS = (P, P, I32, I32, U32, U32)


def check_batch(x: torch.Tensor, seed: int, row_offset: int) -> None:
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (rows, dim) batch, got {tuple(x.shape)}")
    for name, v in (("seed", seed), ("row_offset", row_offset)):
        if not 0 <= int(v) <= MASK32:
            raise ValueError(f"{name} must be a uint32, got {v}")


def batch_counters(row_start: int, rows: int, dim: int, row_offset: int, device) -> torch.Tensor:
    """int64 RNG counters of rows ``row_start .. row_start + rows`` of a
    (., dim) batch placed at ``row_offset``: ``(row_offset + r) * dim + c``
    mod 2**32."""
    r = torch.arange(row_start, row_start + rows, dtype=torch.int64, device=device)
    cols = torch.arange(dim, dtype=torch.int64, device=device)
    return (mul32((row_offset + r) & MASK32, dim)[:, None] + cols) & MASK32


def quantize_plain(encode, x: torch.Tensor, seed: int, params, row_offset: int = 0) -> torch.Tensor:
    """Plain version: ``encode(x, seed, counters, params)`` on the batch's
    counters, int32 levels of x's shape."""
    check_batch(x, seed, row_offset)
    rows, dim = x.shape
    return encode(x, seed, batch_counters(0, rows, dim, row_offset, x.device), params)


def quantize(entry: str, encode, kernel_args, x: torch.Tensor, seed: int, params,
             row_offset: int = 0) -> torch.Tensor:
    """(rows, dim) float32 -> (rows, dim) int32 levels: the CUDA entry
    ``entry`` for a CUDA tensor, the plain version on the CPU.
    ``kernel_args`` is the mechanism's ``(argtypes, values)`` of its
    float32 constants and m."""
    if not x.is_cuda:
        return quantize_plain(encode, x, seed, params, row_offset)
    check_batch(x, seed, row_offset)
    _build.check_cuda("x", x, torch.float32)
    rows, dim = x.shape
    out = torch.empty((rows, dim), dtype=torch.int32, device=x.device)
    types, values = kernel_args
    with torch.cuda.device(x.device):
        _build.launch("quantize", entry, _ARGS + types + (P,),
                      x.data_ptr(), out.data_ptr(), rows, dim, int(seed), int(row_offset),
                      *values, _build.stream_of(x))
    return out

"""The per-element quantize of a (rows, dim) cohort batch, shared by the
three mechanisms' kernel modules (``rqm_kernel``, ``pbm_kernel``,
``qmgeo_kernel``).

Counterpart of the reference's ``*_quantize_2d`` Pallas kernels and their
``_*_block`` bodies: element (r, c) draws RNG counter ``(row_offset + r) *
dim + c`` (mod 2**32), the counter the fused round sums give it too, so
``quantize(...).sum(0)`` equals the round sum bit for bit. A CUDA tensor
launches the mechanism's entry in ``csrc/quantize.cu``; a CPU tensor runs
the plain version, the mechanism's ``*_encode_counters`` on those counters;
a meta tensor (a dry run's) an empty int32 output and the kernel's
traffic charged (``_build.charge``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, P, U32
from repro_torch.kernels.prng import MASK32, mul32


def check_batch(x: torch.Tensor, seed, row_offset: int) -> None:
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (rows, dim) batch, got {tuple(x.shape)}")
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype != torch.int32 or seed.device != x.device:
            raise ValueError(f"a tensor seed must be 1 int32 element on {x.device}, got "
                             f"{tuple(seed.shape)} {seed.dtype} on {seed.device}")
    elif not 0 <= int(seed) <= MASK32:
        raise ValueError(f"seed must be a uint32, got {seed}")
    if not 0 <= int(row_offset) <= MASK32:
        raise ValueError(f"row_offset must be a uint32, got {row_offset}")


def seed_arg(entry: str, seed):
    """The C entry and its seed argument: ``entry`` with the uint32 by
    value, or ``entry + "_dev"`` with the tensor seed's device pointer."""
    if isinstance(seed, torch.Tensor):
        return f"{entry}_dev", P, seed.data_ptr()
    return entry, U32, int(seed)


def batch_counters(row_start: int, rows: int, dim: int, row_offset: int, device) -> torch.Tensor:
    """int64 RNG counters of rows ``row_start .. row_start + rows`` of a
    (., dim) batch placed at ``row_offset``: ``(row_offset + r) * dim + c``
    mod 2**32."""
    r = torch.arange(row_start, row_start + rows, dtype=torch.int64, device=device)
    cols = torch.arange(dim, dtype=torch.int64, device=device)
    return (mul32((row_offset + r) & MASK32, dim)[:, None] + cols) & MASK32


def quantize_plain(encode, x: torch.Tensor, seed, params, row_offset: int = 0) -> torch.Tensor:
    """Plain version: ``encode(x, seed, counters, params)`` on the batch's
    counters, int32 levels of x's shape."""
    check_batch(x, seed, row_offset)
    rows, dim = x.shape
    return encode(x, seed, batch_counters(0, rows, dim, row_offset, x.device), params)


def quantize(entry: str, encode, kernel_args, x: torch.Tensor, seed, params,
             row_offset: int = 0) -> torch.Tensor:
    """(rows, dim) float32 -> (rows, dim) int32 levels: the CUDA entry
    ``entry`` for a CUDA tensor, the plain version on the CPU, the meta
    branch on the meta device.
    ``kernel_args`` is the mechanism's ``(argtypes, values)`` of its
    float32 constants and m."""
    meta = _build.is_meta(x)
    if not (x.is_cuda or meta):
        return quantize_plain(encode, x, seed, params, row_offset)
    check_batch(x, seed, row_offset)
    (_build.check_meta if meta else _build.check_cuda)("x", x, torch.float32)
    rows, dim = x.shape
    out = torch.empty((rows, dim), dtype=torch.int32, device=x.device)
    operands = (x, out) + ((seed,) if isinstance(seed, torch.Tensor) else ())
    types, values = kernel_args
    entry, seed_type, seed = seed_arg(entry, seed)
    if not meta:
        with torch.cuda.device(x.device):
            _build.launch("quantize", entry, (P, P, I32, I32, seed_type, U32) + types + (P,),
                          x.data_ptr(), out.data_ptr(), rows, dim, seed, int(row_offset),
                          *values, _build.stream_of(x))
    _build.charge(entry, *operands)
    return out

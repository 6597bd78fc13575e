"""The fused RQM round: clip -> encode -> weighted cohort sum.

Counterpart of ``repro/kernels/fused_round_kernel.py``. Two functions,
each with a CUDA kernel (``csrc/round_sum.cu``) and a plain PyTorch
version that transcribes the reference's CPU twin:

  * ``round_sum``: the dense (dim,) int32 sum ``sum_r w_r * z_r``
    (``round_sum_2d`` / ``round_sum_jnp`` in JAX);
  * ``round_sum_packed``: the same sum as planar packed wire words
    (``round_sum_packed_2d`` / ``round_sum_packed_jnp``), bit-identical
    to ``wire.pack_bits`` of the dense sum while no field overflows.

Element (r, c) draws RNG counter ``(row_offset + r) * dim + c`` (mod
2**32), so a sum equals the reference's for the same uint32 seed.
Weights are one int32 per row (0 drops a row). The wrappers launch the
kernel for CUDA tensors and run the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import wire
from repro_torch.core.grid import RQMParams
from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, P, U32
from repro_torch.kernels.prng import MASK32, mul32
from repro_torch.kernels.rqm_kernel import f32_constants, rqm_encode_counters

BLOCK_ROWS = 8  # rows per chunk of the plain version, as in JAX

_DENSE_ARGS = (P, P, P, I32, I32, U32, U32, F32, F32, F32, F32, I32, P)
_PACKED_ARGS = (P, P, P, I32, I32, I32, I32, U32, U32, F32, F32, F32, F32, I32, P)


def _check(x: torch.Tensor, w: torch.Tensor, seed: int, row_offset: int):
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (rows, dim) batch, got {tuple(x.shape)}")
    if w.shape != (x.shape[0],):
        raise ValueError(f"weights must be ({x.shape[0]},), got {tuple(w.shape)}")
    for name, v in (("seed", seed), ("row_offset", row_offset)):
        if not 0 <= int(v) <= MASK32:
            raise ValueError(f"{name} must be a uint32, got {v}")


def _chunk_sums(x, w, seed, row_offset, params):
    """Yield each row chunk's (dim,) int64 weighted level sum."""
    rows, dim = x.shape
    cols = torch.arange(dim, dtype=torch.int64, device=x.device)
    for start in range(0, rows, BLOCK_ROWS):
        stop = min(start + BLOCK_ROWS, rows)
        r = torch.arange(start, stop, dtype=torch.int64, device=x.device)
        counter = (mul32((row_offset + r) & MASK32, dim)[:, None] + cols) & MASK32
        z = rqm_encode_counters(x[start:stop], seed, counter, params)
        yield (z.to(torch.int64) * w[start:stop, None].to(torch.int64)).sum(0)


def round_sum_plain(x, w, seed: int, row_offset: int, params: RQMParams) -> torch.Tensor:
    """Plain version of the dense round sum (``round_sum_jnp``)."""
    _check(x, w, seed, row_offset)
    acc = torch.zeros(x.shape[1], dtype=torch.int64, device=x.device)
    for part in _chunk_sums(x, w, seed, row_offset, params):
        acc += part
    return wire.to_int32(acc)


def round_sum_packed_plain(x, w, seed: int, row_offset: int, params: RQMParams,
                           bits: int) -> torch.Tensor:
    """Plain version of the packed round sum (``round_sum_packed_jnp``):
    each chunk's partial sum is packed and the words accumulate."""
    _check(x, w, seed, row_offset)
    words = wire.packed_words(x.shape[1], bits)
    acc = torch.zeros(words, dtype=torch.int64, device=x.device)
    for part in _chunk_sums(x, w, seed, row_offset, params):
        acc += wire.pack_bits(part, bits, words=words).to(torch.int64)
    return wire.to_int32(acc)


def round_sum(x, w, seed: int, row_offset: int, params: RQMParams) -> torch.Tensor:
    """Dense fused round sum: x (rows, dim) float32, w (rows,) int32 ->
    (dim,) int32. CUDA kernel for CUDA tensors, plain version on the CPU."""
    if not x.is_cuda:
        return round_sum_plain(x, w, seed, row_offset, params)
    _check(x, w, seed, row_offset)
    _build.check_cuda("x", x, torch.float32)
    _build.check_cuda("weights", w, torch.int32)
    rows, dim = x.shape
    out = torch.empty(dim, dtype=torch.int32, device=x.device)
    k = f32_constants(params)
    with torch.cuda.device(x.device):
        _build.launch(
            "round_sum", "rqm_round_sum_dense", _DENSE_ARGS,
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, dim,
            int(seed), int(row_offset), k["c"], k["x_max"], k["step"], k["q"],
            params.m, _build.stream_of(x),
        )
    return out


def round_sum_packed(x, w, seed: int, row_offset: int, params: RQMParams,
                     bits: int) -> torch.Tensor:
    """Packed fused round sum: (rows, dim) float32 -> (ceil(dim / (32 //
    bits)),) int32 words. Any word count; pad coordinates are zero."""
    if not x.is_cuda:
        return round_sum_packed_plain(x, w, seed, row_offset, params, bits)
    _check(x, w, seed, row_offset)
    _build.check_cuda("x", x, torch.float32)
    _build.check_cuda("weights", w, torch.int32)
    rows, dim = x.shape
    words = wire.packed_words(dim, bits)
    out = torch.empty(words, dtype=torch.int32, device=x.device)
    k = f32_constants(params)
    with torch.cuda.device(x.device):
        _build.launch(
            "round_sum", "rqm_round_sum_packed", _PACKED_ARGS,
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, dim, words,
            int(bits), int(seed), int(row_offset), k["c"], k["x_max"],
            k["step"], k["q"], params.m, _build.stream_of(x),
        )
    return out

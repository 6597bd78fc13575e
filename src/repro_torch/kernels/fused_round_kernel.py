"""The fused round: clip -> encode -> weighted cohort sum.

Counterpart of ``repro/kernels/fused_round_kernel.py``. Two functions,
each with CUDA kernels (``csrc/round_sum.cu``) and a plain PyTorch version
that transcribes the reference's CPU twin:

  * ``round_sum``: the dense (dim,) int32 sum ``sum_r w_r * z_r``
    (``round_sum_2d`` / ``round_sum_jnp`` in JAX);
  * ``round_sum_packed``: the same sum as planar packed wire words
    (``round_sum_packed_2d`` / ``round_sum_packed_jnp``), bit-identical
    to ``wire.pack_bits`` of the dense sum while no field overflows.

``encode_name`` picks the per-element encoder from ``ENCODERS`` (rqm, pbm,
qmgeo), as ``round_sum_jnp`` does. Element (r, c) draws RNG counter
``(row_offset + r) * dim + c`` (mod 2**32), so a sum equals the
reference's for the same uint32 seed. Weights are one int32 per row (0
drops a row). The seed is an int or a 1-element int32 device tensor, as
in ``quantize`` (a tensor seed launches the ``_dev`` entry, which reads it
from device memory). The wrappers launch the kernel for CUDA tensors, run the
plain version for CPU tensors, and for meta tensors (a dry run's) return
an empty output and charge the kernel's traffic (``_build.charge``). The CUDA packed kernel takes rqm and qmgeo:
the PBM mechanism's sum never travels packed.
"""
from __future__ import annotations

import torch

from repro_torch.core import wire
from repro_torch.kernels import _build, pbm_kernel, qmgeo_kernel, quantize, rqm_kernel
from repro_torch.kernels._build import I32, P, U32

BLOCK_ROWS = 8  # rows per chunk of the plain version, as in JAX

# encode_name -> (plain per-element encoder, its CUDA constants)
ENCODERS = {
    "rqm": (rqm_kernel.rqm_encode_counters, rqm_kernel.kernel_args),
    "pbm": (pbm_kernel.pbm_encode_counters, pbm_kernel.kernel_args),
    "qmgeo": (qmgeo_kernel.qmgeo_encode_counters, qmgeo_kernel.kernel_args),
}
PACKED_KERNELS = ("rqm", "qmgeo")


def _check(x: torch.Tensor, w: torch.Tensor, seed, row_offset: int, encode_name: str):
    quantize.check_batch(x, seed, row_offset)
    if w.shape != (x.shape[0],):
        raise ValueError(f"weights must be ({x.shape[0]},), got {tuple(w.shape)}")
    if encode_name not in ENCODERS:
        raise ValueError(f"unknown encoder {encode_name!r}; expected one of {sorted(ENCODERS)}")


def _chunk_sums(x, w, seed, row_offset, params, encode_name):
    """Yield each row chunk's (dim,) int64 weighted level sum."""
    encode = ENCODERS[encode_name][0]
    rows, dim = x.shape
    for start in range(0, rows, BLOCK_ROWS):
        stop = min(start + BLOCK_ROWS, rows)
        counter = quantize.batch_counters(start, stop - start, dim, row_offset, x.device)
        z = encode(x[start:stop], seed, counter, params)
        yield (z.to(torch.int64) * w[start:stop, None].to(torch.int64)).sum(0)


def round_sum_plain(x, w, seed, row_offset: int, params,
                    encode_name: str = "rqm") -> torch.Tensor:
    """Plain version of the dense round sum (``round_sum_jnp``)."""
    _check(x, w, seed, row_offset, encode_name)
    acc = torch.zeros(x.shape[1], dtype=torch.int64, device=x.device)
    for part in _chunk_sums(x, w, seed, row_offset, params, encode_name):
        acc += part
    return wire.to_int32(acc)


def round_sum_packed_plain(x, w, seed, row_offset: int, params, bits: int,
                           encode_name: str = "rqm") -> torch.Tensor:
    """Plain version of the packed round sum (``round_sum_packed_jnp``):
    each chunk's partial sum is packed and the words accumulate."""
    _check(x, w, seed, row_offset, encode_name)
    words = wire.packed_words(x.shape[1], bits)
    acc = torch.zeros(words, dtype=torch.int64, device=x.device)
    for part in _chunk_sums(x, w, seed, row_offset, params, encode_name):
        acc += wire.pack_bits(part, bits, words=words).to(torch.int64)
    return wire.to_int32(acc)


def _check_cuda(x, w):
    check = _build.check_meta if _build.is_meta(x) else _build.check_cuda
    check("x", x, torch.float32)
    check("weights", w, torch.int32)


def _operands(x, w, out, seed) -> tuple:
    return (x, w, out) + ((seed,) if isinstance(seed, torch.Tensor) else ())


def round_sum(x, w, seed, row_offset: int, params,
              encode_name: str = "rqm") -> torch.Tensor:
    """Dense fused round sum: x (rows, dim) float32, w (rows,) int32 ->
    (dim,) int32. CUDA kernel for CUDA tensors, plain version on the CPU,
    the meta branch on the meta device."""
    meta = _build.is_meta(x)
    if not (x.is_cuda or meta):
        return round_sum_plain(x, w, seed, row_offset, params, encode_name)
    _check(x, w, seed, row_offset, encode_name)
    _check_cuda(x, w)
    rows, dim = x.shape
    out = torch.empty(dim, dtype=torch.int32, device=x.device)
    operands = _operands(x, w, out, seed)
    types, values = ENCODERS[encode_name][1](params)
    entry, seed_type, seed = quantize.seed_arg(f"{encode_name}_round_sum_dense", seed)
    if not meta:
        with torch.cuda.device(x.device):
            _build.launch(
                "round_sum", entry, (P, P, P, I32, I32, seed_type, U32) + types + (P,),
                x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, dim,
                seed, int(row_offset), *values, _build.stream_of(x),
            )
    _build.charge(entry, *operands)
    return out


def round_sum_packed(x, w, seed, row_offset: int, params, bits: int,
                     encode_name: str = "rqm") -> torch.Tensor:
    """Packed fused round sum: (rows, dim) float32 -> (ceil(dim / (32 //
    bits)),) int32 words. Any word count; pad coordinates are zero."""
    meta = _build.is_meta(x)
    if not (x.is_cuda or meta):
        return round_sum_packed_plain(x, w, seed, row_offset, params, bits, encode_name)
    _check(x, w, seed, row_offset, encode_name)
    if encode_name not in PACKED_KERNELS:
        raise ValueError(
            f"the packed round-sum kernel takes {PACKED_KERNELS}, not {encode_name!r}: "
            "the PBM mechanism's sum never travels packed")
    _check_cuda(x, w)
    rows, dim = x.shape
    words = wire.packed_words(dim, bits)
    out = torch.empty(words, dtype=torch.int32, device=x.device)
    operands = _operands(x, w, out, seed)
    types, values = ENCODERS[encode_name][1](params)
    entry, seed_type, seed = quantize.seed_arg(f"{encode_name}_round_sum_packed", seed)
    if not meta:
        with torch.cuda.device(x.device):
            _build.launch(
                "round_sum", entry, (P, P, P, I32, I32, I32, I32, seed_type, U32) + types + (P,),
                x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, dim, words,
                int(bits), seed, int(row_offset), *values, _build.stream_of(x),
            )
    _build.charge(entry, *operands)
    return out

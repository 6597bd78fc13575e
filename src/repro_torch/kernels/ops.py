"""Public kernel entry points (counterpart of ``repro/kernels/ops.py``).

Per mechanism (rqm, pbm, qmgeo) two entries, built by one factory each:

  * ``<name>_batch(x, seed, params, *, row_offset=0)``: the materialized
    encode of a (clients, dim) batch, (clients, dim) int32 levels (the
    Pallas ``<name>_quantize_2d``; CUDA ``<name>_quantize``);
  * ``<name>_round_sum(x, seed, params, *, weights, row_offset,
    pack_bits)``: the fused clip -> encode -> weighted cohort sum, equal
    to ``<name>_batch(...)`` weighted and summed over rows, as the dense
    (dim,) int32 sum or its packed words (CUDA ``<name>_round_sum_dense``
    / ``<name>_round_sum_packed``).

Seeds are explicit uint32 values here, as Python ints or as 1-element
int32 device tensors of their bit pattern (``prng.seed_bits``; the kernels'
``_dev`` entries read those from device memory, so a captured round takes
a new seed at each replay); the reference derives them from a JAX key
(``ops.key_to_seed``), which this package does not reimplement.

The wire codec, ``pack_flat(z, bits)`` and ``unpack_flat(words, bits,
n)`` (the Pallas ``pack_flat``/``unpack_flat``; CUDA entries of the same
names), and the folded ``decode_apply`` (``decode_apply_2d``) are
re-exported from their modules.

``launches`` counts each CUDA kernel's launches by its C entry name (the
ones above, their ``_dev`` twins, ``decode_apply_sum`` and
``unpack_decode_apply``); a replayed CUDA graph adds the launches it
captured (``_build.replayed``). CPU tensors run the plain versions and
count nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_round_kernel, pbm_kernel, qmgeo_kernel, rqm_kernel
from repro_torch.kernels._build import launches, reset_launches
from repro_torch.kernels.decode_apply_kernel import decode_apply
from repro_torch.kernels.pack_kernel import pack_flat, unpack_flat

__all__ = ["launches", "reset_launches", "rqm_batch", "pbm_batch", "qmgeo_batch",
           "rqm_round_sum", "pbm_round_sum", "qmgeo_round_sum", "pack_flat",
           "unpack_flat", "decode_apply"]


def _make_batch(name: str, quantize_fn):
    def batch(x: torch.Tensor, seed, params, *, row_offset: int = 0) -> torch.Tensor:
        """Levels of a (clients, dim) batch; the batch plays rows
        ``[row_offset, row_offset + clients)`` of a larger one encoded
        with the same seed."""
        return quantize_fn(x, seed, params, row_offset)

    batch.__name__ = f"{name}_batch"
    return batch


def _make_round_sum(name: str):
    def round_sum(x: torch.Tensor, seed, params, *, weights: torch.Tensor | None = None,
                  row_offset: int = 0, pack_bits: int | None = None) -> torch.Tensor:
        """Fused clip -> encode -> weighted sum over the rows of a
        (rows, dim) cohort batch: the (dim,) int32 sum, or with
        ``pack_bits`` its (ceil(dim / (32 // pack_bits)),) packed words.
        The caller checks that no field overflows (``wire.check_packable``)."""
        if weights is None:
            weights = torch.ones(x.shape[0], dtype=torch.int32, device=x.device)
        if pack_bits is None:
            return fused_round_kernel.round_sum(x, weights, seed, row_offset, params, name)
        return fused_round_kernel.round_sum_packed(x, weights, seed, row_offset, params,
                                                   pack_bits, name)

    round_sum.__name__ = f"{name}_round_sum"
    return round_sum


rqm_batch = _make_batch("rqm", rqm_kernel.rqm_quantize)
pbm_batch = _make_batch("pbm", pbm_kernel.pbm_quantize)
qmgeo_batch = _make_batch("qmgeo", qmgeo_kernel.qmgeo_quantize)

rqm_round_sum = _make_round_sum("rqm")
pbm_round_sum = _make_round_sum("pbm")
qmgeo_round_sum = _make_round_sum("qmgeo")

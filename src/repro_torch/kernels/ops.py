"""Public kernel entry points (counterpart of ``repro/kernels/ops.py``).

``rqm_round_sum`` is the fused-rounds backend of ``RQMMechanism``: it
picks the dense or packed round-sum kernel. Seeds are explicit uint32
values here; the reference derives them from a JAX key
(``ops.key_to_seed``), which this package does not reimplement.

``launches`` counts each CUDA kernel's launches by its C entry name:
``rqm_round_sum_dense``, ``rqm_round_sum_packed``, ``decode_apply_sum``
and ``unpack_decode_apply``. CPU tensors run the plain versions and
count nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core.grid import RQMParams
from repro_torch.kernels import fused_round_kernel
from repro_torch.kernels._build import launches, reset_launches

__all__ = ["launches", "reset_launches", "rqm_round_sum"]


def rqm_round_sum(x: torch.Tensor, seed: int, params: RQMParams, *,
                  weights: torch.Tensor | None = None, row_offset: int = 0,
                  pack_bits: int | None = None) -> torch.Tensor:
    """Fused clip -> RQM encode -> weighted sum over the rows of a
    (rows, dim) cohort batch: the (dim,) int32 sum, or with ``pack_bits``
    its (ceil(dim / (32 // pack_bits)),) packed words. The caller checks
    that no field overflows (``wire.check_packable``)."""
    if x.ndim != 2:
        raise ValueError(f"rqm_round_sum expects (clients, dim), got {tuple(x.shape)}")
    if weights is None:
        weights = torch.ones(x.shape[0], dtype=torch.int32, device=x.device)
    if pack_bits is None:
        return fused_round_kernel.round_sum(x, weights, seed, row_offset, params)
    return fused_round_kernel.round_sum_packed(x, weights, seed, row_offset,
                                               params, pack_bits)

"""Secure-aggregation emulation and the bit-packed collective
(counterpart of ``repro/core/secagg.py``).

SecAgg (Bonawitz et al. 2017) reveals only the modular sum of the
devices' integer messages; the DP analysis needs only that sum, so the
port emulates it with ``torch.distributed.all_reduce(SUM)`` of integer
levels over the client process group: the same communication, minus the
cryptography.

The sum over n clients is bounded by ``mech.sum_bound(n)``, so its
coordinates pack ``k = 32 // sum_bits(bound)`` to an int32 word
(``core/wire.py``) and the collective moves the packed words: 3 fields a
word at the paper's 10-bit sums. int32 addition adds each field on its
own while none overflows (``wire.packable``), so the all_reduce of packed
words is the packed all_reduce: exact, not approximate. Packing and
unpacking run ``kernels/pack_kernel.py``'s ``pack_flat``/``unpack_flat``
(CUDA kernels on the card, the plain codec on the CPU).

``pack_levels``/``unpack_levels`` are the fixed 16-bit (two a word) case,
for callers that need a width safe for any ``bound < 2**16``.
"""
from __future__ import annotations

import torch

from repro_torch.core import wire
from repro_torch.kernels.pack_kernel import pack_flat, unpack_flat
from repro_torch.models.common import all_reduce_

LANE_BITS = 16


def max_clients_for_packing(m: int) -> int:
    """Largest n whose per-lane sum n (m-1) fits 16 bits."""
    return ((1 << LANE_BITS) - 1) // (m - 1)


def pack_levels(z: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A flat int32 level vector packed two to a word, and its length."""
    if z.ndim != 1:
        raise ValueError(f"pack_levels expects flat input, got {tuple(z.shape)}")
    return pack_flat(z, LANE_BITS), z.shape[0]


def unpack_levels(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_levels`` after aggregation: the field sums."""
    return unpack_flat(packed, LANE_BITS, n)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in a new tensor: all_reduce works in
    place, and the caller may still read ``t`` as its own partial."""
    return all_reduce_(t.clone(), group)


def secure_sum(z: torch.Tensor, group, *, packed: bool = False) -> torch.Tensor:
    """SecAgg sum of a flat int32 level vector over ``group``; ``packed``
    moves it two 16-bit fields a word (the caller checks
    ``max_clients_for_packing``)."""
    if not packed:
        return _all_reduce(z, group)
    words, n = pack_levels(z)
    all_reduce_(words, group)
    return unpack_levels(words, n)


def secure_sum_bounded(z: torch.Tensor, group, bound: int, *,
                       packed: bool = True) -> torch.Tensor:
    """``secure_sum`` at the least safe width: ``bound`` (the mechanism's
    ``sum_bound`` over the FULL cross-shard cohort) picks
    ``wire.sum_bits(bound)``-bit fields. A bound that ``wire.packable``
    refuses, the float baseline's bound 0, or ``packed=False`` take the
    plain all_reduce. Either way the sum is the same integer."""
    if packed and wire.packable(bound):
        bits = wire.sum_bits(bound)
        words = pack_flat(z.reshape(-1), bits)
        all_reduce_(words, group)
        return unpack_flat(words, bits, z.numel()).reshape(z.shape)
    return _all_reduce(z, group)


def secagg_modular_sum(messages: torch.Tensor, modulus: int) -> torch.Tensor:
    """Host-level SecAgg emulation: the sum of per-client integer messages
    (n_clients, dim) as uint32, mod ``modulus``. uint32 values are held in
    int64 (the port's convention, ``kernels/prng.py``)."""
    u = messages.to(torch.int64) & 0xFFFFFFFF
    return (u.sum(0) & 0xFFFFFFFF) % int(modulus)

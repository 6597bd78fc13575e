"""Dense b-bit wire codec (counterpart of ``repro/core/wire.py``).

Planar layout: a length-``n`` vector packs into ``W = ceil(n / k)``
int32 words, ``k = 32 // bits``; coordinate ``c`` lives in field
``c // W`` of word ``c % W`` at bit offset ``(c // W) * bits``. The tail
pads with 0. int32 addition of packed words adds each field on its own
while no field overflows, so the packed SecAgg sum equals the packed
dense sum whenever every coordinate's sum fits ``bits`` bits.

``pack_bits``/``unpack_bits`` work on torch tensors on any device (int64
arithmetic, see ``kernels/prng.py``); the ``_np`` twins on numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
MAX_FIELD_BITS = 16


def fields_per_word(bits: int) -> int:
    """``k = 32 // bits``, validating the supported width range."""
    bits = int(bits)
    if not 1 <= bits <= MAX_FIELD_BITS:
        raise ValueError(
            f"packable field width is 1..{MAX_FIELD_BITS} bits, got {bits}"
        )
    return WORD_BITS // bits


def packed_words(n: int, bits: int) -> int:
    """Words needed to carry ``n`` fields of ``bits`` each: ceil(n/k)."""
    k = fields_per_word(bits)
    return -(-int(n) // k)


def sum_bits(bound: int) -> int:
    """Minimal field width holding every value in ``[0, bound]``."""
    bound = int(bound)
    if bound <= 0:
        raise ValueError(
            f"sum_bits needs a positive aggregated-value bound, got {bound}"
        )
    return max(1, bound.bit_length())


def packable(bound: int, bits: int | None = None) -> bool:
    """True when values bounded by ``bound`` pack exactly at ``bits``
    (default: the minimal width) with at least 2 fields per word."""
    bound = int(bound)
    if bound <= 0:
        return False
    if bits is None:
        bits = sum_bits(bound)
    return bits <= MAX_FIELD_BITS and bound < (1 << bits)


def check_packable(bound: int, bits: int | None = None, *,
                   where: str = "") -> int:
    """Return the field width to pack at, or raise when packing at it
    would let a field overflow into its neighbour."""
    bound = int(bound)
    need = bound.bit_length() if bound > 0 else 0
    if bits is None and bound > 0:
        bits = sum_bits(bound)
    if not packable(bound, bits):
        raise ValueError(
            f"{where}bit-packing unsafe for aggregated sum bound {bound}: "
            f"it needs {need} bits but a packed field holds at most "
            f"{MAX_FIELD_BITS} (a field that overflows corrupts its "
            f"neighbor, so field-wise addition would no longer equal the "
            f"unpacked sum). Use wire_packed=False or shrink the cohort "
            f"or the mechanism's level count m."
        )
    return int(bits)


def to_int32(u: torch.Tensor) -> torch.Tensor:
    """Reinterpret uint32 values held in int64 as int32 bit patterns."""
    u = u & 0xFFFFFFFF
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def pack_bits(z: torch.Tensor, bits: int, *, words: int | None = None) -> torch.Tensor:
    """Pack a flat integer vector into ``bits``-wide fields, k per int32
    word. Caller guarantees ``0 <= z < 2**bits``."""
    k = fields_per_word(bits)
    z = z.reshape(-1).to(torch.int64)
    n = z.shape[0]
    w = packed_words(n, bits) if words is None else int(words)
    if k * w < n:
        raise ValueError(f"words={w} cannot hold {n} fields of {bits} bits")
    fields = torch.nn.functional.pad(z, (0, k * w - n)).reshape(k, w)
    shifts = (torch.arange(k, device=z.device, dtype=torch.int64) * bits)[:, None]
    return to_int32((fields << shifts).sum(0))


def unpack_bits(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: the ``n`` leading fields as int32."""
    k = fields_per_word(bits)
    w = words.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    shifts = (torch.arange(k, device=w.device, dtype=torch.int64) * bits)[:, None]
    fields = (w[None, :] >> shifts) & ((1 << bits) - 1)
    return fields.reshape(-1)[:n].to(torch.int32)


def pack_bits_np(z: np.ndarray, bits: int, *, words: int | None = None) -> np.ndarray:
    """numpy twin of ``pack_bits`` (identical layout and output)."""
    k = fields_per_word(bits)
    z = np.asarray(z).reshape(-1).astype(np.uint32)
    n = z.shape[0]
    w = packed_words(n, bits) if words is None else int(words)
    if k * w < n:
        raise ValueError(f"words={w} cannot hold {n} fields of {bits} bits")
    fields = np.pad(z, (0, k * w - n)).reshape(k, w)
    shifts = (np.arange(k, dtype=np.uint32) * np.uint32(bits))[:, None]
    return (fields << shifts).sum(axis=0, dtype=np.uint32).view(np.int32)


def unpack_bits_np(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    """numpy twin of ``unpack_bits``."""
    k = fields_per_word(bits)
    w = np.asarray(words).reshape(-1).astype(np.int32).view(np.uint32)
    mask = np.uint32((1 << bits) - 1)
    shifts = (np.arange(k, dtype=np.uint32) * np.uint32(bits))[:, None]
    fields = (w[None, :] >> shifts) & mask
    return fields.reshape(-1)[:n].astype(np.int32)

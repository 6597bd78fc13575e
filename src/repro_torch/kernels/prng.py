"""Counter-based splitmix32, the generator every RQM kernel draws from.

Counterpart of ``repro/kernels/prng.py``, bit for bit: the draw for
element ``counter`` on ``stream`` is

    mix32(seed + stream * 0xBF58476D + counter * 0x9E3779B9)   (mod 2**32)

and its uniform is ``(bits >> 8) * 2**-24`` in float32. The CUDA kernels
use the same formula from ``csrc/prng.cuh``.

PyTorch cannot shift or add ``torch.uint32`` on the CPU, so the plain
version keeps every uint32 value in an int64 tensor in ``[0, 2**32)``
and masks after each add. Multiplies are split into 16-bit halves so no
int64 product overflows.

A seed is a Python int in ``[0, 2**32)`` or, where it must stay on the
device (a round replayed from a CUDA graph reads its seed from a buffer),
a 1-element int32 tensor holding the uint32's bit pattern
(``seed_bits``). Both give the same draws.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # splitmix increment
STREAM_SALT = 0xBF58476D
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
UNIFORM_SCALE = 1.0 / (1 << 24)


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 ``a`` in ``[0, 2**32)`` and a uint32
    constant ``b``, with every intermediate below ``2**49``."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def mix32(z: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer (murmur3-style avalanche)."""
    z = z & MASK32
    z = mul32(z ^ (z >> 16), _M1)
    z = mul32(z ^ (z >> 13), _M2)
    return z ^ (z >> 16)


def seed_bits(seed: int) -> int:
    """The int32 bit pattern of a uint32 seed, as a device seed tensor
    holds it; raises unless ``0 <= seed < 2**32``."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must be a uint32, got {seed}")
    return seed - (1 << 32) if seed >> 31 else seed


def seed_value(seed):
    """A seed as the uint32 the draws add: the int itself, or a 0-d int64
    tensor in ``[0, 2**32)`` read on the tensor's device (no copy to the
    host)."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & MASK32
    return int(seed)


def random_bits(seed, counter: torch.Tensor, stream: int) -> torch.Tensor:
    """uint32 random bits (held in int64) for (seed, counter, stream)."""
    s = (seed_value(seed) + ((int(stream) * STREAM_SALT) & MASK32)) & MASK32
    return mix32(s + mul32(counter.to(torch.int64) & MASK32, GOLDEN))


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniforms in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * UNIFORM_SCALE


def random_uniform(seed, counter: torch.Tensor, stream: int) -> torch.Tensor:
    return uniform01(random_bits(seed, counter, stream))

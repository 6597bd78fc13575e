"""The dense b-bit wire codec as kernels (counterpart of
``repro/kernels/pack_kernel.py``), planar layout of ``core/wire.py``:

  * ``pack_flat(z, bits)``: (n,) int32 levels -> (W,) packed words;
  * ``unpack_flat(words, bits, n)``: (W,) words -> the (n,) fields;
  * ``unpack_decode_apply``: the packed server boundary, unpack ->
    decode -> SGD apply in one pass: coordinate i's level sum is field
    ``i // W`` of word ``i % W``, decoded and applied with the float
    association of ``decode_apply_kernel``, so the dense (dim,) sum never
    exists.

Unlike the TPU kernels these take any word count W (the paper's EMNIST
round has W = 74,010, which is not a multiple of 128). CUDA kernels in
``csrc/pack.cu`` and ``csrc/decode_apply.cu``; on a CPU tensor each
entry runs its plain version (``wire.pack_bits``/``unpack_bits`` for the
codec).

The codec kernels and ``unpack_decode_apply`` walk the words in V-groups
(``codec_walk``, which the C entries mirror; ``csrc/walk.cuh``): group j
is words ``[j*V, j*V + V)`` and, for each field f, the coordinates
``[f*W + j*V, f*W + j*V + V)``; a thread walks GROUPS groups, THREADS
apart.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import wire
from repro_torch.core.grid import GridGeometry
from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, P
from repro_torch.kernels.decode_apply_kernel import (
    check_apply_args,
    count_constants,
    decode_apply_plain,
    f32_decode_constants,
)

_ARGS = (P, P, P, I32, I32, I32, F32, F32, F32, P)
_DEV_ARGS = (P, P, P, I32, I32, I32, P, F32, F32, I32, F32, P)
_CODEC_ARGS = (P, P, I32, I32, I32, P)
THREADS = 256  # a block of the walk's kernels (csrc/walk.cuh: kWalkThreads)
GROUPS = 2  # V-groups a thread walks (csrc/walk.cuh: kWalkGroups)
INT_MAX = (1 << 31) - 1


def codec_walk(n: int, n_words: int, bits: int, addrs) -> tuple[int, int]:
    """The walk of the codec kernels and ``unpack_decode_apply`` over
    ``n`` fields of ``bits`` in ``n_words`` words, between operands at the
    byte addresses ``addrs``: ``(V, blocks)``. V is 2 where 2 words divide
    ``n_words``, ``n`` and every address, else 1, so each access is one
    aligned V-wide load or store and a V-group of a field lies wholly
    below ``n`` or at or past it; ``blocks`` of THREADS threads, GROUPS
    groups a thread, cover the ``n_words / V`` groups. Field indices
    ``f * n_words + w`` must fit an int32 (``k * n_words <= INT_MAX``)."""
    k = wire.fields_per_word(bits)
    if n < 1 or n_words < 1 or k * n_words > INT_MAX:
        raise ValueError(f"{n} fields in {n_words} words of {k} fields: the walk needs "
                         f"n, n_words >= 1 and k * n_words <= {INT_MAX}")
    v = 2 if n_words % 2 == 0 and n % 2 == 0 and all(a % 8 == 0 for a in addrs) else 1
    return v, -(-(n_words // v) // (THREADS * GROUPS))


def built_walk(n: int, n_words: int, bits: int, addrs) -> tuple[int, int]:
    """The walk the built C entries take, which must equal ``codec_walk``'s:
    the codec's for its two operands (``codec_walk`` in ``csrc/pack.cu``),
    ``unpack_decode_apply``'s for its three, ``w``, the words and the
    output (``unpack_decode_walk`` in ``csrc/decode_apply.cu``). Needs
    nvcc."""
    v, blocks = ctypes.c_int(), ctypes.c_int()
    lib, entry = ("pack", "codec_walk") if len(addrs) == 2 else \
        ("decode_apply", "unpack_decode_walk")
    _build.call(lib, entry, (I32, I32, I32) + (P,) * (len(addrs) + 2), n, n_words,
                int(bits), *addrs, ctypes.addressof(v), ctypes.addressof(blocks))
    return v.value, blocks.value


def pack_flat_plain(z: torch.Tensor, bits: int) -> torch.Tensor:
    return wire.pack_bits(z, bits)


def unpack_flat_plain(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    return wire.unpack_bits(words, bits, n)


def pack_flat(z: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack a flat int32 level vector into ``bits``-wide fields, 32 // bits
    per int32 word: (ceil(n / k),) words. Caller guarantees
    ``0 <= z < 2**bits``."""
    if z.ndim != 1 or z.numel() < 1:
        raise ValueError(f"z must be a non-empty flat vector, got {tuple(z.shape)}")
    n_words = wire.packed_words(z.numel(), bits)
    if not z.is_cuda:
        return pack_flat_plain(z, bits)
    _build.check_cuda("z", z, torch.int32)
    words = torch.empty(n_words, dtype=torch.int32, device=z.device)
    with torch.cuda.device(z.device):
        _build.launch("pack", "pack_flat", _CODEC_ARGS, z.data_ptr(), words.data_ptr(),
                      z.numel(), n_words, int(bits), _build.stream_of(z))
    return words


def unpack_flat(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """The ``n`` leading fields of packed words, as (n,) int32."""
    k = wire.fields_per_word(bits)
    if words.ndim != 1 or n < 1 or k * words.numel() < n:
        raise ValueError(f"{n} fields at {bits} bits do not fit words of shape "
                         f"{tuple(words.shape)}")
    if not words.is_cuda:
        return unpack_flat_plain(words, bits, n)
    _build.check_cuda("words", words, torch.int32)
    z = torch.empty(n, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        _build.launch("pack", "unpack_flat", _CODEC_ARGS, words.data_ptr(), z.data_ptr(),
                      n, words.numel(), int(bits), _build.stream_of(words))
    return z


def unpack_decode_apply_plain(w, words, params: GridGeometry, n, lr: float,
                              *, pack_bits: int) -> torch.Tensor:
    """Plain version: unpack the words, then the dense decode + apply (at
    a device count ``n``, the ``_dev`` entry's)."""
    z = wire.unpack_bits(words, pack_bits, w.numel())
    return decode_apply_plain(w, z, params, n, lr)


def unpack_decode_apply(w: torch.Tensor, words: torch.Tensor, params: GridGeometry,
                        n, lr: float, *, pack_bits: int) -> torch.Tensor:
    """Updated (dim,) float32 params from the packed (W,) int32 sum, at
    the cohort size ``n``: an int, or a 1-element int32 device count (the
    ``unpack_decode_apply_dev`` entry; ``w`` itself at a count of 0)."""
    check_apply_args(w, n)
    n_words = wire.packed_words(w.numel(), pack_bits)
    if words.shape != (n_words,):
        raise ValueError(
            f"{w.numel()} fields at {pack_bits} bits need ({n_words},) words, "
            f"got {tuple(words.shape)}"
        )
    if not w.is_cuda:
        return unpack_decode_apply_plain(w, words, params, n, lr, pack_bits=pack_bits)
    _build.check_cuda("w", w, torch.float32)
    _build.check_cuda("words", words, torch.int32)
    out = torch.empty_like(w)
    if isinstance(n, torch.Tensor):
        with torch.cuda.device(w.device):
            _build.launch(
                "decode_apply", "unpack_decode_apply_dev", _DEV_ARGS,
                w.data_ptr(), words.data_ptr(), out.data_ptr(), w.numel(), n_words,
                int(pack_bits), n.data_ptr(), *count_constants(params, lr),
                _build.stream_of(w),
            )
        return out
    k = f32_decode_constants(params, n, lr)
    with torch.cuda.device(w.device):
        _build.launch(
            "decode_apply", "unpack_decode_apply", _ARGS,
            w.data_ptr(), words.data_ptr(), out.data_ptr(), w.numel(), n_words,
            int(pack_bits), k["neg_x_max"], k["scale"], k["lr"],
            _build.stream_of(w),
        )
    return out

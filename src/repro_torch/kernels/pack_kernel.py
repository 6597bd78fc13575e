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
"""
from __future__ import annotations

import torch

from repro_torch.core import wire
from repro_torch.core.grid import GridGeometry
from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, P
from repro_torch.kernels.decode_apply_kernel import (
    check_apply_args,
    decode_apply_plain,
    f32_decode_constants,
)

_ARGS = (P, P, P, I32, I32, I32, F32, F32, F32, P)
_CODEC_ARGS = (P, P, I32, I32, I32, P)


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


def unpack_decode_apply_plain(w, words, params: GridGeometry, n: int, lr: float,
                              *, pack_bits: int) -> torch.Tensor:
    """Plain version: unpack the words, then the dense decode + apply."""
    z = wire.unpack_bits(words, pack_bits, w.numel())
    return decode_apply_plain(w, z, params, n, lr)


def unpack_decode_apply(w: torch.Tensor, words: torch.Tensor, params: GridGeometry,
                        n: int, lr: float, *, pack_bits: int) -> torch.Tensor:
    """Updated (dim,) float32 params from the packed (W,) int32 sum."""
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
    k = f32_decode_constants(params, n, lr)
    with torch.cuda.device(w.device):
        _build.launch(
            "decode_apply", "unpack_decode_apply", _ARGS,
            w.data_ptr(), words.data_ptr(), out.data_ptr(), w.numel(), n_words,
            int(pack_bits), k["neg_x_max"], k["scale"], k["lr"],
            _build.stream_of(w),
        )
    return out

"""Packed server boundary: unpack -> decode -> SGD apply in one pass.

Counterpart of ``repro/kernels/pack_kernel.py:unpack_decode_apply``:
coordinate i's level sum is field ``i // W`` of word ``i % W``, read
with a logical shift and a mask, then decoded and applied with the float
association of ``decode_apply_kernel``. The dense (dim,) sum never
exists. Unlike the TPU kernel this takes any word count W (the paper's
EMNIST round has W = 74,010, which is not a multiple of 128). CUDA
kernel in ``csrc/decode_apply.cu``; plain version on the CPU.
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

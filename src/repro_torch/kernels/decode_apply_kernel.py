"""Fused server decode + SGD apply on the dense SecAgg sum, two forms
(counterparts of ``repro/kernels/decode_apply_kernel.py``):

  * ``decode_apply_sum`` (its Pallas kernel ``_sum_kernel``)::

        g = -x_max + z * scale;   w' = w - lr * g,   scale = 2 x_max / (n (m-1))

    the literal operations of ``grid.decode_sum`` followed by SGD, so it
    is bit-identical to them: the fused rounds run it;
  * ``decode_apply`` (``decode_apply_2d``): the folded
    ``w' = w - (shift + scale_lr * z)``, lr folded into the two scalars.
    Another float association, so no round runs it; it is the
    reference's standalone entry, for float32 or bfloat16 ``w``.

Every scalar is the reference's Python double rounded once to float32.
The cohort size ``n`` of ``decode_apply_sum`` (and of ``pack_kernel``'s
``unpack_decode_apply``) is an int, or a 1-element int32 device tensor,
the realized size of a heterogeneous cohort: that launches the ``_dev``
entry, which reads it from device memory and computes the scale as the
reference does at a traced n, ``f32(2 x_max) / f32(n (m-1))``, and at
n = 0 returns ``w`` unchanged (an empty round moves nothing). CUDA kernels
in ``csrc/decode_apply.cu`` for CUDA tensors; plain versions on the CPU. ``folded_walk`` mirrors the C entry ``decode_apply_walk``:
the width and grid of ``decode_apply``'s kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import grid
from repro_torch.core.grid import GridGeometry, decode_scale
from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, P

_ARGS = (P, P, P, I32, F32, F32, F32, P)
_FOLDED_ARGS = (P, P, P, I32, I32, F32, F32, P)
_DEV_ARGS = (P, P, P, I32, P, F32, F32, I32, F32, P)
THREADS = 256  # a block (csrc/walk.cuh: kWalkThreads)
FOLDED_GROUPS = 4  # V-groups a thread of decode_apply (csrc/decode_apply.cu: kFoldedGroups)
INT_MAX = (1 << 31) - 1


def folded_walk(n: int, bf16: bool, addrs) -> tuple[int, int]:
    """The walk of ``decode_apply``'s kernel over ``n`` coordinates between
    ``w``, the int32 sum and the output at the byte addresses ``addrs``:
    ``(V, blocks)``. V is 2 where n is even, ``w`` and the output are
    aligned to two parameters (float32, or bfloat16 where ``bf16``) and the
    sum to two ints, else 1; ``blocks`` of THREADS threads, FOLDED_GROUPS
    V-groups a thread, cover the ``n / V`` groups. The last coordinate of a
    block of V = 2 must fit an int32."""
    if n < 1 or n > INT_MAX - THREADS * FOLDED_GROUPS * 2:
        raise ValueError(f"decode_apply takes 1 to {INT_MAX - THREADS * FOLDED_GROUPS * 2} "
                         f"coordinates, got {n}")
    w, z, out = addrs
    pair = 4 if bf16 else 8
    v = 2 if n % 2 == 0 and w % pair == 0 and out % pair == 0 and z % 8 == 0 else 1
    return v, -(-(n // v) // (THREADS * FOLDED_GROUPS))


def built_folded_walk(n: int, bf16: bool, addrs) -> tuple[int, int]:
    """The walk the built C entry ``decode_apply_walk`` takes, which must
    equal ``folded_walk``'s. Needs nvcc."""
    v, blocks = ctypes.c_int(), ctypes.c_int()
    _build.call("decode_apply", "decode_apply_walk", (I32, I32, P, P, P, P, P), n, int(bf16),
                *addrs, ctypes.addressof(v), ctypes.addressof(blocks))
    return v.value, blocks.value


def f32_decode_constants(params: GridGeometry, n: int, lr: float) -> dict:
    return {
        "neg_x_max": float(np.float32(-params.x_max)),
        "scale": float(np.float32(decode_scale(n, params))),
        "lr": float(np.float32(lr)),
    }


def count_constants(params: GridGeometry, lr: float) -> tuple:
    """The scalars of a ``_dev`` entry after the count's pointer:
    (-x_max, 2 x_max, each rounded once to float32; m - 1; lr in float32)."""
    return (float(np.float32(-params.x_max)), float(np.float32(2.0 * params.x_max)),
            params.m - 1, float(np.float32(lr)))


def decode_apply_plain(w: torch.Tensor, z: torch.Tensor, params: GridGeometry,
                       n, lr: float) -> torch.Tensor:
    """Plain version: the elementwise expression on (dim,) ``w`` and an
    int32 level sum ``z`` of the same length; at a device count ``n``, the
    plain version of the ``_dev`` entries (``w`` where the count is 0)."""
    if isinstance(n, torch.Tensor):
        count = n.reshape(())
        g = grid.decode_sum(z, count.clamp(min=1), params)
        return torch.where(count > 0, w - float(np.float32(lr)) * g, w)
    k = f32_decode_constants(params, n, lr)
    g = k["neg_x_max"] + z.to(torch.float32) * k["scale"]
    return w - k["lr"] * g


def check_apply_args(w: torch.Tensor, n):
    """``w`` a non-empty flat vector; ``n`` a positive int or a 1-element
    int32 count on ``w``'s device (any value >= 0)."""
    if w.ndim != 1 or w.numel() < 1:
        raise ValueError(f"w must be a non-empty flat vector, got {tuple(w.shape)}")
    if isinstance(n, torch.Tensor):
        if n.numel() != 1 or n.dtype != torch.int32 or n.device != w.device:
            raise ValueError(f"a device count must be 1 int32 element on {w.device}, got "
                             f"{tuple(n.shape)} {n.dtype} on {n.device}")
    elif not isinstance(n, int) or n < 1:
        raise ValueError(f"cohort size n must be a positive int, got {n!r}")


def decode_apply_sum(w: torch.Tensor, z_sum: torch.Tensor, params: GridGeometry,
                     n, lr: float) -> torch.Tensor:
    """Updated (dim,) float32 params from the dense (dim,) int32 sum, at
    the cohort size ``n`` (an int, or a device count: the ``_dev`` entry)."""
    check_apply_args(w, n)
    if z_sum.shape != w.shape:
        raise ValueError(f"z_sum must be {tuple(w.shape)}, got {tuple(z_sum.shape)}")
    if not w.is_cuda:
        return decode_apply_plain(w, z_sum, params, n, lr)
    _build.check_cuda("w", w, torch.float32)
    _build.check_cuda("z_sum", z_sum, torch.int32)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        if isinstance(n, torch.Tensor):
            _build.launch(
                "decode_apply", "decode_apply_sum_dev", _DEV_ARGS,
                w.data_ptr(), z_sum.data_ptr(), out.data_ptr(), w.numel(), n.data_ptr(),
                *count_constants(params, lr), _build.stream_of(w),
            )
            return out
        k = f32_decode_constants(params, n, lr)
        _build.launch(
            "decode_apply", "decode_apply_sum", _ARGS,
            w.data_ptr(), z_sum.data_ptr(), out.data_ptr(), w.numel(),
            k["neg_x_max"], k["scale"], k["lr"], _build.stream_of(w),
        )
    return out


def folded_constants(params: GridGeometry, n: int, lr: float) -> tuple[float, float]:
    """(shift, scale) of the folded form: the reference's Python doubles
    ``-lr x_max`` and ``lr 2 x_max / (n (m-1))``, each rounded once to
    float32 (as XLA does with the weakly typed scalars)."""
    scale = lr * 2.0 * params.x_max / (n * (params.m - 1))
    shift = -lr * params.x_max
    return float(np.float32(shift)), float(np.float32(scale))


def decode_apply_ref(w: torch.Tensor, z_sum: torch.Tensor, params: GridGeometry,
                     n: int, lr: float) -> torch.Tensor:
    """Plain version of ``decode_apply``: in float32, rounded once to
    ``w``'s dtype."""
    shift, scale = folded_constants(params, n, lr)
    step = shift + z_sum.to(torch.float32) * scale
    return (w.to(torch.float32) - step).to(w.dtype)


def decode_apply(w: torch.Tensor, z_sum: torch.Tensor, params: GridGeometry,
                 n: int, lr: float) -> torch.Tensor:
    """Updated float32 or bfloat16 params ``w - (shift + scale * z_sum)``
    of any shape, from an int32 sum of the same shape. The kernel refuses
    (and this raises on) more than ``INT_MAX - 2048`` elements."""
    if w.numel() < 1 or z_sum.shape != w.shape:
        raise ValueError(f"w and z_sum must be non-empty and of one shape, got "
                         f"{tuple(w.shape)} and {tuple(z_sum.shape)}")
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"cohort size n must be a positive int, got {n!r}")
    if not w.is_cuda:
        return decode_apply_ref(w, z_sum, params, n, lr)
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w must be float32 or bfloat16, got {w.dtype}")
    _build.check_cuda("w", w, w.dtype)
    _build.check_cuda("z_sum", z_sum, torch.int32)
    out = torch.empty_like(w)
    shift, scale = folded_constants(params, n, lr)
    with torch.cuda.device(w.device):
        _build.launch(
            "decode_apply", "decode_apply", _FOLDED_ARGS,
            w.data_ptr(), z_sum.data_ptr(), out.data_ptr(), w.numel(),
            int(w.dtype == torch.bfloat16), shift, scale, _build.stream_of(w),
        )
    return out

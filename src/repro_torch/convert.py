"""Carry parameters between the two packages.

The flat parameter vector follows ``jax.flatten_util.ravel_pytree`` of
the reference's params dict: keys in sorted order (for the CNN ``b1, b2,
conv1, conv2, dense1, dense2``), each leaf flattened row-major in its
own layout. Flat coordinate ``c``, and so the RNG counter
``row * dim + c`` of the round kernels, then means the same weight in
both packages.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def params_from_numpy(arrays: dict, device="cuda") -> dict:
    """A params dict of numpy arrays (e.g. ``jax.device_get`` of the
    reference's params) -> float32 tensors on ``device`` (the card unless
    the caller asks for the CPU, as ``FedTrainer`` does)."""
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
            for k, v in arrays.items()}


def ravel(params: dict) -> tuple[torch.Tensor, "Unravel"]:
    """Flatten a params dict in ravel_pytree order; returns the flat
    vector and the inverse map."""
    keys = sorted(params)
    flat = torch.cat([params[k].reshape(-1) for k in keys])
    return flat, Unravel(tuple((k, tuple(params[k].shape)) for k in keys))


class Unravel:
    """flat vector -> params dict of views, for a fixed key/shape layout."""

    def __init__(self, layout):
        self.layout = layout
        self.size = sum(math.prod(shape) for _, shape in layout)

    def __call__(self, flat: torch.Tensor) -> dict:
        if flat.shape != (self.size,):
            raise ValueError(f"flat vector must be ({self.size},), got {tuple(flat.shape)}")
        out, start = {}, 0
        for key, shape in self.layout:
            n = math.prod(shape)
            out[key] = flat[start:start + n].reshape(shape)
            start += n
        return out

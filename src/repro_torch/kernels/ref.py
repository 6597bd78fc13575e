"""Plain-torch oracles for the encode kernels (counterpart of
``repro/kernels/ref.py``).

Each draws the splitmix32 uniforms a kernel draws for the flat counters
0..n-1 (``kernels/prng.py``) and routes them through the mechanism-level
deterministic core (``core/rqm.py``, ``core/pbm.py``, ``core/qmgeo.py``
``quantize_with_uniforms``): a kernel that equals its oracle equals
Algorithm 2, not merely a copy of itself.
"""
from __future__ import annotations

import torch

from repro_torch.core import pbm, qmgeo, rqm
from repro_torch.core.grid import RQMParams
from repro_torch.core.pbm import PBMParams
from repro_torch.core.qmgeo import QMGeoParams
from repro_torch.kernels.prng import random_uniform


def _counters(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _check_flat(name: str, x: torch.Tensor) -> None:
    if x.ndim != 1:
        raise ValueError(f"{name} expects flat input, got {tuple(x.shape)}")


def rqm_uniforms(n: int, seed, params: RQMParams, device="cuda"):
    """The kernel's uniforms for a flat input of n elements: (n, m) level
    keep draws (streams 1..m-2 for the interior; the endpoints' slots are
    ones, never below q, and unused) and (n,) rounding draws (stream m)."""
    cnt = _counters(n, device)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    cols = [random_uniform(seed, cnt, lvl) if 0 < lvl < params.m - 1 else ones
            for lvl in range(params.m)]
    return torch.stack(cols, dim=-1), random_uniform(seed, cnt, params.m)


def rqm_ref(x_flat: torch.Tensor, seed, params: RQMParams) -> torch.Tensor:
    """Flat float input -> int32 levels, bit-identical to the kernel."""
    _check_flat("rqm_ref", x_flat)
    u_levels, u_round = rqm_uniforms(x_flat.shape[0], seed, params, x_flat.device)
    return rqm.quantize_with_uniforms(x_flat, u_levels, u_round, params)


def qmgeo_ref(x_flat: torch.Tensor, seed, params: QMGeoParams) -> torch.Tensor:
    """The kernel's two streams (0 rounding, 1 the noise's inverse CDF)
    through the mechanism-level core."""
    _check_flat("qmgeo_ref", x_flat)
    cnt = _counters(x_flat.shape[0], x_flat.device)
    return qmgeo.quantize_with_uniforms(x_flat, random_uniform(seed, cnt, 0),
                                        random_uniform(seed, cnt, 1), params)


def pbm_ref(x_flat: torch.Tensor, seed, params: PBMParams) -> torch.Tensor:
    """Trial t draws stream t; the m trials' uniforms through the core."""
    _check_flat("pbm_ref", x_flat)
    cnt = _counters(x_flat.shape[0], x_flat.device)
    u = torch.stack([random_uniform(seed, cnt, trial) for trial in range(params.m)])
    return pbm.quantize_with_uniforms(x_flat, u, params)

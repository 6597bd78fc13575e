"""RQM (the paper's Algorithm 2) on counter-based splitmix32 draws, a
frozen plain copy of the generator and of the encode arithmetic.

The draw of element ``counter`` on ``stream`` is

    mix32(seed + stream * 0xBF58476D + counter * 0x9E3779B9)   (mod 2**32)

and its uniform ``(bits >> 8) * 2**-24``. Interior level ``l`` (streams
1..m-2) is kept iff its uniform is below float32(q); the end levels are
always kept. With x clipped to [-c, c] and its bin ``j = floor((x + x_max)
/ step)`` in [0, m-2], the nearest kept levels are ``i_lo <= j < i_hi``,
and x rounds up to ``i_hi`` iff the stream-m uniform is below ``(x -
B(i_lo)) / (B(i_hi) - B(i_lo))``, all in float32 with each double rounded
once. uint32 values live in int64 tensors; products are split into 16-bit
halves so that none overflows.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
STREAM_SALT = 0xBF58476D
M1, M2 = 0x85EBCA6B, 0xC2B2AE35
CHUNK = 1 << 24  # elements encoded at a time


@dataclasses.dataclass(frozen=True)
class RQM:
    c: float
    delta: float
    m: int
    q: float

    @classmethod
    def from_spec(cls, spec: dict) -> "RQM":
        c = float(spec["c"])
        return cls(c=c, delta=float(spec.get("delta", c)), m=int(spec["m"]), q=float(spec["q"]))

    @property
    def x_max(self) -> float:
        return self.c + self.delta

    @property
    def step(self) -> float:
        return 2.0 * self.x_max / (self.m - 1)


def f32(v: float) -> float:
    return float(np.float32(v))


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def mix32(z: torch.Tensor) -> torch.Tensor:
    z = mul32(z ^ (z >> 16), M1)
    z = mul32(z ^ (z >> 13), M2)
    return z ^ (z >> 16)


def uniform(seed: int, spread: torch.Tensor, stream: int) -> torch.Tensor:
    """float32 uniforms in [0, 1) of (seed, counter, stream), given
    ``spread = counter * GOLDEN mod 2**32``."""
    s = (int(seed) + stream * STREAM_SALT) & MASK32
    bits = mix32((s + spread) & MASK32)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _encode(x: torch.Tensor, seed: int, counter: torch.Tensor, p: RQM) -> torch.Tensor:
    dev = x.device
    step = torch.tensor(f32(p.step), dtype=torch.float32, device=dev)
    x = x.to(torch.float32).clamp(-f32(p.c), f32(p.c))
    j = torch.floor((x + f32(p.x_max)) / step).clamp(0, p.m - 2).to(torch.int64)
    i_lo = torch.zeros_like(j)
    i_hi = torch.full_like(j, p.m - 1)
    q = f32(p.q)
    spread = mul32(counter, GOLDEN)
    for lvl in range(1, p.m - 1):
        kept = uniform(seed, spread, lvl) < q
        i_lo = torch.where(kept & (lvl <= j), lvl, i_lo)  # levels ascend: the last is the max
        i_hi = torch.where(kept & (lvl > j) & (i_hi == p.m - 1), lvl, i_hi)  # the first above j
    b_lo = -f32(p.x_max) + i_lo.to(torch.float32) * f32(p.step)
    b_hi = -f32(p.x_max) + i_hi.to(torch.float32) * f32(p.step)
    p_up = (x - b_lo) / (b_hi - b_lo)
    return torch.where(uniform(seed, spread, p.m) < p_up, i_hi, i_lo).to(torch.int32)


def encode_rows(x: torch.Tensor, seed: int, p: RQM, rows=None) -> torch.Tensor:
    """int32 levels of a (n, dim) batch; element (r, c) draws counter
    ``rows[r] * dim + c`` mod 2**32 (``rows``: the slate rows the batch's
    rows stand in, by default 0..n-1)."""
    n, dim = x.shape
    rows_t = torch.as_tensor(list(range(n)) if rows is None else list(rows), dtype=torch.int64,
                             device=x.device)
    out = torch.empty((n, dim), dtype=torch.int32, device=x.device)
    flat_x, flat_out = x.reshape(-1), out.view(-1)
    for lo in range(0, n * dim, CHUNK):
        hi = min(lo + CHUNK, n * dim)
        at = torch.arange(lo, hi, dtype=torch.int64, device=x.device)
        counter = (rows_t[at // dim] * dim + at % dim) & MASK32
        flat_out[lo:hi] = _encode(flat_x[lo:hi], seed, counter, p)
    return out


def scale(n: int, p: RQM, device_count: bool = False) -> float:
    """2 x_max / (n (m-1)) in float32: a double rounded once for a fixed
    cohort; ``device_count``: ``f32(2 x_max) / f32(n (m-1))``, the float32
    division a realized count is decoded with."""
    if device_count:
        return float(np.float32(f32(2.0 * p.x_max)) / np.float32(n * (p.m - 1)))
    return f32(2.0 * p.x_max / (n * (p.m - 1)))


def decode(z_sum: torch.Tensor, n: int, p: RQM, device_count: bool = False) -> torch.Tensor:
    """g_hat = -x_max + z_sum * scale."""
    s = torch.tensor(scale(n, p, device_count), dtype=torch.float32, device=z_sum.device)
    return -f32(p.x_max) + z_sum.to(torch.float32) * s


def levels_of(g_hat: torch.Tensor, n: int, p: RQM, device_count: bool = False) -> torch.Tensor:
    """The integer sums a decoded update came from (the inverse of
    ``decode``; exact while the update lies within float32 rounding of a
    grid value)."""
    s = torch.tensor(scale(n, p, device_count), dtype=torch.float32, device=g_hat.device)
    return torch.round((g_hat + f32(p.x_max)) / s).to(torch.int64)

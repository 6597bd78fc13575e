"""Generalized RQM with PER-LEVEL keep probabilities q_1..q_{m-2}
(counterpart of ``repro/core/rqm_general.py``): the extension the paper
proposes in its Discussion ("assigning unique probability values q_i to
each i-th discrete level presents an intriguing avenue for further
enhancing the privacy-accuracy trade-off").

Mechanism: identical to Algorithm 2 except interior level i is kept with its
own probability q[i]. The outcome distribution generalizes Lemma 5.1: for
x in [B(j), B(j+1)) and a kept bracket (a, b) with a <= j < b,

  Pr(bracket = (a,b)) = keep(a) * keep(b) * prod_{l in (a,b) interior} (1 - q_l)

with keep(0) = keep(m-1) = 1 and keep(i) = q_i for interior i; randomized
rounding splits the bracket mass as in the paper. ``outcome_distribution``
evaluates this exactly in O(m^2); ``optimize_q`` runs a projected
coordinate search minimizing the worst-case aggregate Renyi epsilon at a
fixed unbiased-variance budget. These are float64 numpy, as the
reference's.

The sampler is split in two. ``select_levels`` is the deterministic part
on given uniforms, the reference's arithmetic op by op in float32;
``quantize`` draws those uniforms from an explicit ``torch.Generator``
(seeds, not keys: the reference's ``jax.random`` stream is not
reimplemented).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.distribution import aggregate_distribution
from repro_torch.core.grid import RQMParams
from repro_torch.core.renyi import renyi_divergence, worst_case_inputs


@dataclasses.dataclass(frozen=True)
class GeneralRQMParams:
    c: float
    delta: float
    m: int
    q: tuple  # length m-2, keep prob of each interior level

    def __post_init__(self):
        if len(self.q) != self.m - 2:
            raise ValueError(f"need {self.m - 2} interior probabilities")
        if not all(0.0 < float(v) < 1.0 for v in self.q):
            raise ValueError("q_i must be in (0,1)")

    @property
    def x_max(self):
        return self.c + self.delta

    def levels(self) -> np.ndarray:
        i = np.arange(self.m, dtype=np.float64)
        return -self.x_max + 2.0 * i * self.x_max / (self.m - 1)

    @classmethod
    def from_scalar(cls, p: RQMParams):
        return cls(c=p.c, delta=p.delta, m=p.m, q=tuple([p.q] * (p.m - 2)))


def outcome_distribution(x: float, p: GeneralRQMParams) -> np.ndarray:
    """Exact pmf over the m levels (generalized Lemma 5.1), O(m^2)."""
    m = p.m
    B = p.levels()
    x = float(np.clip(x, -p.c, p.c))
    j = int(np.clip(np.floor((x - B[0]) / (B[1] - B[0])), 0, m - 2))
    keep = np.ones(m)
    keep[1:m - 1] = np.asarray(p.q, dtype=np.float64)
    drop = 1.0 - keep  # drop[0] = drop[m-1] = 0

    pmf = np.zeros(m)
    for a in range(0, j + 1):
        for b in range(j + 1, m):
            # levels strictly inside (a, b) are interior grid levels and
            # must all be dropped for (a, b) to be the rounding bracket
            prob = keep[a] * keep[b] * np.prod(drop[a + 1:b]) if b > a + 1 \
                else keep[a] * keep[b]
            up = (x - B[a]) / (B[b] - B[a])
            pmf[b] += prob * up
            pmf[a] += prob * (1.0 - up)
    return pmf


def mechanism_variance(p: GeneralRQMParams, xs=None) -> float:
    """Mean squared error of the unbiased single-device estimator B(z) over
    a grid of inputs (the accuracy side of the trade-off)."""
    if xs is None:
        xs = np.linspace(-p.c, p.c, 9)
    B = p.levels()
    return float(np.mean([
        (outcome_distribution(float(x), p) * (B - x) ** 2).sum() for x in xs
    ]))


def aggregate_epsilon(p: GeneralRQMParams, n: int, alpha: float,
                      seed: int = 0) -> float:
    x, xp = worst_case_inputs(p.c, n, seed)
    pm = aggregate_distribution([outcome_distribution(float(v), p) for v in x])
    qm = aggregate_distribution([outcome_distribution(float(v), p) for v in xp])
    return renyi_divergence(pm, qm, alpha)


def optimize_q(base: RQMParams, n: int, alpha: float, *,
               iters: int = 60, seed: int = 0, var_slack: float = 1.02):
    """Coordinate random search over per-level q minimizing the worst-case
    aggregate eps(alpha) subject to variance <= var_slack * scalar-q
    variance. Returns (GeneralRQMParams, history)."""
    rng = np.random.default_rng(seed)
    cur = GeneralRQMParams.from_scalar(base)
    var_budget = var_slack * mechanism_variance(cur)
    best_eps = aggregate_epsilon(cur, n, alpha, seed)
    history = [(best_eps, mechanism_variance(cur))]
    q = np.asarray(cur.q, dtype=np.float64)
    for t in range(iters):
        i = rng.integers(0, len(q))
        prop = q.copy()
        prop[i] = float(np.clip(prop[i] + rng.normal(0, 0.08), 0.02, 0.98))
        cand = GeneralRQMParams(base.c, base.delta, base.m, tuple(prop))
        if mechanism_variance(cand) > var_budget:
            continue
        eps = aggregate_epsilon(cand, n, alpha, seed)
        if eps < best_eps:
            best_eps, q = eps, prop
            history.append((best_eps, mechanism_variance(cand)))
    return GeneralRQMParams(base.c, base.delta, base.m, tuple(q)), history


def select_levels(x: torch.Tensor, u_levels: torch.Tensor, u_round: torch.Tensor,
                  p: GeneralRQMParams) -> torch.Tensor:
    """int32 levels of ``x`` given its uniforms: ``u_levels`` (x.shape +
    (m,)) decide which levels are kept (level i when ``u < q_i``; the
    endpoints always), ``u_round`` (x.shape) the rounding within the kept
    bracket. In float32, op by op as the reference computes it (no FMA):
    the clip, the bracket ``j``, the nearest kept levels ``i_lo <= j <
    i_hi``, their values ``-x_max + i * step`` and ``p_up``."""
    m = p.m
    dev = x.device
    step = 2.0 * p.x_max / (m - 1)
    # divide by a device tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not IEEE division
    step_t = torch.tensor(step, dtype=torch.float32, device=dev)
    xc = torch.clamp(x.to(torch.float32), -p.c, p.c)
    j = torch.clamp(torch.floor((xc + p.x_max) / step_t), 0, m - 2).to(torch.int32)
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    qv = torch.cat([torch.ones(1, dtype=torch.float32),
                    torch.tensor(p.q, dtype=torch.float32),
                    torch.ones(1, dtype=torch.float32)]).to(dev)
    keep = u_levels < qv  # endpoints always kept (u < 1)
    j_b = j[..., None]
    i_lo = torch.where(keep & (idx <= j_b), idx, -1).amax(-1)
    i_hi = torch.where(keep & (idx > j_b), idx, m).amin(-1)
    b_lo = -p.x_max + i_lo.to(torch.float32) * step_t
    b_hi = -p.x_max + i_hi.to(torch.float32) * step_t
    p_up = (xc - b_lo) / (b_hi - b_lo)
    return torch.where(u_round < p_up, i_hi, i_lo).to(torch.int32)


def quantize(x: torch.Tensor, p: GeneralRQMParams, generator: torch.Generator) -> torch.Tensor:
    """Vectorized sampling of the generalized mechanism: the keep uniforms
    (x.shape + (m,)), then the rounding uniforms (x.shape), drawn from
    ``generator`` on ``x``'s device, through ``select_levels``."""
    u_levels = torch.rand(x.shape + (p.m,), generator=generator, dtype=torch.float32,
                          device=x.device)
    u_round = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return select_levels(x, u_levels, u_round, p)

"""Renyi-DP accounting (counterpart of ``repro/core/renyi.py``).

Numerically exact on the discrete outcome pmfs (float64, log space), as
in the paper's Section 6.1. Every aggregate epsilon goes through the
privacy cache (``privacy/cache.py``: an in-process memo and an optional
disk layer shared across processes), keyed as the reference keys it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.distribution import (
    aggregate_distribution,
    pbm_outcome_distribution,
    qmgeo_outcome_distribution,
    rqm_outcome_distribution,
)
from repro_torch.core.grid import RQMParams
from repro_torch.core.pbm import PBMParams
from repro_torch.core.qmgeo import QMGeoParams
from repro_torch.privacy.cache import cached_epsilon

_EPS = 1e-300


def renyi_divergence(p: np.ndarray, q: np.ndarray, alpha: float) -> float:
    """D_alpha(P || Q) for discrete pmfs on a shared support (alpha = 1 is
    KL, alpha = inf the max log-ratio)."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    if p.shape != q.shape:
        raise ValueError(f"support mismatch {p.shape} vs {q.shape}")
    if np.any((q <= 0) & (p > 0)):
        return math.inf
    mask = p > 0
    logp = np.log(np.where(mask, p, 1.0))
    logq = np.log(np.clip(q, _EPS, None))
    if math.isinf(alpha):
        return float(np.max(np.where(mask, logp - logq, -np.inf)))
    if abs(alpha - 1.0) < 1e-12:
        return float(np.sum(np.where(mask, p * (logp - logq), 0.0)))
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    terms = np.where(mask, alpha * logp + (1.0 - alpha) * logq, -np.inf)
    mx = np.max(terms)
    lse = mx + np.log(np.sum(np.exp(terms - mx)))
    return float(lse / (alpha - 1.0))


def worst_case_inputs(c: float, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The paper's worst-case neighbouring inputs (Sec 6.1): x_1 = c,
    x'_1 = -c, and x_2..x_n i.i.d. uniform over {-c, +c}, shared."""
    rng = np.random.default_rng(seed)
    rest = rng.choice([-c, c], size=n - 1) if n > 1 else np.zeros(0)
    return np.concatenate([[c], rest]), np.concatenate([[-c], rest])


def rqm_pairwise_divergence(x: float, x_prime: float, params: RQMParams, alpha: float) -> float:
    """D_alpha(P_{Q(x)} || P_{Q(x')}): single-device (local) Renyi DP."""
    return renyi_divergence(rqm_outcome_distribution(x, params),
                            rqm_outcome_distribution(x_prime, params), alpha)


def aggregate_renyi_divergence(per_device_pmf: Callable[[float], np.ndarray],
                               xs: Sequence[float], xs_prime: Sequence[float],
                               alpha: float) -> float:
    """eps(alpha) = D_alpha(P_{sum Q(x_i)} || P_{sum Q(x'_i)}) for the
    aggregate-level adversary that sees only the SecAgg output (Sec 6.1)."""
    p = aggregate_distribution([per_device_pmf(float(x)) for x in xs])
    q = aggregate_distribution([per_device_pmf(float(x)) for x in xs_prime])
    return renyi_divergence(p, q, alpha)


def _aggregate_epsilon(family: str, params, pmf, n: int, alpha: float, seed: int) -> float:
    """The worst-case aggregate epsilon of n devices whose per-device pmf
    is ``pmf``, through the privacy cache."""

    def compute():
        x, xp = worst_case_inputs(params.c, n, seed)
        return aggregate_renyi_divergence(pmf, x, xp, alpha)

    return cached_epsilon(family, params, n, alpha, seed, compute)


def rqm_aggregate_epsilon(params: RQMParams, n: int, alpha: float, seed: int = 0) -> float:
    """Worst-case aggregate Renyi-DP epsilon of RQM with n devices
    (cached)."""
    return _aggregate_epsilon("rqm", params, lambda v: rqm_outcome_distribution(v, params),
                              n, alpha, seed)


def pbm_aggregate_epsilon(params: PBMParams, n: int, alpha: float, seed: int = 0) -> float:
    """Worst-case aggregate Renyi-DP epsilon of PBM with n devices
    (cached)."""
    return _aggregate_epsilon(
        "pbm", params, lambda v: pbm_outcome_distribution(v, params.c, params.m, params.theta),
        n, alpha, seed)


def qmgeo_aggregate_epsilon(params: QMGeoParams, n: int, alpha: float, seed: int = 0) -> float:
    """Worst-case aggregate Renyi-DP epsilon of the truncated-geometric
    quantizer with n devices (cached)."""
    return _aggregate_epsilon("qmgeo", params, lambda v: qmgeo_outcome_distribution(v, params),
                              n, alpha, seed)


def rdp_to_dp(total_eps, alphas, delta: float) -> tuple[float, float]:
    """Best (eps, alpha) conversion of a composed RDP vector to
    (eps, delta)-DP: eps_RDP + log(1/delta)/(alpha - 1) (Mironov 2017,
    Prop. 3), minimized over the tracked alphas."""
    best_eps, best_alpha = math.inf, None
    for a, e in zip(alphas, total_eps):
        if a <= 1.0:
            continue
        eps = e + math.log(1.0 / delta) / (a - 1.0)
        if eps < best_eps:
            best_eps, best_alpha = eps, a
    return best_eps, best_alpha


@dataclasses.dataclass
class RenyiAccountant:
    """Cumulative Renyi-DP over composed rounds: each ``step`` adds one
    round's per-alpha eps vector, recorded in ``history`` (a checkpoint
    replays it). ``dp_epsilon`` converts after composition, through the
    same ``projected_dp_epsilon`` as the budget halt's lookahead."""

    alphas: tuple[float, ...] = (1.5, 2.0, 3.0, 4.0, 8.0, 16.0, 32.0, 64.0)

    def __post_init__(self):
        self._eps = np.zeros(len(self.alphas), dtype=np.float64)
        self.rounds = 0
        self.history: list[np.ndarray] = []

    def step(self, per_round_eps: Sequence[float]) -> None:
        per_round_eps = np.asarray(per_round_eps, dtype=np.float64)
        if per_round_eps.shape != self._eps.shape:
            raise ValueError("per_round_eps must align with self.alphas")
        self._eps += per_round_eps
        self.rounds += 1
        self.history.append(per_round_eps.copy())

    def rdp_epsilon(self, alpha: float) -> float:
        return float(self._eps[self.alphas.index(alpha)])

    def dp_epsilon(self, delta: float) -> tuple[float, float]:
        """Best (eps, alpha) conversion to (eps, delta)-DP."""
        return self.projected_dp_epsilon(delta)

    def projected_dp_epsilon(self, delta: float, extra_eps: Sequence[float] = None,
                             rounds: int = 0) -> tuple[float, float]:
        """(eps, alpha)-DP after the spent budget and ``rounds`` more rounds
        of the per-round vector ``extra_eps``; ``rounds=0`` is the spent
        budget itself."""
        total = self._eps
        if rounds:
            total = total + rounds * np.asarray(extra_eps, dtype=np.float64)
        return rdp_to_dp(total, self.alphas, delta)

    def total_rdp(self) -> np.ndarray:
        """A copy of the composed per-alpha RDP vector (the telemetry
        emitter re-anchors to it after a restore)."""
        return self._eps.copy()

    def rounds_within_budget(self, budget_eps: float, delta: float,
                             per_round_eps: Sequence[float]) -> float:
        """The largest k such that k more rounds of ``per_round_eps`` keep
        ``dp_epsilon(delta) <= budget_eps``: ``math.inf`` when the vector
        is non-private at some feasible alpha, 0 when one round exceeds.
        The composed eps is linear in k and the DP eps the min over
        alphas, so k is the max over alphas of floor(room_a / v_a)."""
        v = np.asarray(per_round_eps, dtype=np.float64)
        best = 0
        for a, spent, va in zip(self.alphas, self._eps, v):
            if a <= 1.0:
                continue
            room = budget_eps - spent - math.log(1.0 / delta) / (a - 1.0)
            if room < 0:
                continue
            if va <= 0:
                return math.inf
            # float jitter at the boundary (room / va == k - 1e-16)
            best = max(best, int(math.floor(room / va + 1e-12)))
        return best

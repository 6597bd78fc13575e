"""Exact outcome distributions of the three mechanisms (counterpart of
``repro/core/distribution.py``).

``rqm_outcome_distribution`` is Lemma 5.1 (Eq. 2) of the paper: the
closed-form pmf over the m levels for a scalar input x;
``pbm_outcome_distribution`` and ``qmgeo_outcome_distribution`` are the
baselines' pmfs. ``aggregate_distribution`` convolves per-device pmfs
into the pmf of the SecAgg sum. Host-side float64 numpy.
"""
from __future__ import annotations

from math import lgamma
from typing import Sequence

import numpy as np

from repro_torch.core.grid import RQMParams
from repro_torch.core.qmgeo import QMGeoParams


def rqm_outcome_distribution(x: float, params: RQMParams) -> np.ndarray:
    """Pr(Q(x) = i) for i = 0..m-1, per Lemma 5.1 (Eq. 2), where j is the
    integer with x in [B(j), B(j+1)):

    Case (I)  0 < i <= j:      q (1-q)^{j-i}   * DOWN(i)
    Case (II) i = 0:           (1-q)^{j}       * DOWN(0)
    Case (III) j+1 <= i < m-1: q (1-q)^{i-j-1} * UP(i)
    Case (IV) i = m-1:         (1-q)^{m-j-2}   * UP(m-1)

      DOWN(i) = (1-q)^{m-j-2} (B(m-1)-x)/(B(m-1)-B(i))
                + sum_{k=j+1}^{m-2} q (1-q)^{k-j-1} (B(k)-x)/(B(k)-B(i))
      UP(i)   = (1-q)^{j} (x-B(0))/(B(i)-B(0))
                + sum_{k=1}^{j}   q (1-q)^{j-k}   (x-B(k))/(B(i)-B(k))
    """
    m, q = params.m, params.q
    B = params.levels()
    if not (-params.c - 1e-12 <= x <= params.c + 1e-12):
        raise ValueError(f"x={x} outside [-c, c] with c={params.c}")
    x = float(np.clip(x, -params.c, params.c))
    j = int(np.clip(np.floor((x - B[0]) / params.step), 0, m - 2))

    def down(i: int) -> float:
        acc = (1.0 - q) ** (m - j - 2) * (B[m - 1] - x) / (B[m - 1] - B[i])
        for k in range(j + 1, m - 1):
            acc += q * (1.0 - q) ** (k - j - 1) * (B[k] - x) / (B[k] - B[i])
        return acc

    def up(i: int) -> float:
        acc = (1.0 - q) ** j * (x - B[0]) / (B[i] - B[0])
        for k in range(1, j + 1):
            acc += q * (1.0 - q) ** (j - k) * (x - B[k]) / (B[i] - B[k])
        return acc

    p = np.zeros(m, dtype=np.float64)
    for i in range(0, j + 1):
        pref = (1.0 - q) ** j if i == 0 else q * (1.0 - q) ** (j - i)
        p[i] = pref * down(i)
    for i in range(j + 1, m):
        pref = ((1.0 - q) ** (m - j - 2) if i == m - 1
                else q * (1.0 - q) ** (i - j - 1))
        p[i] = pref * up(i)
    return p


def qmgeo_outcome_distribution(x: float, params: QMGeoParams) -> np.ndarray:
    """Pr(Q(x) = k), k = 0..m-1, of the truncated-geometric quantizer: x
    rounds to j in {lo, lo+1} (up with probability (x - B(lo)) / step),
    then k | j has probability r^|k-j| / sum_k' r^|k'-j|. Every outcome
    has mass >= r^(m-1) / Z > 0, so every Renyi order is finite."""
    m, r = params.m, params.r
    B = params.levels()
    if not (-params.c - 1e-12 <= x <= params.c + 1e-12):
        raise ValueError(f"x={x} outside [-c, c] with c={params.c}")
    x = float(np.clip(x, -params.c, params.c))
    lo = int(np.clip(np.floor((x - B[0]) / params.step), 0, m - 2))
    p_up = (x - B[lo]) / params.step
    k = np.arange(m, dtype=np.float64)
    out = np.zeros(m, dtype=np.float64)
    for j, pj in ((lo, 1.0 - p_up), (lo + 1, p_up)):
        g = r ** np.abs(k - j)
        out += pj * g / g.sum()
    return out


def _log_binom_coeff(n: int, k: np.ndarray) -> np.ndarray:
    lg = np.vectorize(lgamma)
    return lg(n + 1.0) - lg(k + 1.0) - lg(n - k + 1.0)


def binomial_pmf(n: int, p: float) -> np.ndarray:
    """pmf of Binomial(n, p) over the support 0..n (log space, float64)."""
    k = np.arange(n + 1, dtype=np.float64)
    if p <= 0.0:
        out = np.zeros(n + 1)
        out[0] = 1.0
        return out
    if p >= 1.0:
        out = np.zeros(n + 1)
        out[-1] = 1.0
        return out
    logpmf = _log_binom_coeff(n, k) + k * np.log(p) + (n - k) * np.log1p(-p)
    return np.exp(logpmf)


def pbm_outcome_distribution(x: float, c: float, m: int, theta: float) -> np.ndarray:
    """PBM (Chen et al. 2022): z ~ Binomial(m, p(x)), p(x) = 1/2 + theta x / c,
    over the support 0..m."""
    p = 0.5 + theta * float(np.clip(x, -c, c)) / c
    return binomial_pmf(m, p)


def aggregate_distribution(pmfs: Sequence[np.ndarray]) -> np.ndarray:
    """pmf of the sum of independent discrete variables (SecAgg output)."""
    out = np.asarray(pmfs[0], dtype=np.float64)
    for pmf in pmfs[1:]:
        out = np.convolve(out, np.asarray(pmf, dtype=np.float64))
    return out

"""Exact outcome distributions of RQM (RQM half of ``repro/core/distribution.py``).

``rqm_outcome_distribution`` is Lemma 5.1 (Eq. 2) of the paper: the
closed-form pmf over the m levels for a scalar input x.
``aggregate_distribution`` convolves per-device pmfs into the pmf of the
SecAgg sum. Host-side float64 numpy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.grid import RQMParams


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


def aggregate_distribution(pmfs: Sequence[np.ndarray]) -> np.ndarray:
    """pmf of the sum of independent discrete variables (SecAgg output)."""
    out = np.asarray(pmfs[0], dtype=np.float64)
    for pmf in pmfs[1:]:
        out = np.convolve(out, np.asarray(pmf, dtype=np.float64))
    return out

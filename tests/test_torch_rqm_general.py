"""The generalized per-level RQM (``repro_torch/core/rqm_general.py``)
against the reference's ``repro/core/rqm_general.py``, on the CPU:

  * ``outcome_distribution`` within 1e-12 of the reference's, at a
    uniform q (and against Lemma 5.1's scalar pmf) and at random q
    vectors; ``mechanism_variance`` and ``aggregate_epsilon`` within 1e-9
    relative;
  * ``optimize_q`` at a few iterations: the same accepted q tuple bit for
    bit, and its eps history within 1e-9;
  * ``select_levels`` on the uniforms the reference's ``quantize`` draws
    (``jax.random.split`` of its key, the level uniforms first) equal to
    the reference's ``quantize(x, key, p)`` bit for bit;
  * the port's ``quantize`` (uniforms from a ``torch.Generator``) against
    ``outcome_distribution``, by a chi-square test at a fixed seed.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import rqm_general as jrg
from repro.core.grid import RQMParams as JRQMParams
from repro_torch.core import rqm_general as rg
from repro_torch.core.distribution import rqm_outcome_distribution
from repro_torch.core.grid import RQMParams

PMF_ATOL = 1e-12
EPS_RTOL = 1e-9
BASE = dict(c=1.5, delta=1.5, m=16, q=0.42)
# the chi-square test's p-value must exceed this at the fixed seed
CHI2_P_MIN = 1e-3


def _q(seed: int, m: int = 16) -> tuple:
    return tuple(np.random.default_rng(seed).uniform(0.1, 0.9, size=m - 2))


def _pair(c, delta, m, q):
    return rg.GeneralRQMParams(c, delta, m, q), jrg.GeneralRQMParams(c, delta, m, q)


@pytest.mark.parametrize("x", [-1.5, -0.4, 0.0, 0.3, 1.5, 2.0])
def test_pmf_uniform_q(x):
    g = rg.GeneralRQMParams.from_scalar(RQMParams(**BASE))
    jg = jrg.GeneralRQMParams.from_scalar(JRQMParams(**BASE))
    got = rg.outcome_distribution(x, g)
    np.testing.assert_allclose(got, jrg.outcome_distribution(x, jg), atol=PMF_ATOL, rtol=0)
    x_in = float(np.clip(x, -BASE["c"], BASE["c"]))  # Lemma 5.1 takes x in [-c, c]
    np.testing.assert_allclose(got, rqm_outcome_distribution(x_in, RQMParams(**BASE)),
                               atol=PMF_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pmf_variance_eps_random_q(seed):
    g, jg = _pair(1.0, 0.8, 16, _q(seed))
    for x in np.linspace(-1.2, 1.2, 9):
        np.testing.assert_allclose(rg.outcome_distribution(float(x), g),
                                   jrg.outcome_distribution(float(x), jg), atol=PMF_ATOL, rtol=0)
    np.testing.assert_allclose(rg.mechanism_variance(g), jrg.mechanism_variance(jg),
                               rtol=EPS_RTOL)
    for n, alpha in ((3, 2.0), (5, 8.0)):
        np.testing.assert_allclose(rg.aggregate_epsilon(g, n, alpha, seed),
                                   jrg.aggregate_epsilon(jg, n, alpha, seed), rtol=EPS_RTOL)


def test_optimize_q():
    base, jbase = RQMParams(c=0.5, delta=0.5, m=8, q=0.42), JRQMParams(c=0.5, delta=0.5, m=8,
                                                                       q=0.42)
    got, hist = rg.optimize_q(base, 4, 4.0, iters=12, seed=3)
    want, jhist = jrg.optimize_q(jbase, 4, 4.0, iters=12, seed=3)
    assert got.q == want.q
    assert len(hist) == len(jhist) > 1
    np.testing.assert_allclose(np.asarray(hist), np.asarray(jhist), rtol=EPS_RTOL)


@pytest.mark.parametrize("key", [0, 1, 5])
@pytest.mark.parametrize("q_seed", [None, 4])
def test_select_levels_on_the_reference_uniforms(key, q_seed):
    m = 16
    q = _q(q_seed, m) if q_seed is not None else tuple(np.linspace(0.25, 0.65, m - 2))
    g, jg = _pair(1.5, 1.5, m, q)
    x = np.random.default_rng(key).uniform(-2.0, 2.0, (4000,)).astype(np.float32)
    x[:6] = [-1.5, 1.5, 0.0, -3.0, 3.0, 1e-8]  # the clip's ends and a bin edge
    jkey = jax.random.key(key)
    want = np.asarray(jrg.quantize(jnp.asarray(x), jkey, jg))
    k_lvl, k_rnd = jax.random.split(jkey)
    u_levels = np.asarray(jax.random.uniform(k_lvl, x.shape + (m,), jnp.float32))
    u_round = np.asarray(jax.random.uniform(k_rnd, x.shape, jnp.float32))
    got = rg.select_levels(torch.tensor(x), torch.tensor(u_levels), torch.tensor(u_round), g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("x", [-0.8, 0.1, 1.4])
def test_quantize_statistics(x):
    q = tuple(np.linspace(0.25, 0.65, 14))
    g = rg.GeneralRQMParams(1.5, 1.5, 16, q)
    n = 200_000
    z = rg.quantize(torch.full((n,), x), g, torch.Generator().manual_seed(11))
    counts = np.bincount(z.numpy(), minlength=16)
    pmf = rg.outcome_distribution(x, g)
    live = pmf > 0
    assert counts[~live].sum() == 0
    _, pval = stats.chisquare(counts[live], pmf[live] / pmf[live].sum() * n)
    assert pval > CHI2_P_MIN, (counts, pmf * n)

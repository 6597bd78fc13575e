"""The port's privacy service (``repro_torch.privacy``: the epsilon cache
and the inverse accountant) against the reference's
(``repro.privacy``), mirroring ``tests/test_privacy_calibrate.py`` case
by case:

  * ``calibrate`` lands each family within ``tol`` below its target, and
    its knob value, iteration count, alpha and epsilon equal the
    reference's (epsilons to 1e-9, the accountants' contract);
  * the reported epsilon is the accountant's; the knob rebuilds the
    mechanism; the two ``CalibrationError`` ranges; the argument checks;
    the knob registry;
  * a repeated calibration computes 0 epsilons; the accounting and the
    calibration share entries;
  * the disk layer round-trips at full precision, a version bump ignores
    stale entries, ``REPRO_PRIVACY_CACHE`` configures the global cache,
    keys keep full float precision and equal the reference's keys;
  * the paper-cohort calibration (n = 40), under the reference's ``slow``
    marker.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import importlib
import math

import numpy as np
import pytest

from repro.privacy import cache as jcache
from repro_torch.core.grid import RQMParams
from repro_torch.core.mechanisms import Mechanism, make_mechanism
from repro_torch.core.renyi import RenyiAccountant
from repro_torch.privacy import cache as cache_lib
from repro_torch.privacy.calibrate import (
    DEFAULT_ALPHAS,
    CalibrationError,
    calibrate,
    calibration_knobs,
    composed_dp_epsilon,
)

jcalibrate = importlib.import_module("repro.privacy.calibrate")

TARGET = dict(target_eps=30.0, target_delta=1e-5, rounds=50, cohort=8)
FAMILIES = ("rqm", "pbm", "qmgeo")


@pytest.fixture
def fresh_cache():
    """An empty memory-only port cache as the global one for the test."""
    old = cache_lib.global_cache()
    fresh = cache_lib.configure(None)
    try:
        yield fresh
    finally:
        cache_lib._CACHE = old


@pytest.mark.parametrize("family", FAMILIES)
def test_hits_target_within_tolerance_with_the_references_knob(family, fresh_cache):
    res = calibrate(family, c=0.02, **TARGET)
    assert isinstance(res.mechanism, Mechanism) and res.mechanism.name == family
    assert 0.99 * TARGET["target_eps"] <= res.epsilon <= TARGET["target_eps"]
    want = jcalibrate.calibrate(family, c=0.02, **TARGET)
    assert (res.knob, res.value, res.iterations, res.alpha) == \
        (want.knob, want.value, want.iterations, want.alpha)
    assert abs(res.epsilon - want.epsilon) <= 1e-9
    assert res.mechanism.describe() == want.mechanism.describe()
    assert res.describe().split(" -> ")[1] == want.describe().split(" -> ")[1]


@pytest.mark.parametrize("family", FAMILIES)
def test_composed_epsilon_is_the_accountants(family, fresh_cache):
    res = calibrate(family, c=0.02, **TARGET)
    acc = RenyiAccountant(alphas=tuple(DEFAULT_ALPHAS))
    for _ in range(TARGET["rounds"]):
        acc.step([res.mechanism.per_round_epsilon(TARGET["cohort"], a) for a in DEFAULT_ALPHAS])
    eps, alpha = acc.dp_epsilon(TARGET["target_delta"])
    assert eps == pytest.approx(res.epsilon, rel=1e-12)
    assert alpha == res.alpha


def test_knob_value_builds_equal_mechanism(fresh_cache):
    res = calibrate("rqm", c=0.02, **TARGET)
    assert make_mechanism({"name": "rqm", "c": 0.02, res.knob: res.value}) == res.mechanism


def test_unreachably_low_target_raises_with_the_references_range(fresh_cache):
    kw = dict(target_eps=1e-3, target_delta=1e-5, rounds=50, cohort=8, c=0.02)
    with pytest.raises(CalibrationError) as ei:
        calibrate("rqm", **kw)
    with pytest.raises(jcalibrate.CalibrationError) as ej:
        jcalibrate.calibrate("rqm", **kw)
    lo, hi = ei.value.achievable
    assert 1e-3 < lo < hi
    np.testing.assert_allclose(ei.value.achievable, ej.value.achievable, rtol=0, atol=1e-9)
    assert str(ei.value).split("(achievable")[0] == str(ej.value).split("(achievable")[0]


def test_unreachably_high_target_raises(fresh_cache):
    kw = dict(target_eps=1e9, target_delta=1e-5, rounds=2, cohort=8, c=0.02)
    with pytest.raises(CalibrationError, match="above the achievable maximum") as ei:
        calibrate("qmgeo", **kw)
    with pytest.raises(jcalibrate.CalibrationError) as ej:
        jcalibrate.calibrate("qmgeo", **kw)
    np.testing.assert_allclose(ei.value.achievable, ej.value.achievable, rtol=0, atol=1e-9)


def test_argument_checks():
    with pytest.raises(ValueError, match="calibration knob"):
        calibrate("rqm", q=0.4, c=0.02, **TARGET)
    with pytest.raises(ValueError, match="no calibration knob"):
        calibrate("none", c=0.02, **TARGET)
    with pytest.raises(ValueError, match="target_eps"):
        calibrate("rqm", target_eps=-1.0, target_delta=1e-5, rounds=10, cohort=4, c=0.02)
    with pytest.raises(ValueError, match="rounds >= 1"):
        calibrate("rqm", target_eps=1.0, target_delta=1e-5, rounds=0, cohort=4, c=0.02)


def test_knob_registry_is_the_references():
    knobs, want = calibration_knobs(), jcalibrate.calibration_knobs()
    assert set(knobs) == set(FAMILIES) == set(want)
    for name in FAMILIES:
        k, w = knobs[name], want[name]
        assert (k.option, k.lo, k.hi, k.increasing) == (w.option, w.lo, w.hi, w.increasing)
    assert DEFAULT_ALPHAS == jcalibrate.DEFAULT_ALPHAS


@pytest.mark.parametrize("family", FAMILIES)
def test_repeat_served_from_cache_zero_convolutions(family, fresh_cache):
    res1 = calibrate(family, c=0.02, **TARGET)
    computes = fresh_cache.computes
    assert computes > 0
    res2 = calibrate(family, c=0.02, **TARGET)
    assert fresh_cache.computes == computes and fresh_cache.hits > 0
    assert res2.mechanism == res1.mechanism and res2.epsilon == res1.epsilon


def test_composed_epsilon_cached_across_callers(fresh_cache):
    res = calibrate("rqm", c=0.02, **TARGET)
    before = fresh_cache.computes
    eps, _ = composed_dp_epsilon(res.mechanism, cohort=TARGET["cohort"],
                                 rounds=TARGET["rounds"], delta=TARGET["target_delta"])
    assert fresh_cache.computes == before
    assert eps == pytest.approx(res.epsilon, rel=1e-12)


def test_disk_roundtrip_serves_without_compute(tmp_path):
    path = str(tmp_path / "eps.json")
    calls = []

    def compute():
        calls.append(1)
        return 1.234567890123456789

    c1 = cache_lib.EpsilonCache(path=path)
    key = cache_lib.epsilon_key("rqm", {"c": 0.02, "q": 0.3}, 8, 2.0)
    v1 = c1.get_or_compute(key, compute)
    c2 = cache_lib.EpsilonCache(path=path)
    v2 = c2.get_or_compute(key, compute)
    assert calls == [1] and v2 == v1
    assert c2.hits == 1 and c2.computes == 0 and c2.disk_hits == 1
    # the reference reads the port's file: same keys, same JSON
    assert jcache.EpsilonCache(path=path).get_or_compute(key, compute) == v1
    assert calls == [1]


def test_version_bump_invalidates_disk_entries(tmp_path, monkeypatch):
    path = str(tmp_path / "eps.json")
    c1 = cache_lib.EpsilonCache(path=path)
    key = cache_lib.epsilon_key("rqm", {"c": 0.02}, 4, 2.0)
    c1.get_or_compute(key, lambda: 7.0)
    monkeypatch.setattr(cache_lib, "ACCOUNTING_VERSION", cache_lib.ACCOUNTING_VERSION + 1)
    c2 = cache_lib.EpsilonCache(path=path)
    new_key = cache_lib.epsilon_key("rqm", {"c": 0.02}, 4, 2.0)
    assert new_key != key
    recomputed = []
    c2.get_or_compute(new_key, lambda: recomputed.append(1) or 8.0)
    assert recomputed == [1]


def test_env_var_configures_global_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "eps.json")
    monkeypatch.setenv("REPRO_PRIVACY_CACHE", path)
    old = cache_lib._CACHE
    try:
        cache_lib._CACHE = None
        assert cache_lib.global_cache().path == path
        monkeypatch.setenv("REPRO_PRIVACY_CACHE", "off")
        cache_lib._CACHE = None
        assert cache_lib.global_cache().path is None
    finally:
        cache_lib._CACHE = old


def test_keys_keep_full_precision_and_are_the_references():
    k1 = cache_lib.epsilon_key("rqm", {"c": 0.1}, 4, 2.0)
    k2 = cache_lib.epsilon_key("rqm", {"c": 0.1 + 1e-18}, 4, 2.0)
    k3 = cache_lib.epsilon_key("rqm", {"c": 0.1 + 1e-16}, 4, 2.0)
    assert k1 == k2 and k1 != k3
    from repro.core.grid import RQMParams as JaxRQMParams

    p = (0.02, 0.0133, 16, 0.42)
    assert cache_lib.epsilon_key("rqm", RQMParams(*p), 40, 8.0, 3) == \
        jcache.epsilon_key("rqm", JaxRQMParams(*p), 40, 8.0, 3)
    assert cache_lib.params_key(RQMParams(*p)) == jcache.params_key(JaxRQMParams(*p))


def test_accounting_goes_through_the_cache(fresh_cache):
    mech = make_mechanism("rqm:c=0.02,m=16,q=0.42")
    eps = mech.per_round_epsilon(8, 4.0)
    assert fresh_cache.computes == 1
    assert mech.per_round_epsilon(8, 4.0) == eps and fresh_cache.hits == 1
    assert len(fresh_cache) == 1 and fresh_cache.stats()["entries"] == 1


@pytest.mark.slow
class TestCalibrateFullScale:
    """Paper-scale calibration (n = 40 cohorts), as the reference marks it."""

    def test_paper_cohort_calibration(self, fresh_cache):
        res = calibrate("rqm", target_eps=20.0, target_delta=1e-5, rounds=200, cohort=40,
                        c=0.02)
        assert 0.99 * 20.0 <= res.epsilon <= 20.0
        want = jcalibrate.calibrate("rqm", target_eps=20.0, target_delta=1e-5, rounds=200,
                                    cohort=40, c=0.02)
        assert (res.value, res.iterations) == (want.value, want.iterations)
        assert abs(res.epsilon - want.epsilon) <= 1e-9
        # amplification by aggregation: the same budget at n = 8 is out of reach
        with pytest.raises(CalibrationError):
            calibrate("rqm", target_eps=20.0, target_delta=1e-5, rounds=200, cohort=8,
                      c=0.02)


def test_rounds_within_budget_math():
    acc = RenyiAccountant(alphas=(2.0, 8.0))
    v = np.array([0.05, 0.2])
    k = acc.rounds_within_budget(10.0, 1e-5, v)
    assert k == int((10.0 - math.log(1e5) / 7.0) / 0.2)
    for _ in range(k):
        acc.step(v)
    assert acc.dp_epsilon(1e-5)[0] <= 10.0
    acc.step(v)
    assert acc.dp_epsilon(1e-5)[0] > 10.0
    assert RenyiAccountant(alphas=(2.0,)).rounds_within_budget(5.0, 1e-2, [0.0]) == math.inf

"""The reference's default round in the port: ``FedTrainer(spec, FedConfig())``
is the materialized (``fused_rounds=False``) round of the ``scan``
engine, for the four mechanisms of the paper's Fig. 3 comparison (rqm,
pbm, qmgeo and the noise-free baseline), against the JAX reference on the
CPU at the suite's small problem (24 clients, cohorts of 6).

  * the mechanism registry: names, accepted options and spec round-trips
    equal the reference's; ``use_kernel=False`` (jax.random) is refused;
  * PBM and QMGeo accounting: tests/golden/epsilons.json to 1e-9, and
    their outcome pmfs and decodes equal the reference's;
  * one reference ``perround``, ``fused_rounds=False`` round per
    mechanism, replayed in the port with the reference's cohort, kernel
    seed and clipped gradient stack: the SecAgg sum exact (QMGeo within
    its budget, tests/test_torch_quantize.py), the parameters equal to
    the reference's literal decode + SGD and within its 1-ULP contract of
    the jitted round; the noise-free float sum within NONE_RTOL;
  * inside the port: materialized == fused (dense and packed) bit for
    bit, and ``scan`` == ``perround``, over 3 rounds.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distribution as jdist
from repro.core import mechanisms as jmechs
from repro.core import pbm as jpbm
from repro.core import qmgeo as jqmgeo
from repro.fed import cohort as jcohort
from repro.fed import rounds as jrounds
from repro.fed.config import FedConfig as JaxFedConfig
from repro.fed.trainer import FedTrainer as JaxFedTrainer
from repro.kernels import ops as jops
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.core import distribution, mechanisms, renyi
from repro_torch.privacy import cache as privacy_cache
from repro_torch.core.mechanisms import make_mechanism
from repro_torch.core.pbm import PBMParams, decode_sum as pbm_decode_sum
from repro_torch.core.qmgeo import QMGeoParams, decode_sum as qmgeo_decode_sum
from repro_torch.fed import rounds
from repro_torch.fed.config import FedConfig
from repro_torch.fed.trainer import FedTrainer
from repro_torch.kernels import ops
from test_torch_quantize import assert_levels

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SMALL = dict(num_clients=24, clients_per_round=6, lr=1.0, eval_size=64,
             samples_per_client=8)
SPECS = {"rqm": "rqm:c=0.05,m=16,q=0.42", "pbm": "pbm:c=0.05,m=16,theta=0.25",
         "qmgeo": "qmgeo:c=0.05,m=16,r=0.6", "none": "none:c=0.05"}
# the noise-free sum is a float32 sum of 6 clipped gradients: XLA and
# PyTorch add them in other orders, a few ulps of the sum apart
NONE_RTOL, NONE_ATOL = 1e-6, 1e-8


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_names_and_options_match_reference():
    assert mechanisms.mechanism_names() == jmechs.mechanism_names()
    for name in mechanisms.mechanism_names():
        assert mechanisms.accepted_options(name) == jmechs.accepted_options(name)
    with pytest.raises(ValueError, match="registered: rqm, pbm, qmgeo, none"):
        mechanisms.accepted_options("gauss")


@pytest.mark.parametrize("spec", ["rqm:c=0.05,m=8,q=0.3", "pbm:c=0.1,theta=0.2",
                                  "qmgeo:c=0.05,m=16,r=0.7", "none:c=0.02"])
def test_spec_roundtrips_match_reference(spec):
    mech, ref = make_mechanism(spec), jmechs.make_mechanism(spec)
    assert mech.spec() == ref.spec()
    assert mech.describe() == ref.describe()
    assert make_mechanism(mech.spec()) == mech
    assert make_mechanism(mech.describe()) == mech
    assert (mech.sum_bound(40), mech.clip, mech.bits) == (ref.sum_bound(40), ref.clip, ref.bits)


def test_defaults_filter_per_mechanism_and_jax_random_is_refused():
    m = make_mechanism("pbm", c=0.05, q=0.42, delta_ratio=1.0, theta=0.3, r=0.6)
    assert m.params == PBMParams(c=0.05, m=16, theta=0.3)
    assert make_mechanism("qmgeo", c=0.05).params == QMGeoParams(0.05, 0.05, 16, 0.6)
    with pytest.raises(ValueError, match="does not accept"):
        make_mechanism("none:c=0.05,m=16")
    for name in ("rqm", "pbm", "qmgeo"):
        with pytest.raises(NotImplementedError, match="jax.random"):
            make_mechanism(f"{name}:c=0.05,use_kernel=false")


# ---------------------------------------------------------------------------
# PBM and QMGeo accounting and decode
# ---------------------------------------------------------------------------


def _golden_epsilon_cases():
    with open(os.path.join(GOLDEN, "epsilons.json")) as f:
        g = json.load(f)
    for name in ("pbm", "qmgeo"):
        block = g["mechanisms"][name]
        for v in block["values"]:
            yield pytest.param(name, block["params"], v["n"], v["alpha"], v["eps"], g["seed"],
                               id=f"{name}-n{v['n']}-a{v['alpha']:g}")


@pytest.mark.parametrize("name,params,n,alpha,eps,seed", list(_golden_epsilon_cases()))
def test_golden_pbm_qmgeo_epsilons(name, params, n, alpha, eps, seed):
    privacy_cache.reset()  # computed fresh, not served from the cache
    if name == "pbm":
        got = renyi.pbm_aggregate_epsilon(PBMParams(**params), n, alpha, seed)
    else:
        got = renyi.qmgeo_aggregate_epsilon(QMGeoParams(**params), n, alpha, seed)
    assert abs(got - eps) <= 1e-9


@pytest.mark.parametrize("x", [-0.02, -0.013, 0.0, 0.0071, 0.02])
def test_outcome_distributions_match_reference(x):
    p, pj = QMGeoParams(0.02, 0.02, 16, 0.6), jqmgeo.QMGeoParams(0.02, 0.02, 16, 0.6)
    got = distribution.qmgeo_outcome_distribution(x, p)
    np.testing.assert_array_equal(got, jdist.qmgeo_outcome_distribution(x, pj))
    assert math.isclose(got.sum(), 1.0, rel_tol=1e-12) and got.min() > 0
    np.testing.assert_array_equal(distribution.pbm_outcome_distribution(x, 0.02, 16, 0.25),
                                  jdist.pbm_outcome_distribution(x, 0.02, 16, 0.25))
    for prob in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(distribution.binomial_pmf(16, prob),
                                      jdist.binomial_pmf(16, prob))


@pytest.mark.parametrize("n", [1, 6, 40])
def test_pbm_and_qmgeo_decode_match_reference(n):
    z = np.random.default_rng(n).integers(0, n * 16 + 1, 5000).astype(np.int32)
    pbm_t, pbm_j = PBMParams(0.02, 16, 0.25), jpbm.PBMParams(0.02, 16, 0.25)
    np.testing.assert_array_equal(pbm_decode_sum(torch.from_numpy(z), n, pbm_t).numpy(),
                                  np.asarray(jpbm.decode_sum(jnp.asarray(z), n, pbm_j)))
    qm_t, qm_j = QMGeoParams(0.02, 0.02, 16, 0.6), jqmgeo.QMGeoParams(0.02, 0.02, 16, 0.6)
    np.testing.assert_array_equal(qmgeo_decode_sum(torch.from_numpy(z), n, qm_t).numpy(),
                                  np.asarray(jqmgeo.decode_sum(jnp.asarray(z), n, qm_j)))
    with pytest.raises(ValueError):
        PBMParams(0.02, 16, 0.6)
    with pytest.raises(ValueError):
        QMGeoParams(0.02, 0.02, 16, 1.0)


# ---------------------------------------------------------------------------
# one reference round, replayed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(SPECS))
def reference_round(request):
    """One perround, materialized round of the reference per mechanism,
    with everything needed to replay it."""
    name = request.param
    jtr = JaxFedTrainer(jmechs.make_mechanism(SPECS[name]),
                        JaxFedConfig(engine="perround", fused_rounds=False,
                                     collect_sums=True, **SMALL))
    _, k_sample, k_enc = jax.random.split(jtr._key, 3)
    ids, _ = jcohort.sample_slate(jtr.cfg, jtr.slate, k_sample)
    grads = jax.vmap(jtr._client_grad, in_axes=(None, 0))(
        jtr.flat, jrounds.index_batch(jtr.client_data, ids))
    flat0 = np.array(jtr.flat)
    jtr.round()
    z_sum = np.array(jtr.round_sums[-1])
    # the reference's literal decode + SGD, one op at a time (no fusion)
    g_hat = jtr.mech.decode_sum(jnp.asarray(z_sum), jtr.cfg.clients_per_round)
    literal, _ = jax_sgd().update(g_hat, (), jnp.asarray(flat0), jtr.cfg.lr)
    return {"name": name, "ids": np.array(ids), "seed": int(np.asarray(jops.key_to_seed(k_enc))),
            "grads": np.array(grads), "flat0": flat0, "flat1": np.array(jtr.flat),
            "sum": z_sum, "literal": np.array(literal), "g_hat": np.array(g_hat)}


def _ulp_tol(mech, got, flat0, g_hat, lr):
    """The reference's 1-ULP contract (tests/test_fused_round_kernel.py):
    XLA:CPU may contract the decode and the update into FMAs, so lr times
    one ulp of the largest value the decode passes through (2 x_max on the
    grid, z * scale; |g_hat| for PBM) plus one ulp of the output."""
    span = np.abs(g_hat) if mech.name == "pbm" else np.float32(2.0 * mech.params.x_max)
    out = np.maximum(np.abs(got), np.abs(flat0)).astype(np.float32)
    return lr * np.spacing(span) + np.spacing(out)


def test_reference_round_replayed(reference_round, record_property):
    ref = reference_round
    name = ref["name"]
    mech = make_mechanism(SPECS[name])
    cfg = FedConfig(engine="perround", collect_sums=True, **SMALL)
    assert not cfg.fused_rounds and rounds.hot_path_pack_bits(mech, cfg, 6) is None
    handed = torch.from_numpy(ref["grads"])
    step = rounds.make_round_step(mech, cfg, 6, lambda flat, batch: handed)
    data = {"ids": torch.arange(SMALL["num_clients"])}
    new, _, z_sum = step(torch.from_numpy(ref["flat0"]), (), data, ids=ref["ids"],
                         seed=ref["seed"])
    got = new.numpy()
    if name == "none":
        np.testing.assert_allclose(z_sum.numpy(), ref["sum"], rtol=NONE_RTOL, atol=NONE_ATOL)
        np.testing.assert_allclose(got, ref["flat1"], rtol=NONE_RTOL, atol=NONE_ATOL)
        record_property("none_params_differing", int(np.count_nonzero(got != ref["flat1"])))
        return
    assert_levels(name, z_sum.numpy(), ref["sum"], record_property)
    same = z_sum.numpy() == ref["sum"]
    np.testing.assert_array_equal(got[same], ref["literal"][same])
    tol = _ulp_tol(mech, got, ref["flat0"], ref["g_hat"], SMALL["lr"])
    assert np.all(np.abs(got - ref["flat1"])[same] <= tol[same])
    record_property(f"{name}_params_differing_from_jitted_round",
                    int(np.count_nonzero(got != ref["flat1"])))


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


def _train(spec, rounds_, **overrides):
    tr = FedTrainer(spec, FedConfig(collect_sums=True, **{**SMALL, **overrides}), device="cpu")
    logs = []
    tr.train(rounds=rounds_, eval_every=2, log=logs.append)
    return tr, logs


@pytest.mark.parametrize("name", list(SPECS))
def test_materialized_equals_fused_and_scan_equals_perround(name):
    ops.reset_launches()
    scan, logs = _train(SPECS[name], 3)
    assert scan.cfg.engine == "scan" and not scan.cfg.fused_rounds  # FedConfig() defaults
    assert [line.split()[0] for line in logs] == [f"[{name}]"] * 2
    runs = {"perround": _train(SPECS[name], 3, engine="perround")[0],
            "fused": _train(SPECS[name], 3, fused_rounds=True)[0],
            "fused_dense": _train(SPECS[name], 3, fused_rounds=True, wire_packed=False)[0]}
    assert (runs["fused"].pack_bits is not None) == (name in ("rqm", "qmgeo"))
    for tr in runs.values():
        assert torch.equal(tr.flat, scan.flat)
        assert len(tr.round_sums) == 3
        for a, b in zip(tr.round_sums, scan.round_sums):
            np.testing.assert_array_equal(a, b)
        assert tr.accountant.rdp_epsilon(8.0) == scan.accountant.rdp_epsilon(8.0)
    want = 3 * scan.mech.per_round_epsilon(6, 8.0)
    assert math.isclose(scan.accountant.rdp_epsilon(8.0), want, rel_tol=1e-12)
    assert dict(ops.launches) == {}  # CPU: plain versions only


def test_run_block_needs_the_scan_engine():
    tr = FedTrainer(SPECS["pbm"], FedConfig(**SMALL), device="cpu")
    tr.run_block(2)
    assert tr.accountant.rounds == 2
    per = FedTrainer(SPECS["pbm"], dataclasses.replace(tr.cfg, engine="perround"),
                     device="cpu")
    with pytest.raises(ValueError, match="blocked engine"):
        per.run_block(1)

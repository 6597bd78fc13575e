"""The port's wire codec, grid, mechanism spec and Renyi accounting
(src/repro_torch/core) against the JAX reference and its goldens.

Integers (packed words, fields) must be equal; epsilons must match
tests/golden/epsilons.json to 1e-9, computed fresh (the port's memo is
cleared first).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distribution as jdist
from repro.core import grid as jgrid
from repro.core import renyi as jrenyi
from repro.core import wire as jwire
from repro_torch.core import distribution, grid, renyi, wire
from repro_torch.core.mechanisms import RQMMechanism, make_mechanism, parse_mechanism_spec
from repro_torch.kernels import decode_apply_kernel
from repro_torch.fed import rounds
from repro_torch.fed.config import FedConfig, validate_config
from repro_torch.optim.optimizers import sgd

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


def test_width_selectors_match_reference():
    for bound in (1, 15, 16, 90, 600, (1 << 16) - 1):
        assert wire.sum_bits(bound) == jwire.sum_bits(bound)
        assert wire.packable(bound) == jwire.packable(bound)
        assert wire.check_packable(bound) == jwire.check_packable(bound)
    for bits in range(1, 17):
        assert wire.fields_per_word(bits) == jwire.fields_per_word(bits)
        for n in (1, 31, 222_030):
            assert wire.packed_words(n, bits) == jwire.packed_words(n, bits)
    assert wire.packed_words(222_030, wire.sum_bits(40 * 15)) == 74_010
    assert not wire.packable(16, 4) and not wire.packable(0)
    for bad in (0, 17):
        with pytest.raises(ValueError):
            wire.fields_per_word(bad)
    with pytest.raises(ValueError, match="wire_packed=False"):
        wire.check_packable(1 << 16)


@pytest.mark.parametrize("bits", list(range(1, 17)))
def test_pack_roundtrip_matches_reference(bits):
    n = 1 + 37 * bits
    z = np.random.default_rng(bits).integers(0, 1 << bits, n).astype(np.int32)
    want = jwire.pack_bits_np(z, bits)
    np.testing.assert_array_equal(np.asarray(jwire.pack_bits(jnp.asarray(z), bits)), want)
    got = wire.pack_bits(torch.from_numpy(z), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(wire.pack_bits_np(z, bits), want)
    np.testing.assert_array_equal(wire.unpack_bits(got, bits, n).numpy(), z)
    np.testing.assert_array_equal(wire.unpack_bits_np(want, bits, n), z)


@pytest.fixture(scope="module")
def packed_golden():
    with open(os.path.join(GOLDEN, "packed_words.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("i", range(5))
def test_golden_codec_vectors(packed_golden, i):
    case = packed_golden["codec"][i]
    bits, levels = case["bits"], np.asarray(case["levels"], np.int32)
    words = np.asarray(case["words"], np.int32)
    np.testing.assert_array_equal(wire.pack_bits(torch.from_numpy(levels), bits).numpy(), words)
    np.testing.assert_array_equal(wire.pack_bits_np(levels, bits), words)
    np.testing.assert_array_equal(
        wire.unpack_bits(torch.from_numpy(words), bits, len(levels)).numpy(), levels)


def test_golden_packed_round_sum_of_dense_golden(packed_golden):
    with open(os.path.join(GOLDEN, "encoded_sums.json")) as f:
        dense = np.asarray(json.load(f)["mechanisms"]["rqm"]["sum"], np.int32)
    block = packed_golden["round_sums"]["rqm"]
    np.testing.assert_array_equal(
        wire.pack_bits(torch.from_numpy(dense), block["bits"]).numpy(),
        np.asarray(block["words"], np.int32))


# ---------------------------------------------------------------------------
# grid, mechanism, optimizer
# ---------------------------------------------------------------------------


def test_rqm_params_validation_matches_reference():
    for bad in (dict(c=0.0), dict(delta=0.0), dict(m=1), dict(q=1.0), dict(q=0.0)):
        kw = {**dict(c=0.02, delta=0.02, m=16, q=0.42), **bad}
        with pytest.raises(ValueError):
            grid.RQMParams(**kw)
        with pytest.raises(ValueError):
            jgrid.RQMParams(**kw)
    p, pj = grid.RQMParams(0.02, 0.03, 16, 0.42), jgrid.RQMParams(0.02, 0.03, 16, 0.42)
    assert (p.x_max, p.step) == (pj.x_max, pj.step)
    np.testing.assert_array_equal(p.levels(), pj.levels())


@pytest.mark.parametrize("n", [1, 6, 40])
def test_decode_sum_matches_reference(n):
    p, pj = grid.RQMParams(0.02, 0.02, 16, 0.42), jgrid.RQMParams(0.02, 0.02, 16, 0.42)
    z = np.random.default_rng(n).integers(0, n * 15 + 1, 5000).astype(np.int32)
    np.testing.assert_array_equal(grid.decode_sum(torch.from_numpy(z), n, p).numpy(),
                                  np.asarray(jgrid.decode_sum(jnp.asarray(z), n, pj)))


def test_sgd_after_decode_is_the_fused_decode_apply():
    """The identity the fused server step rests on: sgd(decode_sum(z))
    equals decode_apply_sum bit for bit."""
    p = grid.RQMParams(0.02, 0.02, 16, 0.42)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(0, 0.05, 4000).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, 601, 4000).astype(np.int32))
    new, state = sgd().update(grid.decode_sum(z, 40, p), (), w, 0.5)
    assert state == ()
    assert torch.equal(new, decode_apply_kernel.decode_apply_sum(w, z, p, 40, 0.5))
    for name in ("momentum", "adam"):  # ported: they take the decode + optimizer path
        validate_config(FedConfig(server_opt=name))
        assert not rounds.use_fused_apply(make_mechanism("rqm", c=0.02),
                                          FedConfig(server_opt=name, fused_rounds=True))


def test_mechanism_spec():
    mech = make_mechanism("rqm:c=0.02,m=16,q=0.42")
    assert mech == RQMMechanism(grid.RQMParams(c=0.02, delta=0.02, m=16, q=0.42))
    assert mech.sum_bound(40) == 600 and mech.clip == 0.02
    assert make_mechanism({"name": "rqm", "c": 0.05}, q=0.3).params.q == 0.3
    assert make_mechanism("rqm", c=0.1, theta=0.2).params.c == 0.1  # unknown default ignored
    assert parse_mechanism_spec("rqm:c=1,flag=true") == ("rqm", {"c": 1, "flag": True})
    with pytest.raises(ValueError):
        make_mechanism("rqm:c=0.02,theta=0.1")
    with pytest.raises(ValueError):
        make_mechanism("rqm:c")
    for name in ("pbm", "qmgeo", "none"):
        built = make_mechanism(f"{name}:c=0.02")
        assert built.name == name and built.clip == 0.02


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def _rqm_golden_cases():
    with open(os.path.join(GOLDEN, "epsilons.json")) as f:
        g = json.load(f)
    block = g["mechanisms"]["rqm"]
    for v in block["values"]:
        yield pytest.param(block["params"], v["n"], v["alpha"], v["eps"], g["seed"],
                           id=f"n{v['n']}-a{v['alpha']:g}")


@pytest.mark.parametrize("params,n,alpha,eps,seed", list(_rqm_golden_cases()))
def test_golden_rqm_epsilons(params, n, alpha, eps, seed):
    renyi._aggregate_epsilon.cache_clear()
    got = renyi.rqm_aggregate_epsilon(grid.RQMParams(**params), n, alpha, seed)
    assert abs(got - eps) <= 1e-9


@pytest.mark.parametrize("x", [-0.02, -0.013, 0.0, 0.0071, 0.02])
def test_outcome_distribution_matches_reference(x):
    p, pj = grid.RQMParams(0.02, 0.02, 16, 0.42), jgrid.RQMParams(0.02, 0.02, 16, 0.42)
    got = distribution.rqm_outcome_distribution(x, p)
    np.testing.assert_array_equal(got, jdist.rqm_outcome_distribution(x, pj))
    assert math.isclose(got.sum(), 1.0, rel_tol=1e-12)


def test_accountant_matches_reference():
    alphas = (2.0, 4.0, 8.0, 16.0, 32.0)
    mech = make_mechanism("rqm:c=0.02")
    vec = [mech.per_round_epsilon(40, a) for a in alphas]
    acc, acc_j = renyi.RenyiAccountant(alphas), jrenyi.RenyiAccountant(alphas)
    for _ in range(5):
        acc.step(vec)
        acc_j.step(vec)
    assert acc.rounds == 5
    assert acc.rdp_epsilon(8.0) == acc_j.rdp_epsilon(8.0)
    assert acc.dp_epsilon(1e-5) == acc_j.dp_epsilon(1e-5)
    assert renyi.rdp_to_dp([1.0, 2.0], (1.0, 3.0), 1e-5) == jrenyi.rdp_to_dp(
        [1.0, 2.0], (1.0, 3.0), 1e-5)
    p, q = np.array([0.5, 0.5, 0.0]), np.array([0.25, 0.25, 0.5])
    for a in (1.0, 2.0, math.inf):
        assert renyi.renyi_divergence(p, q, a) == jrenyi.renyi_divergence(p, q, a)
    with pytest.raises(ValueError):
        acc.step([1.0])
